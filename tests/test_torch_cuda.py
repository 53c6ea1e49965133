"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the root conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card the ``cuda``-marked cases skip; the cases that check that a
wrapper raises, rather than falling back, for a tensor that is on neither
the CPU nor a CUDA device run everywhere.  Bars: rings and scale rings bit
for bit; attention outputs within atol = rtol = 2e-2, as
tests/test_decode_attn.py holds the Pallas kernel.
"""

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops import attention as A
from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.ops import ring_kernels as RK

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(dev, b, h, c, dh, valid_frac, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001 for _ in range(2))
    valid = torch.rand(b, c, generator=g, device=dev) < valid_frac
    return q, k_new, v_new, kc, vc, ks, vs, valid


# ---------------------------------------------------------------------------
# No fallback: a tensor that is not on the CPU goes to the kernel or raises
# ---------------------------------------------------------------------------


def _launches():
    return (RK.ring_commit.launches, RK.scale_commit.launches,
            DA.decode_attend_commit.launches)


def test_wrappers_raise_for_non_cuda_devices():
    m = torch.device("meta")
    before = _launches()
    with pytest.raises(ValueError):
        RK.ring_commit(torch.empty(1, 1, 32, 8, device=m), torch.empty(1, 1, 32, 8, device=m),
                       torch.empty(1, 1, 2, 8, device=m), torch.empty(1, 1, 2, 8, device=m), 0)
    with pytest.raises(ValueError):
        RK.scale_commit(torch.empty(1, 1, 32, device=m), torch.empty(1, 1, 32, device=m),
                        torch.empty(1, 1, 1, device=m), torch.empty(1, 1, 1, device=m), 0)
    q, k_new, v_new, kc, vc, ks, vs, valid = (x.to(m) for x in _attn_inputs(
        torch.device("cpu"), 1, 8, 256, 64, 1.0, 0))
    kq, vq = kc[:, :, :1], vc[:, :, :1]
    with pytest.raises(ValueError):
        DA.decode_attend_commit(q, kc, vc, ks, vs, kq, vq, k_new, v_new,
                                A.global_ring_plan(0, 256, 1), valid, window=250)
    assert _launches() == before


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = _launches()
    z = torch.zeros(1, 2, 32, 8)
    RK.ring_commit(z, z.clone(), torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8), 30)
    assert z[:, :, 30:].eq(1).all() and z[:, :, :30].eq(0).all()
    assert _launches() == before


# ---------------------------------------------------------------------------
# On a card: kernel against plain version at the serving path's shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [0, 40, 254])
def test_ring_commit_kernel_matches_plain(cuda_device, dtype, w):
    g = torch.Generator(device=cuda_device).manual_seed(w)
    kc, vc = (torch.randn(64, 8, 256, 64, generator=g, device=cuda_device).to(dtype)
              for _ in range(2))
    kn, vn = (torch.randn(64, 8, 2, 64, generator=g, device=cuda_device).to(dtype)
              for _ in range(2))
    kp, vp = kc.clone(), vc.clone()
    before = RK.ring_commit.launches
    RK.ring_commit(kc, vc, kn, vn, w)
    RK.ring_commit_plain(kp, vp, kn, vn, w)
    torch.cuda.synchronize()
    assert RK.ring_commit.launches == before + 1
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0, 5, 767])
def test_scale_commit_kernel_matches_plain(cuda_device, w):
    g = torch.Generator(device=cuda_device).manual_seed(w)
    ks, vs = (torch.rand(64, 16, 768, generator=g, device=cuda_device) for _ in range(2))
    ksn, vsn = (torch.rand(64, 16, 1, generator=g, device=cuda_device) for _ in range(2))
    kp, vp = ks.clone(), vs.clone()
    before = RK.scale_commit.launches
    RK.scale_commit(ks, vs, ksn, vsn, w)
    RK.scale_commit_plain(kp, vp, ksn, vsn, w)
    torch.cuda.synchronize()
    assert RK.scale_commit.launches == before + 1
    assert torch.equal(ks, kp) and torch.equal(vs, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,pos,window,valid_frac", [
    (2, 8, 256, 128, 0, 250, 1.0),
    (2, 8, 256, 128, 255, 250, 1.0),
    (2, 8, 256, 128, 1000, 250, 0.6),
    (64, 16, 768, 128, 3000, 750, 0.9),  # stt-1b serving shape, B=64
    (2, 32, 384, 64, 1000, 375, 0.9),    # Dh=64 (stt-2.6b head shape)
])
def test_decode_attend_commit_kernel_matches_plain(cuda_device, B, H, C, Dh, pos,
                                                   window, valid_frac):
    q, k_new, v_new, kc, vc, ks, vs, valid = _attn_inputs(
        cuda_device, B, H, C, Dh, valid_frac, seed=pos + B)
    kq, vq, _, _ = A.quantize_kv_rows(k_new, v_new)
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    kp, vp = kc.clone(), vc.clone()
    before = DA.decode_attend_commit.launches
    y, _, _ = DA.decode_attend_commit(q, kc, vc, ks, vs, kq, vq, k_new, v_new, plan,
                                      valid, window=window)
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    yp = DA.decode_attend_commit_plain(rows[0], kp, vp, ks, vs, rows[1], rows[2],
                                       rows[3], rows[4], valid, pos, plan["w"][0], window)
    torch.cuda.synchronize()
    assert DA.decode_attend_commit.launches == before + 1
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    np.testing.assert_allclose(y[:, :, 0].float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
