"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the root conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card the ``cuda``-marked cases skip; the cases that check that a
wrapper raises, rather than falling back, for a tensor that is on neither
the CPU nor a CUDA device run everywhere.  Bars: rings and scale rings bit
for bit; attention outputs within atol = rtol = 2e-2, as
tests/test_decode_attn.py holds the Pallas kernel, on inputs whose outputs
are O(1) where the shape is the TTS path's, so that a dropped row, a
padding row read or a wrong mask fails that bar.
"""

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops import attention as A
from dsm_tpu_torch.ops import attn_tune as AT
from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.ops import qmm as QM
from dsm_tpu_torch.ops import ring_kernels as RK
from dsm_tpu_torch.ops import transformer as T

torch.set_num_threads(2)


def tick(pos, dev=None):
    """A position as the wrappers take it: the step's 0-d int32 tensor on the
    rings' device."""
    return torch.tensor(pos, dtype=torch.int32, device=dev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sharp_scales(g, dev, *shape):
    """Key scales that peak the softmax and value scales that make the
    outputs O(1), so that one row too many or too few fails the bar."""
    ks = torch.rand(*shape, generator=g, device=dev) * 0.04 + 0.08
    vs = torch.rand(*shape, generator=g, device=dev) * 0.01 + 0.005
    return ks, vs


def _attn_inputs(dev, b, h, c, dh, valid_frac, seed, sharp=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    if sharp:
        ks, vs = _sharp_scales(g, dev, b, h, c)
    else:
        ks, vs = (torch.rand(b, h, c, generator=g, device=dev) * 0.019 + 0.001
                  for _ in range(2))
    valid = torch.rand(b, c, generator=g, device=dev) < valid_frac
    return q, k_new, v_new, kc, vc, ks, vs, valid


def _within(a, p):
    a, p = a.float(), p.float()
    return bool(((a - p).abs() <= 2e-2 + 2e-2 * p.abs()).all())


def _ca_inputs(dev, b, h, s, s_len, dh, seed):
    """A voice source with O(1) outputs whose last real row matches the
    query best and whose padding rows would match it better still, with
    large values: dropping the last row or reading padding fails the bar."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
    k, v = (torch.randint(-127, 128, (b, h, s, dh), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = _sharp_scales(g, dev, b, h, s)
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 127, -127).to(torch.int8)
    per_scale = 127.0 * qf.abs().sum(-1) / dh ** 0.5  # score per unit k_scale
    k[:, :, s_len - 1] = aligned
    ks[:, :, s_len - 1] = 14.0 / per_scale
    k[:, :, s_len:] = aligned[:, :, None]
    ks[:, :, s_len:] = (26.0 / per_scale)[..., None]
    v[:, :, s_len:] = 127
    vs[:, :, s_len:] = 1.0
    return q, k, v, ks, vs


def test_ca_check_inputs_see_a_dropped_row_and_a_padding_read():
    """The bar of the card's CA cases, on their inputs, fails a result that
    dropped the last real row or read a padding row (plain version, CPU)."""
    q, k, v, ks, vs = _ca_inputs(torch.device("cpu"), 2, 8, 256, 200, 128, seed=3)
    want = DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, 200)
    assert want.float().abs().max() > 0.5
    for n in (199, 201):
        assert not _within(DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, n), want)


# ---------------------------------------------------------------------------
# No fallback: a tensor that is not on the CPU goes to the kernel or raises
# ---------------------------------------------------------------------------


def _launches():
    return (RK.ring_commit.launches, RK.scale_commit.launches,
            DA.decode_attend_commit.launches, DA.ca_decode_attend.launches,
            RK.ring_commit_q.launches, DA.decode_attend.launches, QM.qmm.launches,
            AT.attn_tune.launches, RK.quantize_commit.launches,
            RK.quantize_scale_commit.launches, RK.rope_commit.launches, RK.rope_qk.launches)


def test_wrappers_raise_for_non_cuda_devices():
    m = torch.device("meta")
    before = _launches()
    with pytest.raises(ValueError):
        RK.ring_commit(torch.empty(1, 1, 32, 8, device=m), torch.empty(1, 1, 32, 8, device=m),
                       torch.empty(1, 1, 2, 8, device=m), torch.empty(1, 1, 2, 8, device=m),
                       tick(0, m))
    with pytest.raises(ValueError):
        RK.scale_commit(torch.empty(1, 1, 32, device=m), torch.empty(1, 1, 32, device=m),
                        torch.empty(1, 1, 1, device=m), torch.empty(1, 1, 1, device=m),
                        tick(0, m))
    q, k_new, v_new, kc, vc, ks, vs, valid = (x.to(m) for x in _attn_inputs(
        torch.device("cpu"), 1, 8, 256, 64, 1.0, 0))
    kq, vq = kc[:, :, :1], vc[:, :, :1]
    with pytest.raises(ValueError):
        DA.decode_attend_commit(q, kc, vc, ks, vs, kq, vq, k_new, v_new,
                                A.global_ring_plan(0, 256, 1, device=m), valid, window=250)
    with pytest.raises(ValueError):
        DA.ca_decode_attend(q, kc, vc, ks, vs, 200)
    with pytest.raises(ValueError):
        RK.ring_commit(kc, vc, kq, vq, tick(0, m), ks, vs, ks[:, :, :1], vs[:, :, :1])
    with pytest.raises(ValueError):
        DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new,
                         A.global_ring_plan(0, 256, 1, device=m), valid, window=250)
    with pytest.raises(ValueError):  # packed-int4 rings go to the kernel or raise as well
        DA.decode_attend(q, kc[..., :32].to(torch.uint8), vc[..., :32].to(torch.uint8), ks, vs,
                         k_new, v_new, A.global_ring_plan(0, 256, 1, device=m), valid,
                         window=250)
    with pytest.raises(ValueError):
        AT.attn_tune(q[:, :, 0], kc, vc, ks, vs, k_new[:, :, 0], v_new[:, :, 0], valid, 300,
                     250, bb=1)
    with pytest.raises(ValueError):
        QM.qmm(torch.empty(4, 64, dtype=torch.bfloat16, device=m),
               torch.empty(32, 64, dtype=torch.int8, device=m), torch.empty(32, device=m))
    assert _launches() == before


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = _launches()
    x, wq, sc = _qmm_inputs(torch.device("cpu"), 3, 40, 48, seed=0, dtype=torch.float32)
    y = QM.qmm(x, wq, sc)
    np.testing.assert_allclose(y.numpy(), (x @ wq.float().T * sc).numpy(), atol=1e-5,
                               rtol=1e-5)
    z = torch.zeros(1, 2, 32, 8)
    RK.ring_commit(z, z.clone(), torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8), tick(30))
    assert z[:, :, 30:].eq(1).all() and z[:, :, :30].eq(0).all()
    q, k_new, v_new, kc, vc, ks, vs, valid = _attn_inputs(
        torch.device("cpu"), 1, 4, 256, 64, 1.0, 0)
    kq, vq, ksn, vsn = A.quantize_kv_rows(k_new, v_new)
    RK.ring_commit(kc, vc, kq, vq, tick(7), ks, vs, ksn, vsn)
    assert torch.equal(kc[:, :, 7], kq[:, :, 0]) and torch.equal(vs[:, :, 7], vsn[:, :, 0])
    y = DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new, A.global_ring_plan(7, 256, 1),
                         valid, window=250)
    assert y.shape == q.shape and y.dtype == torch.bfloat16
    assert _launches() == before


# ---------------------------------------------------------------------------
# Each launch on its tensors' card and stream
# ---------------------------------------------------------------------------


def _kernel_calls(put):
    """Every kernel wrapper once, on inputs made on the CPU from a seed and
    moved by ``put`` -> each call's outputs and the rings it wrote, by name.
    On CPU tensors the wrappers run their plain versions, on CUDA tensors
    their kernels."""
    g = torch.Generator().manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16):
        return put(torch.randn(*shape, generator=g).to(dtype))

    def int8(*shape):
        return put(torch.randint(-127, 128, shape, generator=g, dtype=torch.int8))

    def rand(*shape):
        return put(torch.rand(*shape, generator=g) * 0.019 + 0.001)

    def pos(p):
        return put(tick(p))

    out = {}
    kc, vc = randn(2, 2, 32, 64), randn(2, 2, 32, 64)
    RK.ring_commit(kc, vc, randn(2, 2, 2, 64), randn(2, 2, 2, 64), pos(30))
    out["ring_commit"] = (kc, vc)
    out["ring_commit_backward"] = RK.ring_commit_backward(
        randn(2, 2, 32, 64, dtype=torch.float32), randn(2, 2, 32, 64, dtype=torch.float32),
        pos(30), 2)
    kq, vq, ks, vs = int8(2, 2, 256, 64), int8(2, 2, 256, 64), rand(2, 2, 256), rand(2, 2, 256)
    RK.ring_commit(kq, vq, int8(2, 2, 1, 64), int8(2, 2, 1, 64), pos(7), ks, vs,
                   rand(2, 2, 1), rand(2, 2, 1))
    RK.scale_commit(ks, vs, rand(2, 2, 1), rand(2, 2, 1), pos(9))
    RK.quantize_commit(randn(2, 2, 1, 64), randn(2, 2, 1, 64), kq, vq, ks, vs, pos(11))
    out["ring_commit_q, scale_commit, quantize_commit"] = (kq, vq, ks, vs)
    k4, v4 = put(torch.zeros(2, 2, 256, 32, dtype=torch.uint8)), put(
        torch.zeros(2, 2, 256, 32, dtype=torch.uint8))
    RK.quantize_commit(randn(2, 2, 1, 64), randn(2, 2, 1, 64), k4, v4, ks, vs, pos(12))
    out["quantize_commit packed"] = (k4, v4, ks, vs)
    out["quantize_scale_commit"] = RK.quantize_scale_commit(
        randn(2, 2, 1, 64), randn(2, 2, 1, 64), ks, vs, pos(13)) + (ks, vs)
    cos, sin = (put(x) for x in A.rope_cos_sin(torch.arange(30, 32)[None], 64, 10_000.0))
    rc, rv = randn(2, 2, 32, 64), randn(2, 2, 32, 64)
    out["rope_commit"] = RK.rope_commit(randn(2, 2, 2, 64), randn(2, 2, 2, 64),
                                        randn(2, 2, 2, 64), rc, rv, cos, sin, pos(30)) + (rc, rv)
    out["rope_qk"] = RK.rope_qk(randn(2, 2, 1, 64), randn(2, 2, 1, 64), cos[:, :1], sin[:, :1])
    q, k_new, v_new, akc, avc, aks, avs, valid = (put(x) for x in _attn_inputs(
        torch.device("cpu"), 2, 8, 256, 64, 0.9, 3))
    plan = A.global_ring_plan(pos(100), 256, 1)
    out["decode_attend_commit"] = (DA.decode_attend_commit(
        q, akc, avc, aks, avs, akc[:, :, :1].clone(), avc[:, :, :1].clone(), k_new, v_new,
        plan, valid, window=250),)
    out["decode_attend"] = (DA.decode_attend(q, akc, avc, aks, avs, k_new, v_new, plan, valid,
                                             window=250),)
    out["decode_attend packed"] = (DA.decode_attend(
        q, int8(2, 8, 256, 32).view(torch.uint8), int8(2, 8, 256, 32).view(torch.uint8), aks,
        avs, k_new, v_new, plan, valid, window=250),)
    out["attn_tune"] = (AT.attn_tune(q[:, :, 0], akc, avc, aks, avs, k_new[:, :, 0],
                                     v_new[:, :, 0], valid, 300, 250, bb=1),)
    out["ca_decode_attend"] = (DA.ca_decode_attend(*(put(x) for x in _ca_inputs(
        torch.device("cpu"), 2, 8, 128, 100, 64, 4)), 100),)
    out["qmm"] = (QM.qmm(*(put(x) for x in _qmm_inputs(torch.device("cpu"), 8, 64, 128, 6)),
                         ksplit=1),)
    return out


KERNEL_LIBS = {  # the library function each wrapper of _kernel_calls launches
    "dsm_ring_commit", "dsm_ring_commit_backward", "dsm_ring_commit_q", "dsm_scale_commit",
    "dsm_quantize_commit", "dsm_rope_commit", "dsm_decode_attend_commit", "dsm_decode_attend",
    "dsm_attn_tune", "dsm_ca_decode_attend", "dsm_qmm"}


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:1``: a wrapper given it
    takes its kernel's route, whose launch the test records."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 1)


def test_every_wrapper_launches_on_its_tensors_device(monkeypatch):
    """Every kernel wrapper launches with its tensors' device current and on
    that device's stream (``_build.launch``): tensors that say they lie on
    ``cuda:1`` while ``cuda:0`` is current, the library, ``torch.cuda.device``,
    ``torch.cuda.current_device`` and ``_build.stream_ptr`` stood in for (a
    CPU has none), the wrappers' allocations made on the CPU.  The launch
    counters are put back afterwards: other files that run in the same
    process hold CPU calls to count nothing."""
    from dsm_tpu_torch.ops import _build

    for fn in (RK.ring_commit, RK.ring_commit_backward, RK.scale_commit,
               DA.decode_attend_commit, DA.ca_decode_attend, RK.ring_commit_q,
               DA.decode_attend, QM.qmm, AT.attn_tune, RK.quantize_commit,
               RK.quantize_scale_commit, RK.rope_commit, RK.rope_qk):
        monkeypatch.setattr(fn, "launches", fn.launches)
    card1 = torch.device("cuda", 1)
    made = {}
    for name in ("empty", "zeros", "full", "arange"):
        real = getattr(torch, name)

        def factory(*a, device=None, _real=real, **kw):
            t = _real(*a, **kw)
            return t.as_subclass(_OnCard1) if device is not None and \
                torch.device(device) == card1 else t

        made[name] = factory
    for name, fn in made.items():
        monkeypatch.setattr(torch, name, fn)
    current, streams, launched = [], [], []

    class Device:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            return False

    class Lib:
        def __getattr__(self, name):
            if name.endswith("_smem_bytes"):
                return lambda *a: 1024
            if name == "dsm_decode_attend_tile_rows":
                return lambda *a: 128

            def launch(*args):
                launched.append((name, current[-1] if current else None, args[-1].value))
                return 0

            return launch

    def stream_ptr(device):
        streams.append(torch.device(device))
        return 4096 + len(streams)

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(_build, "stream_ptr", stream_ptr)
    monkeypatch.setattr(DA, "ring_card", lambda index, dh, packed: (128, 132))
    monkeypatch.setattr(DA, "card_sms", lambda index: 132)
    before = _launches()
    _kernel_calls(lambda t: t.as_subclass(_OnCard1))
    assert {name for name, _, _ in launched} == KERNEL_LIBS
    assert all(dev == card1 for _, dev, _ in launched), launched
    assert streams == [card1] * len(launched)
    assert [ptr for _, _, ptr in launched] == [4097 + i for i in range(len(launched))]
    # ring_commit_backward's counter is not among _launches()
    assert sum(_launches()) - sum(before) == len(launched) - 1


@pytest.mark.cuda
def test_every_kernel_on_the_second_card_with_the_first_current(cuda_device):
    """Every kernel launched on ``cuda:1`` tensors while ``cuda:0`` is the
    current device, against its plain version on the same inputs (on the
    CPU): rings and integer outputs bit for bit, the rest within 2e-2; the
    shared-memory opt-ins are per device (the staged attention, qmm and the
    packed attention raise their limit on ``cuda:1`` too).  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: launches on cuda:1 while cuda:0 is current")
    card1 = torch.device("cuda", 1)
    want = _kernel_calls(lambda t: t)
    with torch.cuda.device(0):
        got = _kernel_calls(lambda t: t.to(card1))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(card1)
    assert got.keys() == want.keys()
    for name in want:
        for a, b in zip(got[name], want[name]):
            assert a.device == card1, name
            a = a.cpu()
            if a.dtype.is_floating_point and name not in ("ring_commit", "rope_commit"):
                assert _within(a, b), name
            else:
                assert torch.equal(a, b), name


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
    RK.ring_commit(kc, vc, kn, vn, tick(w, cuda_device))
    RK.ring_commit_plain(kp, vp, kn, vn, w)
    torch.cuda.synchronize()
    assert RK.ring_commit.launches == before + 1
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,t,w", [
    ((256, 16, 32, 64), 1, 0), ((256, 16, 32, 64), 1, 16),  # the DepFormer's ring
    ((256, 16, 32, 64), 1, 31), ((64, 8, 256, 64), 2, 0), ((64, 8, 256, 64), 2, 128),
    ((64, 8, 256, 64), 2, 254),
    ((3, 2, 8, 6), 2, 4), ((3, 2, 8, 5), 1, 7),  # rows of 12 / 20 and 10 bytes
])
def test_ring_commit_backward_kernel_matches_plain(cuda_device, dtype, shape, t, w):
    """The gradients split bit for bit as the plain version splits them (the
    incoming gradients untouched), one launch; a wrapped position."""
    g = torch.Generator(device=cuda_device).manual_seed(w + t)
    gk, gv = (torch.randn(*shape, generator=g, device=cuda_device).to(dtype) for _ in range(2))
    gk[0, 0, w] = float("nan")  # NaN bits and signed zeros are copied, not computed
    gv[0, 0, w] = -0.0
    keep = gk.clone(), gv.clone()
    before = RK.ring_commit_backward.launches
    got = RK.ring_commit_backward(gk, gv, tick(w + 2 * shape[2], cuda_device), t)
    want = RK.ring_commit_backward_plain(gk, gv, w, t)
    torch.cuda.synchronize()
    assert RK.ring_commit_backward.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(gk.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       keep[0].view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(gv, keep[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_commit_under_autograd_launches_both_kernels(cuda_device, dtype):
    """The commit under autograd on the card: the forward kernel once a
    commit, the backward kernel once a commit in the backward pass, the
    gradients bit for bit those of the plain Function."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    base = torch.randn(4, 2, 32, 8, generator=g, device=cuda_device).to(dtype)
    rows = [torch.randn(4, 2, 1, 8, generator=g, device=cuda_device).to(dtype)
            for _ in range(6)]
    weight = torch.randn(4, 2, 32, 8, generator=g, device=cuda_device)

    def run(commit):
        leaf = base.clone().requires_grad_(True)
        news = [x.clone().requires_grad_(True) for x in rows]
        k, v = leaf * 1, leaf * 2
        loss = 0
        for i in range(3):
            commit(k, v, news[2 * i], news[2 * i + 1], tick(i, cuda_device))
            loss = loss + (k.float() * weight).sum() * (i + 1) + (v.float() * weight).sum()
        loss.backward()
        return [leaf.grad] + [x.grad for x in news]

    before = RK.ring_commit.launches, RK.ring_commit_backward.launches
    got = run(RK.ring_commit)
    torch.cuda.synchronize()
    assert (RK.ring_commit.launches - before[0], RK.ring_commit_backward.launches - before[1]) \
        == (3, 3)
    for a, b in zip(got, run(RK.ring_commit_plain)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C,w", [
    (768, 0), (768, 5), (768, 767),  # stt-1b scale rings
    (1024, 0), (1024, 1023),         # tts-1.6b scale rings
])
def test_scale_commit_kernel_matches_plain(cuda_device, C, w):
    g = torch.Generator(device=cuda_device).manual_seed(w)
    ks, vs = (torch.rand(64, 16, C, generator=g, device=cuda_device) for _ in range(2))
    ksn, vsn = (torch.rand(64, 16, 1, generator=g, device=cuda_device) for _ in range(2))
    kp, vp = ks.clone(), vs.clone()
    before = RK.scale_commit.launches
    RK.scale_commit(ks, vs, ksn, vsn, tick(w, cuda_device))
    RK.scale_commit_plain(kp, vp, ksn, vsn, w)
    torch.cuda.synchronize()
    assert RK.scale_commit.launches == before + 1
    assert torch.equal(ks, kp) and torch.equal(vs, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,pos,window,valid_frac", [
    (2, 8, 256, 128, 0, 250, 1.0),
    (2, 8, 256, 128, 255, 250, 1.0),
    (2, 8, 256, 128, 1000, 250, 0.6),
    (64, 16, 768, 128, 3000, 750, 0.9),    # stt-1b serving shape, B=64
    (2, 32, 384, 64, 1000, 375, 0.9),      # Dh=64 (stt-2.6b head shape)
    (64, 16, 1024, 128, 1023, 1024, 1.0),  # tts-1.6b: window = C, first full ring
    (64, 16, 1024, 128, 2048, 1024, 0.7),  # ... at the wrap, partial mask
    (64, 16, 1024, 128, 5000, 1024, 0.7),  # ... well past the wrap
])
def test_decode_attend_commit_kernel_matches_plain(cuda_device, B, H, C, Dh, pos,
                                                   window, valid_frac):
    sharp = window == C  # the TTS cases: O(1) outputs, where a wrong mask shows
    q, k_new, v_new, kc, vc, ks, vs, valid = _attn_inputs(
        cuda_device, B, H, C, Dh, valid_frac, seed=pos + B, sharp=sharp)
    k0, v0 = kc.clone(), vc.clone()
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
    if sharp and valid_frac < 1.0:  # the bar sees a mask that lets every row in
        alt = DA.decode_attend_commit_plain(rows[0], k0, v0, ks, vs, *rows[1:],
                                            torch.ones_like(valid), pos, plan["w"][0], window)
        assert not _within(alt, yp)


CA_CASES = [
    (64, 16, 640, 625, 128),  # the TTS serving shape: 5 speakers x 125 rows
    (64, 16, 256, 200, 128),  # a partial source
    (64, 32, 640, 625, 64),   # Dh=64, H=32
    (3, 8, 128, 1, 64),       # one real row
    (32, 8, 640, 625, 128),   # a tp = 2 shard of the TTS mesh
    (1, 16, 640, 625, 128),   # one session
    (4, 8, 640, 619, 64),     # 619 rows: no cluster of 2-8 blocks divides them
    (2, 16, 640, 619, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,s_len,Dh", CA_CASES)
def test_ca_decode_attend_kernel_matches_plain(cuda_device, B, H, S, s_len, Dh):
    q, k, v, ks, vs = _ca_inputs(cuda_device, B, H, S, s_len, Dh, seed=S + H)
    assert DA.ca_supported(q, k)
    before = DA.ca_decode_attend.launches
    y = DA.ca_decode_attend(q, k, v, ks, vs, s_len)
    yp = DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, s_len)
    torch.cuda.synchronize()
    assert DA.ca_decode_attend.launches == before + 1
    assert y.shape == (B, H, 1, Dh) and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y[:, :, 0].float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cluster", range(1, 9))
@pytest.mark.parametrize("B,H,S,s_len,Dh", CA_CASES)
def test_ca_decode_attend_kernel_at_every_cluster_size(cuda_device, B, H, S, s_len, Dh,
                                                       n_cluster):
    """The kernel with the source split over clusters of 1-8 blocks (the
    picker's whole range, forced): within 2e-2 of the plain version, three
    runs bit for bit, one launch a call; the bar still sees a dropped last
    row and a padding row read."""
    q, k, v, ks, vs = _ca_inputs(cuda_device, B, H, S, s_len, Dh, seed=S + H + n_cluster)
    before = DA.ca_decode_attend.launches
    runs = [DA._ca_launch(q[:, :, 0], k, v, ks, vs, s_len, n_cluster) for _ in range(3)]
    yp = DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, s_len)
    torch.cuda.synchronize()
    assert DA.ca_decode_attend.launches == before + 3
    assert all(torch.equal(runs[0], y) for y in runs[1:])
    np.testing.assert_allclose(runs[0].float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    for n in (s_len - 1, s_len + 1):
        if 1 <= n <= S:
            assert not _within(DA.ca_decode_attend_plain(q[:, :, 0], k, v, ks, vs, n), runs[0])


@pytest.mark.cuda
def test_ca_smem_bytes_is_the_kernels_layout(cuda_device):
    from dsm_tpu_torch.ops import _build

    lib = _build.lib()
    for dh in (64, 128):
        for span in (4, 80, 316, 628, 17000):
            for n in range(1, 9):
                assert DA.ca_smem_bytes(span, dh, n) == lib.dsm_ca_decode_attend_smem_bytes(
                    span, dh, n)


@pytest.mark.cuda
def test_ca_decode_attend_kernel_raises_on_unsupported(cuda_device):
    q = torch.zeros(2, 8, 1, 96, dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros(2, 8, 128, 96, dtype=torch.int8, device=cuda_device)
    s = torch.ones(2, 8, 128, device=cuda_device)
    before = DA.ca_decode_attend.launches
    with pytest.raises(ValueError):
        DA.ca_decode_attend(q, k, k, s, s, 100)
    with pytest.raises(ValueError):
        DA.ca_decode_attend(q[..., :64].float(), k[..., :64], k[..., :64], s, s, 100)
    assert DA.ca_decode_attend.launches == before


# ---------------------------------------------------------------------------
# The split ring pipeline: ring_commit_q and decode_attend
# ---------------------------------------------------------------------------


def _split_inputs(dev, b, h, c, dh, pos, window, valid_frac, seed):
    """A committed int8 ring with O(1) outputs on which a wrong mask shows:
    the oldest attended row matches the query best (score 14 against a
    spread of about 3.7), and ring row ``w`` (this step's committed row,
    which the mask excludes) would match it better still (score 26) with
    values of 127 at scale 1.  Returns the kernel's operands and the ring
    index of the oldest attended row (None when no row is attended)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = _sharp_scales(g, dev, b, h, c)
    valid = torch.rand(b, c, generator=g, device=dev) < valid_frac
    w = pos % c
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 127, -127).to(torch.int8)
    per_scale = 127.0 * qf.abs().sum(-1) / dh ** 0.5  # score per unit k_scale
    kc[:, :, w] = aligned
    ks[:, :, w] = 26.0 / per_scale
    vc[:, :, w] = 127
    vs[:, :, w] = 1.0
    valid[:, w] = True
    d_max = min(pos, window - 1, c - 1)
    oldest = None
    if d_max >= 1:
        oldest = (w - d_max) % c
        kc[:, :, oldest] = aligned
        ks[:, :, oldest] = 14.0 / per_scale
        valid[:, oldest] = True
    return (q, kc, vc, ks, vs, k_new, v_new, valid), oldest


def _true_mask(valid, pos, c, window):
    j = torch.arange(c, device=valid.device)
    dist = torch.remainder(pos % c - j, c)
    return ((dist != 0) & (dist <= pos) & (dist < window))[None, :] & valid


def _attend_with_mask(q, kc, vc, ks, vs, k_new, v_new, ok, fresh=True):
    """Decode attention over the ring rows ``ok (B, C)`` lets in plus the
    fresh row (unless ``fresh`` is off), written independently of the port's
    plain version."""
    scale = q.shape[-1] ** -0.5
    qf = q[:, :, 0].float()
    s = torch.einsum("bhd,bhcd->bhc", qf, kc.float()) * ks * scale
    s = torch.where(ok[:, None, :], s, float("-inf"))
    s_new = (qf * k_new[:, :, 0].float()).sum(-1, keepdim=True) * scale
    if not fresh:
        s_new = torch.full_like(s_new, float("-inf"))
    p = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhc,bhcd->bhd", p[..., :-1] * vs, vc.float())
    return out + p[..., -1:] * v_new[:, :, 0].float()


SPLIT_CASES = [
    # B, H, C, Dh, pos, window, valid share
    (24, 20, 3072, 128, 0, 3000, 1.0),      # first step: the ring holds garbage
    (24, 20, 3072, 128, 40, 3000, 0.7),
    (24, 20, 3072, 128, 3071, 3000, 1.0),   # full ring
    (24, 20, 3072, 128, 5000, 3000, 0.7),   # wrapped
    (24, 20, 3072, 128, 10000, 3000, 1.0),
    (2, 32, 4096, 64, 4200, 4096, 0.9),     # tts_v0_1: h=32, Dh=64, window = C
    (2, 20, 256, 128, 1000, 250, 0.6),
    (24, 20, 3072, 128, 1, 3000, 1.0),      # one ring row in the window
    (24, 20, 3072, 128, 2999, 3000, 0.8),   # window - 1: every row but w, unwrapped
    (64, 32, 384, 64, 40, 375, 0.7),        # stt-2.6b, nearly empty
    (64, 32, 384, 64, 3000, 375, 1.0),      # stt-2.6b, wrapped
    (64, 32, 512, 64, 3000, 500, 1.0),      # tts_202501, wrapped
    (64, 16, 768, 128, 3000, 750, 1.0),     # stt-1b's split route, wrapped
    (24, 32, 3072, 128, 40, 3000, 0.7),     # Moshi 7B, a served ring
    (12, 10, 3072, 128, 5000, 3000, 0.7),   # an s2s-2b dp x tp shard: split on the card
    (32, 4, 768, 128, 3000, 750, 1.0),      # the tp = 4 stt-1b shard: split on the card
]


@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac", [
    (2, 20, 256, 128, 40, 250, 0.7), (2, 20, 256, 128, 1000, 250, 0.6),
    (1, 8, 512, 64, 511, 512, 1.0), (2, 4, 256, 64, 0, 250, 1.0)])
def test_split_check_inputs_see_a_wrong_mask(B, H, C, Dh, pos, window, frac):
    """On the card cases' inputs the 2e-2 bar fails a result that dropped
    the oldest attended row, let ring row w in, or let every ring row in
    (plain version against an independent masked attention, CPU)."""
    dev = torch.device("cpu")
    args, oldest = _split_inputs(dev, B, H, C, Dh, pos, window, frac, seed=pos + C)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    plan = A.global_ring_plan(pos, C, 1)
    want = DA.decode_attend(*args[:7], plan, valid, window=window, n_split=1)[:, :, 0]
    ok = _true_mask(valid, pos, C, window)
    assert _within(_attend_with_mask(*args[:7], ok), want)
    for n_split in (2, 3):
        assert _within(DA.decode_attend(*args[:7], plan, valid, window=window,
                                        n_split=n_split)[:, :, 0], want)
    wrong = {"row w let in": ok.clone(), "every row let in": torch.ones_like(ok)}
    wrong["row w let in"][:, pos % C] = True
    if oldest is not None:
        assert want.float().abs().max() > 0.3
        wrong["oldest row dropped"] = ok.clone()
        wrong["oldest row dropped"][:, oldest] = False
    for what, mask in wrong.items():
        assert not _within(_attend_with_mask(*args[:7], mask), want), what


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,w", [
    (24, 20, 3072, 128, 0), (24, 20, 3072, 128, 1500), (24, 20, 3072, 128, 3071),
    (64, 32, 384, 64, 100), (3, 5, 40, 12, 39)])
def test_ring_commit_q_kernel_matches_plain(cuda_device, B, H, C, Dh, w):
    g = torch.Generator(device=cuda_device).manual_seed(w)
    kc, vc, kn, vn = (torch.randint(-127, 128, shape, generator=g, device=cuda_device,
                                    dtype=torch.int8)
                      for shape in ((B, H, C, Dh),) * 2 + ((B, H, 1, Dh),) * 2)
    ks, vs, ksn, vsn = (torch.rand(*shape, generator=g, device=cuda_device)
                        for shape in ((B, H, C),) * 2 + ((B, H, 1),) * 2)
    plain = [x.clone() for x in (kc, vc, ks, vs)]
    before = RK.ring_commit_q.launches, RK.ring_commit.launches
    RK.ring_commit(kc, vc, kn, vn, tick(w, cuda_device), ks, vs, ksn, vsn)
    RK.ring_commit_plain(plain[0], plain[1], kn, vn, w, plain[2], plain[3], ksn, vsn)
    torch.cuda.synchronize()
    assert (RK.ring_commit_q.launches, RK.ring_commit.launches) == (before[0] + 1, before[1])
    for got, want in zip((kc, vc, ks, vs), plain):
        assert torch.equal(got, want)
    assert torch.equal(kc[:, :, w], kn[:, :, 0]) and torch.equal(vs[:, :, w], vsn[:, :, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, None, 5])
@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac", SPLIT_CASES)
def test_decode_attend_kernel_matches_plain(cuda_device, B, H, C, Dh, pos, window, frac,
                                            n_split):
    args, oldest = _split_inputs(cuda_device, B, H, C, Dh, pos, window, frac, seed=pos + C)
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    valid = args[7]
    assert DA.supported(args[0], args[1], plan)
    # Split-route shapes; stt-1b's rings take it under fused_attn = False only.
    assert DA.fused_commit_supported(args[0], args[1], plan) == (
        DA._mono_ok(H, C, Dh) and DA._legacy_4d(H, Dh)) == ((H, C, Dh) == (16, 768, 128))
    before = DA.decode_attend.launches
    runs = [DA.decode_attend(*args[:7], plan, valid, window=window, n_split=n_split)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert DA.decode_attend.launches == before + 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    y = runs[0]
    assert y.shape == (B, H, 1, Dh) and y.dtype == torch.bfloat16
    split = DA.card_split(B * H, C, Dh, False, cuda_device) if n_split is None else n_split
    rows = [x[:, :, 0].contiguous() for x in (args[0], args[5], args[6])]
    for n in {split, 1}:  # the plain version in the kernel's split, and unsplit
        yp = DA.decode_attend_plain(rows[0], *args[1:5], rows[1], rows[2], valid, pos,
                                    plan["w"][0], window, n)
        np.testing.assert_allclose(y[:, :, 0].float().cpu().numpy(),
                                   yp.float().cpu().numpy(), atol=2e-2, rtol=2e-2)
    if oldest is None:  # only the fresh row attends: the garbage ring is ignored
        np.testing.assert_allclose(y.float().cpu().numpy(), args[6].float().cpu().numpy(),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [None, 3])
@pytest.mark.parametrize("pos", [0, 1, 40, 374, 1000])
def test_decode_attend_kernel_takes_head_major_strides(cuda_device, pos, n_split):
    """A (B*H, C, Dh) ring addressed as (1, B*H, C, Dh): the same kernel,
    bit for bit, at pos 0 and 1, nearly empty, at window - 1 and wrapped;
    within the bar of the plain version."""
    args, _ = _split_inputs(cuda_device, 2, 32, 384, 64, pos, 375, 0.9, seed=5 + pos)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    plan = A.global_ring_plan(pos, 384, 1, device=cuda_device)
    want = DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new, plan, valid, window=375,
                            n_split=n_split)
    k_t, v_t = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (kc, vc))
    ks_t, vs_t = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (ks, vs))
    assert not k_t.is_contiguous()
    got = DA.decode_attend(q, k_t, v_t, ks_t, vs_t, k_new, v_new, plan, valid, window=375,
                           n_split=n_split)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    split = DA.card_split(2 * 32, 384, 64, False, cuda_device) if n_split is None else n_split
    rows = [x[:, :, 0].contiguous() for x in (q, k_new, v_new)]
    yp = DA.decode_attend_plain(rows[0], kc, vc, ks, vs, rows[1], rows[2], valid, pos,
                                pos % 384, 375, split)
    assert _within(got[:, :, 0], yp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,pos,window", [
    (64, 32, 384, 64, 3000, 375), (64, 32, 512, 64, 3000, 500), (64, 16, 768, 128, 40, 750),
    (24, 20, 3072, 128, 10000, 3000)])
def test_decode_attend_int8_is_one_launch_and_allocates_only_its_output(cuda_device, B, H, C,
                                                                        Dh, pos, window):
    """At one span (the card's pick at every serving ring): one kernel on
    the device a call (the fresh row folded in it, no fold launch) and no
    memory but the output, at the peak too (no partials' scratch)."""
    args, _ = _split_inputs(cuda_device, B, H, C, Dh, pos, window, 1.0, seed=3)
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    assert DA.card_split(B * H, C, Dh, False, cuda_device) == 1

    def call():
        return DA.decode_attend(*args[:7], plan, args[7], window=window)

    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = call()
    torch.cuda.synchronize()
    out_bytes = -(-y.numel() * y.element_size() // 512) * 512  # the allocator's blocks
    assert torch.cuda.memory_allocated() - base == out_bytes
    assert torch.cuda.max_memory_allocated() - base == out_bytes
    del y
    before = DA.decode_attend.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    assert DA.decode_attend.launches == before + 3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0}
    assert len(kernels) == 1 and "decode_attend_q8_kernel" in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac", [
    (12, 10, 3072, 128, 5000, 3000, 0.7), (32, 4, 768, 128, 3000, 750, 1.0),
    (64, 32, 384, 64, 3000, 375, 1.0)])
def test_decode_attend_int8_repeats_bit_for_bit(cuda_device, B, H, C, Dh, pos, window, frac):
    """Ten calls at the card's pick (split at the tp shards: the fold kernel
    as a programmatic dependent launch; one span at stt-2.6b), interleaved
    with calls at other splits on the same stream, all bit-identical."""
    args, _ = _split_inputs(cuda_device, B, H, C, Dh, pos, window, frac, seed=11)
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    pick = DA.card_split(B * H, C, Dh, False, cuda_device)
    assert (pick > 1) == (B * H < 2 * DA.card_sms(cuda_device.index or 0))
    runs = []
    for i in range(10):
        runs.append(DA.decode_attend(*args[:7], plan, args[7], window=window))
        DA.decode_attend(*args[:7], plan, args[7], window=window, n_split=1 + i % 4)
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], y) for y in runs[1:])
    rows = [x[:, :, 0].contiguous() for x in (args[0], args[5], args[6])]
    yp = DA.decode_attend_plain(rows[0], *args[1:5], rows[1], rows[2], args[7], pos, pos % C,
                                window, pick)
    assert _within(runs[0][:, :, 0], yp)


@pytest.mark.cuda
def test_decode_attend_int8_raises_where_the_kernel_does_not_serve(cuda_device):
    """Head widths other than 64 and 128, a ring of a row count that is not
    a multiple of 4, scales or validity rows off the bulk copies' alignment:
    each raises before any launch."""
    before = _launches()
    for dh in (32, 96, 256):
        q = torch.zeros(2, 8, 1, dh, dtype=torch.bfloat16, device=cuda_device)
        k = torch.zeros(2, 8, 256, dh, dtype=torch.int8, device=cuda_device)
        s = torch.ones(2, 8, 256, device=cuda_device)
        valid = torch.ones(2, 256, dtype=torch.bool, device=cuda_device)
        with pytest.raises(ValueError, match="Dh 64 or 128"):
            DA.decode_attend(q, k, k, s, s, q, q, A.global_ring_plan(3, 256, 1,
                                                                     device=cuda_device),
                             valid, window=250)
    args, _ = _split_inputs(cuda_device, 2, 8, 256, 64, 300, 250, 1.0, seed=1)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    plan = A.global_ring_plan(300, 256, 1, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        DA.decode_attend(q, kc[:, :, :254], vc[:, :, :254], ks[:, :, :254].contiguous(),
                         vs[:, :, :254].contiguous(), k_new, v_new,
                         A.global_ring_plan(300, 254, 1, device=cuda_device),
                         valid[:, :254].contiguous(), window=250)
    sflat = torch.ones(ks.numel() + 4, device=cuda_device)
    s_off = sflat[1:1 + ks.numel()].view(ks.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        DA.decode_attend(q, kc, vc, s_off, s_off, k_new, v_new, plan, valid, window=250)
    vflat = torch.ones(valid.numel() + 4, dtype=torch.bool, device=cuda_device)
    v_off = vflat[1:1 + valid.numel()].view(valid.shape)
    with pytest.raises(ValueError, match="4-byte aligned"):
        DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new, plan, v_off, window=250)
    assert _launches() == before


@pytest.mark.cuda
def test_split_kernels_raise_on_unsupported(cuda_device):
    before = _launches()
    q = torch.zeros(2, 8, 1, 96, dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros(2, 8, 256, 96, dtype=torch.int8, device=cuda_device)
    s = torch.ones(2, 8, 256, device=cuda_device)
    valid = torch.ones(2, 256, dtype=torch.bool, device=cuda_device)
    plan = A.global_ring_plan(3, 256, 1, device=cuda_device)
    assert not DA.supported(q, k, plan)
    with pytest.raises(ValueError):  # Dh = 96
        DA.decode_attend(q, k, k, s, s, q, q, plan, valid, window=250)
    with pytest.raises(ValueError):  # f32 queries
        DA.decode_attend(q[..., :64].float(), k[..., :64], k[..., :64], s, s,
                         q[..., :64], q[..., :64], plan, valid, window=250)
    with pytest.raises(ValueError):  # bf16 rings go to ring_commit without scales
        RK.ring_commit(k.bfloat16(), k.bfloat16(), k[:, :, :1], k[:, :, :1], plan["pos"],
                       s, s, s[:, :, :1], s[:, :, :1])
    # A uint8 ring is a packed-int4 ring of Dh/2 bytes a row, nothing else.
    packed = torch.zeros(2, 8, 256, 64, dtype=torch.uint8, device=cuda_device)
    assert not DA.supported(q[..., :64], packed, plan)
    with pytest.raises(ValueError):  # 64 bytes a row are Dh = 128, not 64
        DA.decode_attend(q[..., :64], packed, packed, s, s, q[..., :64], q[..., :64], plan,
                         valid, window=250)
    with pytest.raises(ValueError):  # int8 rows into a packed ring
        RK.ring_commit(packed, packed, k[:, :, :1, :64], k[:, :, :1, :64], plan["pos"],
                       s, s, s[:, :, :1], s[:, :, :1])
    # What the packed kernel's bulk copies refuse, before any launch: rows,
    # (b, h) strides or scales off 16 bytes, and K and V in different layouts.
    q4, rows = q[..., :64], packed[..., :32].contiguous()  # Dh = 64: 32 bytes a row
    flat = torch.zeros(2 * 8 * 8200 + 64, dtype=torch.uint8, device=cuda_device)
    off_rows = flat[8:8 + rows.numel()].view(rows.shape)
    off_bh = flat.as_strided(rows.shape, (8 * 8200, 8200, 32, 1))  # 8,200-byte (b, h) stride
    sflat = torch.ones(2 * 8 * 260 + 4, device=cuda_device)
    s_off = sflat[1:1 + s.numel()].view(s.shape)
    s_bh = sflat.as_strided(s.shape, (8 * 258, 258, 1))  # scales' (b, h) stride 258
    assert DA.supported(q4, rows, plan)
    for kc, vc, ks in ((off_rows, off_rows, s), (off_bh, off_bh, s), (rows, rows, s_off),
                       (rows, rows, s_bh), (rows, off_bh, s)):
        with pytest.raises(ValueError):
            DA.decode_attend(q4, kc, vc, ks, ks, q4, q4, plan, valid, window=250)
    with pytest.raises(ValueError):  # a packed ring of 254 rows
        DA.decode_attend(q4, rows[:, :, :254], rows[:, :, :254], s[:, :, :254], s[:, :, :254],
                         q4, q4, A.global_ring_plan(3, 254, 1, device=cuda_device),
                         valid[:, :254].contiguous(), window=250)
    assert _launches() == before


@pytest.mark.cuda
def test_step_raises_where_no_attention_kernel_serves(cuda_device):
    """``transformer.step`` puts no gate before ``decode_attend``: an int8
    ring with a head width the kernel does not take raises on the card
    rather than attending through plain PyTorch."""
    cfg = T.TransformerConfig(d_model=384, num_heads=4, num_layers=1, dim_feedforward=256,
                              context=250, head_dim=96)
    params = T.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                    dtype=torch.bfloat16)
    state = T.init_state(cfg, 2, kv_quant=True, device=cuda_device)
    x = torch.zeros(2, 1, 384, dtype=torch.bfloat16, device=cuda_device)
    before = DA.decode_attend.launches
    with pytest.raises(ValueError, match="Dh 64 or 128"):
        T.step(cfg, params, state, x)
    assert DA.decode_attend.launches == before


# ---------------------------------------------------------------------------
# The weight-only int8 matmul (csrc/qmm.cu) and the fused commit at h=32, Dh=64
# ---------------------------------------------------------------------------


def _qmm_inputs(dev, m, o, i, seed, dtype=torch.bfloat16, lead=()):
    """Activations of unit spread, int8 weights, scales that make the
    outputs O(1): a dropped 64-wide piece of K moves an output by about
    ``sqrt(64 / I)``, a dropped scale by far more."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*lead, m, i, generator=g, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (o, i), generator=g, device=dev, dtype=torch.int8)
    sc = (torch.rand(o, generator=g, device=dev) + 0.5) / (73.3 * i ** 0.5)
    return x, wq, sc


def _qmm_within(a, p):
    """Relative L2 <= 2e-3 and every element within one bf16 step of the
    plain result or 1e-2 absolute: the two sum f32 products in other orders
    and round once."""
    a, p = a.float(), p.float()
    ulp = torch.exp2(torch.floor(torch.log2(p.abs().clamp_min(1e-30))) - 7)
    rel = float((a - p).norm() / p.norm())
    return rel <= 2e-3 and bool(((a - p).abs() <= torch.maximum(ulp, torch.tensor(
        1e-2, device=p.device))).all())


def test_qmm_check_inputs_see_a_dropped_scale_and_a_dropped_chunk():
    """The bar of the card's qmm cases, on their inputs, fails a result that
    dropped one output channel's scale or one 64-wide piece of K (plain
    version, CPU)."""
    x, wq, sc = _qmm_inputs(torch.device("cpu"), 8, 96, 512, seed=1)
    want = QM.qmm_plain(x, wq, sc)
    assert 0.5 < float(want.float().std()) < 2.0
    assert _qmm_within(want, want)
    s_bad = sc.clone()
    s_bad[17] = 1.0
    assert not _qmm_within(QM.qmm_plain(x, wq, s_bad), want)
    x_bad = x.clone()
    x_bad[:, 128:192] = 0
    assert not _qmm_within(QM.qmm_plain(x_bad, wq, sc), want)


QMM_SHAPES = [  # (M, O, I): the stt-2.6b serving shapes, then tails and small M
    (64, 6144, 2048), (64, 2048, 2048), (64, 11264, 2048), (64, 2048, 5632),
    (64, 4000, 2048), (1, 2048, 2048), (24, 2048, 2048), (24, 2048, 1024),
    (7, 100, 48), (33, 72, 272), (130, 200, 528), (64, 2048, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,o,i", QMM_SHAPES, ids=lambda v: str(v))
def test_qmm_kernel_matches_plain(cuda_device, m, o, i):
    """Every cluster split the kernel takes at the shape (every one the
    tiling function can pick), the default first: three runs bit-identical
    and within the bar of the plain version."""
    x, wq, sc = _qmm_inputs(cuda_device, m, o, i, seed=m + o + i)
    want = QM.qmm_plain(x, wq, sc)
    before = QM.qmm.launches
    n_chunks = -(-i // 128)
    splits = [None] + list(range(1, min(8, n_chunks) + 1))
    for ksplit in splits:
        runs = [QM.qmm(x, wq, sc, ksplit=ksplit) for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]), ksplit
        y = runs[0]
        assert y.shape == (m, o) and y.dtype == torch.bfloat16
        assert _qmm_within(y, want), (ksplit, float((y.float() - want.float()).abs().max()))
    assert QM.qmm.launches == before + 3 * len(splits)


@pytest.mark.cuda
def test_qmm_is_one_launch_and_allocates_only_its_output(cuda_device):
    """At a shape whose K is split over a cluster: one kernel on the device
    a call (no second pass over partials), and no memory but the output, at
    the peak too (no scratch)."""
    x, wq, sc = _qmm_inputs(cuda_device, 64, 2048, 2048, seed=9)
    assert QM.qmm_tiling(64, 2048, 2048, QM.resident_clusters(cuda_device.index or 0)).ksplit > 1
    QM.qmm(x, wq, sc)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = QM.qmm(x, wq, sc)
    torch.cuda.synchronize()
    out_bytes = -(-y.numel() * y.element_size() // 512) * 512  # the allocator's blocks
    assert torch.cuda.memory_allocated() - base == out_bytes
    assert torch.cuda.max_memory_allocated() - base == out_bytes
    del y
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            QM.qmm(x, wq, sc)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0}
    assert len(kernels) == 1 and "qmm_kernel" in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 3


@pytest.mark.cuda
def test_qmm_kernel_takes_leading_dims_and_stacked_slices(cuda_device):
    """``x (B, T, I)`` and a weight that is slice 1 of an ``(S, O, I)``
    stack (the DepFormer's layout): the slice's rows keep their stride."""
    x, _, _ = _qmm_inputs(cuda_device, 5, 8, 256, seed=2, lead=(3,))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    stack = torch.randint(-127, 128, (4, 200, 256), generator=g, device=cuda_device,
                          dtype=torch.int8)
    sc = torch.rand(4, 200, generator=g, device=cuda_device) / 1000
    y = QM.qmm(x, stack[1], sc[1])
    assert y.shape == (3, 5, 200)
    assert _qmm_within(y, QM.qmm_plain(x, stack[1], sc[1]))
    wide = torch.randint(-127, 128, (200, 512), generator=g, device=cuda_device,
                         dtype=torch.int8)
    view = wide[:, :256]  # rows 512 apart: contiguous rows, a row stride
    assert _qmm_within(QM.qmm(x, view, sc[0]), QM.qmm_plain(x, view, sc[0]))


@pytest.mark.cuda
def test_qmm_kernel_raises_on_unsupported(cuda_device):
    x, wq, sc = _qmm_inputs(cuda_device, 4, 32, 64, seed=4)
    before = _launches()
    with pytest.raises(ValueError):  # f32 activations
        QM.qmm(x.float(), wq, sc)
    with pytest.raises(ValueError):  # a weight that is not int8
        QM.qmm(x, wq.to(torch.int16), sc)
    with pytest.raises(ValueError):  # I not a multiple of 16
        QM.qmm(x[:, :40].contiguous(), wq[:, :40].contiguous(), sc)
    with pytest.raises(ValueError):  # weight rows that are not contiguous
        QM.qmm(x[:, :32].contiguous(), wq[:, ::2], sc)
    with pytest.raises(ValueError):  # weight on the CPU
        QM.qmm(x, wq.cpu(), sc)
    with pytest.raises(ValueError):  # widths that differ
        QM.qmm(x, wq[:, :48].contiguous(), sc)
    with pytest.raises(ValueError):  # a split with no chunk to take
        QM.qmm(x, wq, sc, ksplit=2)
    x16, wq16, sc16 = _qmm_inputs(cuda_device, 4, 32, 2048, seed=5)
    with pytest.raises(ValueError):  # a cluster larger than the portable 8
        QM.qmm(x16, wq16, sc16, ksplit=9)
    assert _launches() == before


@pytest.mark.cuda
def test_mm_routes_by_the_weights_profile(cuda_device):
    """One weight, three profiles, live at once: W8A8 through the library's
    int8 product (no qmm launch), weight-only through the kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    w = torch.randn(128, 256, generator=g, device=cuda_device) * 0.05
    x = torch.randn(24, 256, generator=g, device=cuda_device).bfloat16()
    tree = {"w": w}
    a8 = T.quantize_weights(tree, min_size=1)["w"]
    a16 = T.quantize_weights(tree, min_size=1, w8a8=False)["w"]
    mixed = T.quantize_weights(tree, min_size=1, w8a8=["in_proj"])["w"]
    before = QM.qmm.launches
    y8 = T.mm(x, a8, site="mlp_in")
    assert QM.qmm.launches == before
    y16 = T.mm(x, a16, site="mlp_in")
    assert QM.qmm.launches == before + 1
    assert torch.equal(T.mm(x, mixed, site="in_proj"), y8)
    assert torch.equal(T.mm(x, mixed, site="mlp_in"), y16)
    assert QM.qmm.launches == before + 2
    want = x.float() @ w.T
    for y in (y8, y16):
        assert float((y.float() - want).norm() / want.norm()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("pos,frac", [(0, 1.0), (40, 0.8), (383, 1.0), (1000, 0.7)])
def test_decode_attend_commit_kernel_at_head_major_shapes(cuda_device, pos, frac):
    """h = 32, Dh = 64, C = 384 (stt-2.6b's ring): the fused commit the
    explicit ``fused_attn = True`` setting routes there."""
    b, h, c, dh, window = 4, 32, 384, 64, 375
    q, k_new, v_new, kc, vc, ks, vs, valid = _attn_inputs(cuda_device, b, h, c, dh, frac,
                                                          seed=pos, sharp=True)
    plan = A.global_ring_plan(pos, c, 1, device=cuda_device)
    assert not DA.fused_commit_supported(q, kc, plan)
    assert DA.fused_commit_supported(q, kc, plan, True)
    assert not DA.fused_commit_supported(q, kc, plan, False)
    kq, vq, _, _ = A.quantize_kv_rows(k_new, v_new)
    pk, pv = kc.clone(), vc.clone()
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    want = DA.decode_attend_commit_plain(rows[0], pk, pv, ks, vs, *rows[1:], valid, pos,
                                         plan["w"][0], window)
    before = DA.decode_attend_commit.launches
    y, rk, rv = DA.decode_attend_commit(q, kc, vc, ks, vs, kq, vq, k_new, v_new, plan,
                                        valid, window=window)
    torch.cuda.synchronize()
    assert DA.decode_attend_commit.launches == before + 1
    assert torch.equal(rk, pk) and torch.equal(rv, pv)
    assert _within(y[:, :, 0], want)


# ---------------------------------------------------------------------------
# The fused pipeline's kernel in its own span order (TPU kernels 2 and 7)
# ---------------------------------------------------------------------------


def _commit_inputs(dev, b, h, c, dh, pos, window, frac, seed):
    """:func:`_split_inputs` as a pre-commit ring (row ``w`` holds a stale row
    that would dominate if it were let in), with a fresh key aligned to the
    query (score about 12 against the oldest attended row's 14), so that
    dropping the fresh row moves the output past the bar as well.  Returns
    the operands, the quantised fresh rows and the oldest attended row."""
    args, oldest = _split_inputs(dev, b, h, c, dh, pos, window, frac, seed)
    q = args[0]
    qf = q[:, :, 0].float()
    k_new = (qf * (12.0 * dh ** 0.5 / (qf * qf).sum(-1, keepdim=True)))[:, :, None].bfloat16()
    args = (*args[:5], k_new, *args[6:])
    kq, vq, _, _ = A.quantize_kv_rows(k_new, args[6])
    return args, (kq, vq), oldest


def _commit_wrong_masks(valid, pos, c, window, oldest):
    """Masks a faulty kernel could apply -> (mask, fresh row in)."""
    ok = _true_mask(valid, pos, c, window)
    wrong = {"row w let in": (ok.clone(), True), "the fresh row dropped": (ok, False)}
    wrong["row w let in"][0][:, pos % c] = True
    if oldest is not None:
        wrong["the oldest row dropped"] = (ok.clone(), True)
        wrong["the oldest row dropped"][0][:, oldest] = False
    return ok, wrong


@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac,n_split", [
    (2, 8, 256, 128, 1000, 250, 0.6, 3), (2, 4, 768, 128, 40, 750, 0.9, 2),
    (1, 8, 384, 64, 3000, 375, 1.0, 1), (2, 4, 256, 64, 0, 250, 1.0, 2)])
def test_commit_check_inputs_see_a_wrong_mask(B, H, C, Dh, pos, window, frac, n_split):
    """On the card cases' inputs the 2e-2 bar fails a result that let row w
    in, dropped the oldest attended row or dropped the fresh row (the
    span-order plain version against an independent masked attention, CPU)."""
    args, (kq, vq), oldest = _commit_inputs(torch.device("cpu"), B, H, C, Dh, pos, window,
                                            frac, seed=pos + C)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    want = DA.decode_attend_commit_plain(rows[0], kc.clone(), vc.clone(), ks, vs, *rows[1:],
                                         valid, pos, pos % C, window, n_split)
    ok, wrong = _commit_wrong_masks(valid, pos, C, window, oldest)
    assert _within(_attend_with_mask(*args[:7], ok), want)
    for what, (mask, fresh) in wrong.items():
        assert not _within(_attend_with_mask(*args[:7], mask, fresh), want), what


COMMIT_CASES = [
    # B, H, C, Dh, pos, window, valid share, n_split (None: pick_split's)
    (64, 16, 768, 128, 3000, 750, 1.0, None),   # stt-1b, full: 2 spans, w in span 1
    (64, 16, 768, 128, 40, 750, 0.9, None),     # every attended row in span 0
    (64, 16, 768, 128, 1152, 750, 0.8, None),   # w = 384: span 1's first row
    (64, 32, 384, 64, 3000, 375, 1.0, None),    # stt-2.6b (fused_attn = True): 1 span
    (64, 32, 384, 64, 40, 375, 0.7, None),
    (64, 16, 1024, 128, 1023, 1024, 1.0, None),  # tts-1.6b: the first full ring
    (64, 16, 1024, 128, 5000, 1024, 0.7, None),  # ... wrapped, partial mask
    (2, 8, 256, 128, 1000, 250, 0.6, 3),        # spans of 88, 88 and 80 rows
    (4, 8, 256, 64, 0, 250, 1.0, 2),            # first step: the ring holds garbage
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac,n_split", COMMIT_CASES)
def test_decode_attend_commit_kernel_in_span_order(cuda_device, B, H, C, Dh, pos, window,
                                                   frac, n_split):
    """Three runs bit-identical, rings bit for bit, the output within 2e-2 of
    the plain version in the kernel's span order and in the whole-ring order,
    and the bar blind to none of the wrong masks."""
    args, (kq, vq), oldest = _commit_inputs(cuda_device, B, H, C, Dh, pos, window, frac,
                                            seed=pos + C)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    k0, v0 = kc.clone(), vc.clone()
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    split = DA.pick_split(B * H, C) if n_split is None else n_split
    rows = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
    before = DA.decode_attend_commit.launches
    runs = [DA._launch(rows[0], kc, vc, ks, vs, *rows[1:], valid, plan["pos"], window,
                       split) for _ in range(3)]
    torch.cuda.synchronize()
    assert DA.decode_attend_commit.launches == before + 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    pk, pv, wk, wv = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    want = DA.decode_attend_commit_plain(rows[0], pk, pv, ks, vs, *rows[1:], valid, pos,
                                         pos % C, window, split)
    whole = DA.decode_attend_commit_plain(rows[0], wk, wv, ks, vs, *rows[1:], valid, pos,
                                          pos % C, window)
    assert torch.equal(kc, pk) and torch.equal(vc, pv) and torch.equal(kc, wk)
    assert _within(runs[0], want) and _within(runs[0], whole)
    _, wrong = _commit_wrong_masks(valid, pos, C, window, oldest)
    for what, (mask, fresh) in wrong.items():
        assert not _within(_attend_with_mask(q, k0, v0, ks, vs, k_new, v_new, mask, fresh),
                           want), what
    if n_split is None:  # the wrapper launches the same kernel at pick_split's split
        y, _, _ = DA.decode_attend_commit(q, k0, v0, ks, vs, kq, vq, k_new, v_new, plan,
                                          valid, window=window)
        torch.cuda.synchronize()
        assert torch.equal(y[:, :, 0], runs[0]) and torch.equal(k0, pk)


@pytest.mark.cuda
def test_decode_attend_commit_takes_long_spans_and_raises_on_unsupported(cuda_device):
    before = _launches()
    q, k_new, v_new, kc, vc, ks, vs, valid = _attn_inputs(cuda_device, 2, 8, 256, 64, 1.0, 0)
    kq, vq, _, _ = A.quantize_kv_rows(k_new, v_new)
    plan = A.global_ring_plan(7, 256, 1, device=cuda_device)
    with pytest.raises(ValueError):  # a ring of 254 rows: not a multiple of 4
        kc2, vc2, ks2, vs2, valid2 = (x[..., :254].contiguous() if x.dim() < 4 else
                                      x[:, :, :254].contiguous()
                                      for x in (kc, vc, ks, vs, valid))
        DA.decode_attend_commit(q, kc2, vc2, ks2, vs2, kq, vq, k_new, v_new,
                                A.global_ring_plan(7, 254, 1, device=cuda_device), valid2,
                                window=250)
    with pytest.raises(ValueError):  # Dh = 96
        z = torch.zeros(2, 8, 1, 96, dtype=torch.bfloat16, device=cuda_device)
        r = torch.zeros(2, 8, 256, 96, dtype=torch.int8, device=cuda_device)
        DA.decode_attend_commit(z, r, r.clone(), ks, vs, r[:, :, :1], r[:, :, :1], z, z, plan,
                                valid, window=250)
    with pytest.raises(ValueError):  # a ring that is not contiguous
        DA.decode_attend_commit(q, kc.transpose(0, 1).contiguous().transpose(0, 1), vc, ks,
                                vs, kq, vq, k_new, v_new, plan, valid, window=250)
    rows = [x[:1, :1, 0] for x in (q, kq, vq, k_new, v_new)]
    for c, raises in ((16384, False), (60000, True)):  # a span's scores in shared memory
        ring = torch.zeros(1, 1, c, 64, dtype=torch.int8, device=cuda_device)
        sc = torch.ones(1, 1, c, device=cuda_device)
        args = (rows[0], ring, ring.clone(), sc, sc.clone(), *rows[1:],
                torch.ones(1, c, dtype=torch.bool, device=cuda_device),
                tick(c + 5, cuda_device), c - 4, 1)
        if raises:
            with pytest.raises(ValueError):  # beyond the opt-in limit of a block
                DA._launch(*args)
        else:  # beyond the 48 KB a block gets without the opt-in
            y = DA._launch(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y).all())
    assert _launches()[:2] == before[:2] and _launches()[3:] == before[3:]
    assert DA.decode_attend_commit.launches == before[2] + 1


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_engines_default_to_the_card():
    """The STT and TTS engines, like the duplex engines and the JAX engines,
    land on the accelerator unless the caller names the CPU."""
    import inspect

    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.server.tts_batched import BatchedTtsEngine

    for cls in (BatchedAsrEngine, BatchedTtsEngine):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"


@pytest.mark.cuda
def test_engines_built_without_a_device_land_on_the_card(cuda_device):
    """An STT and a TTS engine built with no ``device`` hold their state on
    CUDA (small models: the smoke TOML, the TTS serving TOML narrowed)."""
    import tomllib

    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.server.tts_batched import BatchedTtsEngine

    built = B.build_batched_asr(CFG.Config.load("configs/config-smoke.toml").modules["asr"],
                                cuda_device)
    eng = BatchedAsrEngine(built.cfg, built.params, batch_size=built.batch_size)
    assert eng.device.type == "cuda"
    assert all(t.is_cuda for t in _tensors(eng.state))
    del built, eng
    with open("configs/config-tts-tpu-serving.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["tts"]
    mod.update(batch_size=2, fuse_ticks=1, pipeline_depth=1)
    mod["model"]["transformer"].update(d_model=64, num_heads=8, num_layers=2,
                                       dim_feedforward=128, context=64)
    mod["model"]["depformer"].update(num_slices=8)
    mod["model"]["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                    dim_feedforward=64, context=8)
    mod["model"].update(audio_codebooks=8)
    mod["generation"].update(speaker_cond_dim=16, speaker_cond_n_speakers=1)
    built = B.build_batched_tts(CFG.Config.from_dict(raw).modules["tts"], cuda_device)
    eng = BatchedTtsEngine(built.cfg, built.params, built.mimi_cfg, built.mimi_params,
                           built.tokenizer, batch_size=2)
    assert eng.device.type == "cuda"
    assert all(t.is_cuda for t in _tensors(eng.state))


@pytest.mark.cuda
def test_build_duplex_takes_int8_rings_on_the_card_by_default(cuda_device):
    """Without ``kv_quant`` in the TOML the dialogue engine on CUDA gets int8
    rings and int8 weights, as the JAX builder's engine does on an
    accelerator; ``kv_quant = false`` still turns them off."""
    import tomllib

    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG

    with open("configs/config-duplex-tpu-serving.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["duplex"]
    mod.update(batch_size=2, pipeline_depth=1)
    del mod["kv_quant"]
    mod["model"].update(audio_codebooks=8, text_in_vocab_size=301, text_out_vocab_size=300)
    mod["model"]["transformer"].update(d_model=128, num_heads=4, num_layers=2,
                                       dim_feedforward=512, context=40)
    mod["model"]["depformer"].update(num_slices=4)
    mod["model"]["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                    dim_feedforward=64, context=4)
    mod["generation"].update(generated_audio_codebooks=4, input_audio_codebooks=4)
    eng = B.build_duplex(CFG.Config.from_dict(raw).modules["duplex"], cuda_device)
    assert eng.kv_quant and eng.state["lm"]["t"]["layers"][0]["k"].dtype == torch.int8
    assert isinstance(eng.params["lm"]["transformer"][0]["in_proj_w"], dict)
    mod["kv_quant"] = False
    eng = B.build_duplex(CFG.Config.from_dict(raw).modules["duplex"], cuda_device)
    assert not eng.kv_quant
    assert eng.state["lm"]["t"]["layers"][0]["k"].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("fused_attn,want", [
    (None, {"rope_qk": 2, "quantize_commit": 2, "decode_attend": 2}),
    (True, {"rope_qk": 2, "quantize_scale_commit": 2, "decode_attend_commit": 2}),
    (False, {"rope_qk": 2, "quantize_commit": 2, "decode_attend": 2})])
def test_step_routes_head_major_rings_by_the_setting(cuda_device, fused_attn, want):
    """``transformer.step`` at h = 8, Dh = 64 with weight-only int8 weights:
    the launches follow ``fused_attn``, every layer rotates q and k in one
    ``rope_qk`` launch, every matmul goes through qmm, and the three settings
    agree."""
    cfg = T.TransformerConfig(d_model=512, num_heads=8, num_layers=2, dim_feedforward=2048,
                              context=250, fused_attn=fused_attn)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.quantize_weights(T.init(cfg, gen, dtype=torch.bfloat16), min_size=1,
                                w8a8=False)
    state = T.init_state(cfg, 3, kv_quant=True, device=cuda_device)
    ref_cfg = T.TransformerConfig(d_model=512, num_heads=8, num_layers=2,
                                  dim_feedforward=2048, context=250)
    ref_state = T.init_state(ref_cfg, 3, kv_quant=True, device=cuda_device)
    counters = {"ring_commit_q": RK.ring_commit_q, "decode_attend": DA.decode_attend,
                "scale_commit": RK.scale_commit,
                "decode_attend_commit": DA.decode_attend_commit, "qmm": QM.qmm,
                "quantize_commit": RK.quantize_commit,
                "quantize_scale_commit": RK.quantize_scale_commit, "rope_qk": RK.rope_qk,
                "rope_commit": RK.rope_commit, "ring_commit": RK.ring_commit}
    for step in range(3):
        x = (torch.randn(3, 1, 512, generator=gen, device=cuda_device) * 0.3).bfloat16()
        y_ref, ref_state = T.step(ref_cfg, params, ref_state, x)
        before = {k: f.launches for k, f in counters.items()}
        y, state = T.step(cfg, params, state, x)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        assert got.pop("qmm") == 8  # 4 matmuls a layer
        assert {k: v for k, v in got.items() if v} == want
        assert _within(y, y_ref)
    for key in ("k", "v", "ks", "vs"):
        assert torch.equal(state["layers"][0][key], ref_state["layers"][0][key])


# ---------------------------------------------------------------------------
# Packed-int4 rings (kv_bits = 4): kernels 11 and 12, and the uint8 commit
# ---------------------------------------------------------------------------


def _pack4_independent(vals):
    """int4 values (B, H, C, Dh) -> packed bytes, written apart from the
    port's ``pack4``: byte d = (vals[d] + 8) + 16 * (vals[d + Dh/2] + 8)."""
    half = vals.shape[-1] // 2
    return ((vals[..., :half] + 8) + 16 * (vals[..., half:] + 8)).to(torch.uint8)


def _split_inputs_q4(dev, b, h, c, dh, pos, window, valid_frac, seed):
    """:func:`_split_inputs` for a packed-int4 ring: values in [-7, 7], scales
    18 times the int8 ones (the same score spread and O(1) outputs).  Returns
    the kernel's operands, the unpacked K and V values, and the oldest
    attended row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).bfloat16()
                       for _ in range(3))
    kv, vv = (torch.randint(-7, 8, (b, h, c, dh), generator=g, device=dev, dtype=torch.int32)
              for _ in range(2))
    ks, vs = (18.0 * x for x in _sharp_scales(g, dev, b, h, c))
    valid = torch.rand(b, c, generator=g, device=dev) < valid_frac
    w = pos % c
    qf = q[:, :, 0].float()
    aligned = torch.where(qf >= 0, 7, -7).to(torch.int32)
    per_scale = 7.0 * qf.abs().sum(-1) / dh ** 0.5  # score per unit k_scale
    kv[:, :, w] = aligned
    ks[:, :, w] = 26.0 / per_scale
    vv[:, :, w] = 7
    vs[:, :, w] = 18.0
    valid[:, w] = True
    d_max = min(pos, window - 1, c - 1)
    oldest = None
    if d_max >= 1:
        oldest = (w - d_max) % c
        kv[:, :, oldest] = aligned
        ks[:, :, oldest] = 14.0 / per_scale
        valid[:, oldest] = True
    args = (q, _pack4_independent(kv), _pack4_independent(vv), ks, vs, k_new, v_new, valid)
    return args, (kv, vv), oldest


def _swap_nibbles(p):
    return (p >> 4) | ((p & 15) << 4)


@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac", [
    (2, 16, 256, 128, 40, 250, 0.7), (2, 8, 256, 64, 1000, 250, 0.6),
    (1, 8, 512, 64, 511, 512, 1.0), (2, 4, 256, 128, 0, 250, 1.0)])
def test_int4_check_inputs_see_a_wrong_mask_and_swapped_nibbles(B, H, C, Dh, pos, window, frac):
    """On the card cases' int4 inputs the 2e-2 bar fails a result that
    dropped the oldest attended row, let ring row w in, let every ring row
    in, or read the nibble halves the other way round (plain version against
    an independent masked attention over the unpacked values, CPU)."""
    dev = torch.device("cpu")
    args, (kv, vv), oldest = _split_inputs_q4(dev, B, H, C, Dh, pos, window, frac, pos + C)
    valid = args[7]
    assert torch.equal(A.unpack4(args[1]), kv.float()) and torch.equal(A.pack4(vv), args[2])
    plan = A.global_ring_plan(pos, C, 1)
    want = DA.decode_attend(*args[:7], plan, valid, window=window, n_split=1)[:, :, 0]
    ok = _true_mask(valid, pos, C, window)
    ref = (args[0], kv, vv, *args[3:7])
    assert _within(_attend_with_mask(*ref, ok), want)
    for n_split in (2, 3):
        assert _within(DA.decode_attend(*args[:7], plan, valid, window=window,
                                        n_split=n_split)[:, :, 0], want)
    wrong = {"row w let in": ok.clone(), "every row let in": torch.ones_like(ok)}
    wrong["row w let in"][:, pos % C] = True
    if oldest is not None:
        assert want.float().abs().max() > 0.3
        wrong["oldest row dropped"] = ok.clone()
        wrong["oldest row dropped"][:, oldest] = False
        for which in (1, 2):
            swapped = list(args[:7])
            swapped[which] = _swap_nibbles(swapped[which])
            bad = DA.decode_attend(*swapped, plan, valid, window=window, n_split=1)[:, :, 0]
            assert not _within(bad, want), f"swapped nibbles of operand {which}"
    for what, mask in wrong.items():
        assert not _within(_attend_with_mask(*ref, mask), want), what


INT4_CASES = [
    # B, H, C, Dh, pos, window, valid share
    (64, 16, 768, 128, 40, 750, 0.9),       # stt-1b rings, 4-D (kernel 11): short
    (64, 16, 768, 128, 767, 750, 1.0),      # full
    (64, 16, 768, 128, 3000, 750, 0.8),     # wrapped
    (64, 32, 384, 64, 0, 375, 1.0),         # stt-2.6b rings (kernel 12): garbage ring
    (64, 32, 384, 64, 383, 375, 1.0),
    (64, 32, 384, 64, 3000, 375, 0.7),
    (24, 20, 3072, 128, 40, 3000, 0.7),     # s2s-2b rings: no JAX kernel serves them
    (24, 20, 3072, 128, 10000, 3000, 1.0),
    # Attended rows that start past a tile's first 128 rows (stt-2.6b: rows
    # 184..382 of its one 384-row tile) or mid-tile and end mid-tile: only
    # those rows are copied and taken.
    (64, 32, 384, 64, 383, 200, 1.0),
    (24, 20, 3072, 128, 2000, 300, 0.9),
    (1, 20, 3072, 128, 10000, 3000, 1.0),   # one s2s-2b stream: the pick splits it
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, None, 5])
@pytest.mark.parametrize("B,H,C,Dh,pos,window,frac", INT4_CASES)
def test_decode_attend_int4_kernel_matches_plain(cuda_device, B, H, C, Dh, pos, window, frac,
                                                 n_split):
    """At one span (the fresh row folded in the kernel's one launch), at the
    packed pick (one span at the serving rings, 12 for one s2s-2b stream)
    and at five spans (the fold kernel).  The stt-1b and s2s-2b spans hold
    several tiles; at the stt-2.6b rings (2,048 items) every persistent
    block takes more than one (b, h, span)."""
    args, (kv, vv), oldest = _split_inputs_q4(cuda_device, B, H, C, Dh, pos, window, frac,
                                              seed=pos + C)
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    valid = args[7]
    assert args[1].dtype == torch.uint8 and args[1].shape == (B, H, C, Dh // 2)
    assert DA.supported(args[0], args[1], plan)
    before = DA.decode_attend.launches
    runs = [DA.decode_attend(*args[:7], plan, valid, window=window, n_split=n_split)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert DA.decode_attend.launches == before + 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    y = runs[0][:, :, 0]
    split = DA.card_split(B * H, C, Dh, True, cuda_device) if n_split is None else n_split
    rows = [x[:, :, 0].contiguous() for x in (args[0], args[5], args[6])]
    yp = DA.decode_attend_plain(rows[0], *args[1:5], rows[1], rows[2], valid, pos,
                                plan["w"][0], window, split)
    np.testing.assert_allclose(y.float().cpu().numpy(), yp.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    ref = _attend_with_mask(args[0], kv, vv, *args[3:7], _true_mask(valid, pos, C, window))
    assert _within(ref, y)
    if oldest is None:  # only the fresh row attends: the zero bytes (-8) are never read
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   args[6][:, :, 0].float().cpu().numpy(), atol=2e-2, rtol=2e-2)
    else:
        swapped = DA.decode_attend(args[0], _swap_nibbles(args[1]), *args[2:7], plan, valid,
                                   window=window, n_split=n_split)[:, :, 0]
        assert not _within(swapped, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh", [(64, 32, 384, 64), (24, 20, 3072, 128)])
def test_decode_attend_int4_is_one_launch_and_allocates_only_its_output(cuda_device, B, H, C,
                                                                        Dh):
    """At one span: one kernel on the device a call (the fresh row folded in
    it, no combine launch) and no memory but the output, at the peak too (no
    partials' scratch)."""
    args, _, _ = _split_inputs_q4(cuda_device, B, H, C, Dh, 3000, C - 4, 1.0, seed=3)
    plan = A.global_ring_plan(3000, C, 1, device=cuda_device)
    assert DA.card_split(B * H, C, Dh, True, cuda_device) == 1

    def call():
        return DA.decode_attend(*args[:7], plan, args[7], window=C - 4)

    call()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = call()
    torch.cuda.synchronize()
    out_bytes = -(-y.numel() * y.element_size() // 512) * 512  # the allocator's blocks
    assert torch.cuda.memory_allocated() - base == out_bytes
    assert torch.cuda.max_memory_allocated() - base == out_bytes
    del y
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0}
    assert len(kernels) == 1 and "decode_attend_q4_kernel" in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 3


@pytest.mark.cuda
def test_decode_attend_int4_kernel_takes_head_major_strides(cuda_device):
    """A (B*H, C, Dh/2) packed ring addressed as (1, B*H, C, Dh/2): the
    layout of the JAX package's head-major kernel, the same launch."""
    args, _, _ = _split_inputs_q4(cuda_device, 2, 32, 384, 64, 1000, 375, 0.9, seed=5)
    q, kc, vc, ks, vs, k_new, v_new, valid = args
    plan = A.global_ring_plan(1000, 384, 1, device=cuda_device)
    want = DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new, plan, valid, window=375)
    k_t, v_t = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (kc, vc))
    ks_t, vs_t = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (ks, vs))
    assert not k_t.is_contiguous()
    got = DA.decode_attend(q, k_t, v_t, ks_t, vs_t, k_new, v_new, plan, valid, window=375)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,w", [
    (64, 16, 768, 128, 0), (64, 16, 768, 128, 767), (64, 32, 384, 64, 100),
    (24, 20, 3072, 128, 1500)])
def test_ring_commit_q_kernel_takes_uint8_rows(cuda_device, B, H, C, Dh, w):
    g = torch.Generator(device=cuda_device).manual_seed(w)
    kc, vc, kn, vn = (torch.randint(0, 256, shape, generator=g, device=cuda_device,
                                    dtype=torch.uint8)
                      for shape in ((B, H, C, Dh // 2),) * 2 + ((B, H, 1, Dh // 2),) * 2)
    ks, vs, ksn, vsn = (torch.rand(*shape, generator=g, device=cuda_device)
                        for shape in ((B, H, C),) * 2 + ((B, H, 1),) * 2)
    orig = kc.clone()
    plain = [x.clone() for x in (kc, vc, ks, vs)]
    before = RK.ring_commit_q.launches
    RK.ring_commit(kc, vc, kn, vn, tick(w, cuda_device), ks, vs, ksn, vsn)
    RK.ring_commit_plain(plain[0], plain[1], kn, vn, w, plain[2], plain[3], ksn, vsn)
    torch.cuda.synchronize()
    assert RK.ring_commit_q.launches == before + 1
    for got, want in zip((kc, vc, ks, vs), plain):
        assert torch.equal(got, want)
    keep = torch.ones(C, dtype=torch.bool, device=cuda_device)
    keep[w] = False
    assert torch.equal(kc[:, :, w], kn[:, :, 0]) and torch.equal(kc[:, :, keep], orig[:, :, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("heads,head_dim,fused_attn", [(8, 128, None), (8, 64, True)])
def test_step_with_int4_rings_on_the_card(cuda_device, monkeypatch, heads, head_dim,
                                          fused_attn):
    """``transformer.step`` over packed rings: quantize_commit + decode_attend
    in every layer, never the fused pipeline nor ring_commit_q; against the
    same steps through the plain versions on the card."""
    cfg = T.TransformerConfig(d_model=heads * head_dim, num_heads=heads, num_layers=2,
                              dim_feedforward=256, context=250, fused_attn=fused_attn)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init(cfg, gen, torch.bfloat16)
    st = T.init_state(cfg, 4, kv_quant=True, device=cuda_device, kv_bits=4)
    ref = T.init_state(cfg, 4, kv_quant=True, device=cuda_device, kv_bits=4)
    xs = [(torch.randn(4, 1, cfg.d_model, generator=gen, device=cuda_device) * 0.3).bfloat16()
          for _ in range(5)]
    before = _launches()
    ys = []
    for x in xs:
        y, st = T.step(cfg, params, st, x)
        ys.append(y)
    torch.cuda.synchronize()
    after = _launches()
    assert after[8] - before[8] == 10 and after[5] - before[5] == 10  # the split pipeline
    assert after[4] == before[4]  # the rows are quantised in the commit
    assert after[1] == before[1] and after[2] == before[2] and after[9] == before[9]
    assert after[11] - before[11] == 10  # the rope: one launch a layer
    wrapper = RK.quantize_commit
    # The seam takes (..., pos, window, n_split), the plain version w = pos % C too.
    monkeypatch.setattr(DA, "_attend_launch", lambda *a: DA.decode_attend_plain(
        *a[:-2], a[-3] % a[1].shape[2], *a[-2:]))
    monkeypatch.setattr(RK, "quantize_commit", RK.quantize_commit_plain)
    monkeypatch.setattr(RK, "rope_qk", RK.rope_qk_plain)
    for x, y in zip(xs, ys):
        yr, ref = T.step(cfg, params, ref, x)
        np.testing.assert_allclose(y.float().cpu().numpy(), yr.float().cpu().numpy(),
                                   atol=5e-2, rtol=5e-2)
    assert wrapper.launches == after[8]  # the reference launched nothing
    assert st["layers"][0]["k"].dtype == torch.uint8
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input on both routes
        assert torch.equal(st["layers"][0][key], ref["layers"][0][key])


# ---------------------------------------------------------------------------
# The tuning tool's kernel (kernel 14)
# ---------------------------------------------------------------------------

TUNE_VARIANTS = [dict(bb=1), dict(bb=4), dict(bb=1, i8s=True), dict(bb=4, i8s=True, i8p=True),
                 dict(bb=2, i8p=True)]
# Each variant against its own plain version: the bf16 variants as every
# attention kernel; the s32 dots are exact, so the int8-dot variants differ
# from theirs by summation order and a quantisation step where x / scale
# lands on a rounding boundary.
TUNE_BAR = 2e-2
I8_FROM_BF16 = AT.I8_FROM_BF16  # the int8-dot variants against the bf16 result


def _tune_inputs(dev, b, h, c, dh, pos, window, valid_frac, seed):
    """:func:`_split_inputs` with a fresh row that matters as well: k_new lies
    along q (score 13, beside the oldest attended row's 14) and v_new is of
    spread 1.5.  Returns attn_tune's operands (3-D rows), the 4-D operands of
    the independent attention, and the oldest attended row."""
    args4, oldest = _split_inputs(dev, b, h, c, dh, pos, window, valid_frac, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    qf = args4[0].float()
    k_new = (qf * (13.0 * dh ** 0.5 / (qf * qf).sum(-1, keepdim=True))).bfloat16()
    v_new = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 1.5).bfloat16()
    args4 = (*args4[:5], k_new, v_new, args4[7])
    rows = [x[:, :, 0].contiguous() for x in (args4[0], k_new, v_new)]
    return (rows[0], *args4[1:5], rows[1], rows[2], args4[7]), args4, oldest


def _tune_wrong_masks(valid, pos, c, window, oldest):
    """(mask, fresh row kept) of results a kernel with a wrong mask would give."""
    ok = _true_mask(valid, pos, c, window)
    wrong = {"row w let in": (ok.clone(), True), "oldest row dropped": (ok.clone(), True),
             "every row let in": (torch.ones_like(ok), True), "fresh row dropped": (ok, False)}
    wrong["row w let in"][0][:, pos % c] = True
    wrong["oldest row dropped"][0][:, oldest] = False
    return wrong


@pytest.mark.parametrize("kw", TUNE_VARIANTS, ids=str)
def test_attn_tune_plain_variants_are_near_the_bf16_result(kw):
    """Also: on the card cases' inputs the outputs are O(1) and the bar fails
    every wrong mask against each variant's plain version."""
    args, args4, oldest = _tune_inputs(torch.device("cpu"), 4, 8, 256, 128, 300, 250, 0.9, seed=1)
    base = AT.attn_tune(*args, 300, 250)
    got = AT.attn_tune(*args, 300, 250, **kw)
    assert got.shape == (4, 8, 128) and got.dtype == torch.bfloat16
    assert float(base.float().abs().max()) > 0.3
    if not (kw.get("i8s") or kw.get("i8p")):
        assert torch.equal(got, base)
    err = float((got.float() - base.float()).abs().max())
    assert err <= I8_FROM_BF16 * float(base.float().abs().max()), err
    assert _within(_attend_with_mask(*args4[:7], _true_mask(args[7], 300, 256, 250)), base)
    for what, (mask, fresh) in _tune_wrong_masks(args[7], 300, 256, 250, oldest).items():
        assert not _within(_attend_with_mask(*args4[:7], mask, fresh), got), what
    plan = A.global_ring_plan(300, 256, 1)
    split = DA.decode_attend(*args4[:7], plan, args[7], window=250, n_split=1)
    np.testing.assert_allclose(base.float().numpy(), split[:, :, 0].float().numpy(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="bb"):
        AT.attn_tune(*args, 300, 250, bb=3)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [5, 767, 3000])
@pytest.mark.parametrize("B,H,C,Dh", [(64, 16, 768, 128), (8, 8, 256, 64)])
def test_attn_tune_kernel_matches_plain(cuda_device, B, H, C, Dh, pos):
    window = C - 18
    args, args4, oldest = _tune_inputs(cuda_device, B, H, C, Dh, pos, window, 0.9, seed=pos)
    outs = {}
    before = AT.attn_tune.launches
    for kw in TUNE_VARIANTS:
        runs = [AT.attn_tune(*args, pos, window, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
        want = AT.attn_tune_plain(*args, pos, window, **kw)
        np.testing.assert_allclose(runs[0].float().cpu().numpy(), want.float().cpu().numpy(),
                                   atol=TUNE_BAR, rtol=TUNE_BAR)
        for what, (mask, fresh) in _tune_wrong_masks(args[7], pos, C, window, oldest).items():
            assert not _within(_attend_with_mask(*args4[:7], mask, fresh), runs[0]), (kw, what)
        outs[str(kw)] = runs[0]
    assert AT.attn_tune.launches == before + 3 * len(TUNE_VARIANTS)
    base = outs[str(dict(bb=1))]
    assert torch.equal(outs[str(dict(bb=4))], base)  # bb changes no number
    scale = float(base.float().abs().max())
    assert scale > 0.3
    for key, y in outs.items():
        assert float((y.float() - base.float()).abs().max()) <= I8_FROM_BF16 * scale, key
    plan = A.global_ring_plan(pos, C, 1, device=cuda_device)
    split = DA.decode_attend(*args4[:7], plan, args[7], window=window)
    np.testing.assert_allclose(base.float().cpu().numpy(), split[:, :, 0].float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_attn_tune_kernel_raises_on_unsupported(cuda_device):
    args = _tune_inputs(cuda_device, 4, 8, 256, 128, 300, 250, 0.9, seed=0)[0]
    before = AT.attn_tune.launches
    with pytest.raises(ValueError, match="bb"):
        AT.attn_tune(*args, 300, 250, bb=3)
    with pytest.raises(ValueError):  # f32 queries
        AT.attn_tune(args[0].float(), *args[1:], 300, 250)
    with pytest.raises(ValueError):  # a packed ring is not this kernel's
        AT.attn_tune(args[0], args[1].to(torch.uint8), *args[2:], 300, 250)
    assert AT.attn_tune.launches == before


# ---------------------------------------------------------------------------
# The division of the scales: a CUDA tensor over a Python number
# ---------------------------------------------------------------------------


def _reciprocal_misses(qmax, lo, hi, n, bf16=False):
    """``n`` amaxes in [lo, hi) where ``amax * fl(1/qmax)`` and ``amax /
    qmax`` differ in f32 (bf16-exact ones with ``bf16``, which repeat: a few
    dozen of the bf16 values there miss): a scale taken by the reciprocal
    fails a bit-for-bit check on each of them."""
    rng = np.random.default_rng(int(qmax))
    a = rng.uniform(lo, hi, 200_000).astype(np.float32)
    if bf16:
        a = torch.from_numpy(a).bfloat16().float().numpy()
    miss = a * np.float32(1.0 / qmax) != a / np.float32(qmax)
    a = rng.permutation(np.unique(a[miss]))
    assert len(a) >= 8
    return np.resize(a, n)


def _rows_on_misses(qmax, b, h, dh, seed, bf16=False):
    """Rows ``(B, H, 1, Dh)`` f32 of unit spread, each row's amax one of
    :func:`_reciprocal_misses` at a random place and sign."""
    rng = np.random.default_rng(seed)
    amax = _reciprocal_misses(qmax, 0.5, 4.0, b * h, bf16)
    x = rng.uniform(-0.45, 0.45, (b * h, dh)).astype(np.float32) * amax[:, None]
    at = rng.integers(0, dh, b * h)
    x[np.arange(b * h), at] = amax * rng.choice([-1.0, 1.0], b * h).astype(np.float32)
    x = torch.from_numpy(x.reshape(b, h, 1, dh))
    return x.bfloat16().float() if bf16 else x


def _same_bits(a, b):
    """Bit for bit, a NaN equal to a NaN."""
    return _differ(a, b) == 0


def _differ(a, b) -> int:
    """How many elements differ (a NaN equal to a NaN; any other dtype or
    shape: all of them)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.is_floating_point():
        return int((a.nan_to_num() != b.nan_to_num()).sum() + (a.isnan() != b.isnan()).sum())
    return int((a != b).sum())


@pytest.mark.cuda
def test_scales_divide_on_the_card_as_on_the_cpu(cuda_device):
    """The five quantisations that take a scale as max|x| over 127 or 7 give
    the same scales and integers on the card as on the CPU, bit for bit, on
    rows whose amaxes a reciprocal would miss: the KV rows, the packed KV
    rows, ``mm_w8a8``'s activations and the voice source multiply by fl(1/127)
    or fl(1/7), as the jitted JAX step does (``attention.mul_recip``); the
    weights divide, as the JAX package's numpy does (``div_ieee``).  A
    failure names each output that differs and in how many of its
    elements."""
    cpu = torch.device("cpu")
    pairs = {}  # what -> (card, cpu)
    for bf16 in (False, True):
        k, v = (_rows_on_misses(127.0, 8, 16, 128, seed, bf16) for seed in (1, 2))
        k4, v4 = (_rows_on_misses(7.0, 8, 16, 128, seed, bf16) for seed in (3, 4))
        if bf16:
            k, v, k4, v4 = (x.bfloat16() for x in (k, v, k4, v4))
        for fn, args in ((A.quantize_kv_rows, (k, v)), (A.quantize_kv_rows_packed4, (k4, v4))):
            want = fn(*(x.to(cpu) for x in args))
            got = fn(*(x.to(cuda_device) for x in args))
            for what, g, w in zip(("kq", "vq", "ks", "vs"), got, want):
                pairs[f"{fn.__name__} {what} {'bf16' if bf16 else 'f32'}"] = (g, w)
    x = _rows_on_misses(127.0, 48, 1, 256, 5).reshape(48, 256)
    wq = torch.randint(-127, 128, (64, 256), generator=torch.Generator().manual_seed(6),
                       dtype=torch.int8)
    s = torch.rand(64, generator=torch.Generator().manual_seed(7)) * 1e-2
    pairs["mm_w8a8 output (f32)"] = (
        QM.mm_w8a8(x.to(cuda_device), wq.to(cuda_device), s.to(cuda_device)),
        QM.mm_w8a8(x, wq, s))
    src = _rows_on_misses(127.0, 2 * 4, 2, 64, 8).reshape(2, 4, 2, 1, 64).expand(
        2, 4, 2, 3, 64).contiguous()
    want = T.quantize_ca_kv((src, -src))
    got = T.quantize_ca_kv((src.to(cuda_device), -src.to(cuda_device)))
    for key in ("k", "v", "ks", "vs"):
        pairs[f"quantize_ca_kv {key}"] = (got[key], want[key])
    w = _rows_on_misses(127.0, 64, 1, 256, 9).reshape(64, 256)
    want = T.quantize_weights({"w": w}, min_size=1)["w"]
    got = T.quantize_weights({"w": w.to(cuda_device)}, min_size=1)["w"]
    for key in ("q", "s"):
        pairs[f"quantize_weights {key}"] = (got[key], want[key])
    differ = {what: f"{_differ(g, w)} of {w.numel()}" for what, (g, w) in pairs.items()
              if _differ(g, w)}
    assert not differ, f"the card differs from the CPU: {differ}"


# ---------------------------------------------------------------------------
# Quantise and commit (TPU kernels 4 and 1 on the step's path)
# ---------------------------------------------------------------------------


def _fresh_rows(dev, b, h, dh, qmax, seed, k_strided=False):
    """The step's fresh K and V rows ``(B, H, 1, Dh)``: V (and K with
    ``k_strided``) a strided view of a QKV product ``(B, 1, 3, H, Dh)``, as
    ``transformer._qkv`` gives it, K otherwise contiguous, as after the
    rotary embedding.  Amaxes a reciprocal would miss; in each of K and V a
    row of ties (amax ``qmax``: scale 1, values k + 0.5), a row at +-amax,
    an all-zero row and a row holding a NaN."""
    rows = []
    for i in range(2):
        x = _rows_on_misses(qmax, b, h, dh, seed + i, bf16=True).reshape(b * h, dh)
        x[0] = 0.0
        x[1] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -3.5]).repeat(dh)[:dh]
        x[1, 5] = qmax
        a = x[2].abs().max()
        x[2, ::2], x[2, 1::2] = a, -a
        x[3, dh // 3] = float("nan")
        rows.append(x.reshape(b, h, 1, dh).bfloat16())
    qkv = torch.zeros(b, 1, 3, h, dh, dtype=torch.bfloat16)
    qkv[:, 0, 1], qkv[:, 0, 2] = rows[0][:, :, 0], rows[1][:, :, 0]
    qkv = qkv.to(dev)
    v = qkv[:, :, 2].transpose(1, 2)
    k = qkv[:, :, 1].transpose(1, 2) if k_strided else rows[0].to(dev)
    assert not v.is_contiguous() and k.is_contiguous() != k_strided
    return k, v


def _rings(dev, b, h, c, row_bytes, packed4, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lo, hi, dt = (0, 256, torch.uint8) if packed4 else (-127, 128, torch.int8)
    kc, vc = (torch.randint(lo, hi, (b, h, c, row_bytes), generator=g, device=dev, dtype=dt)
              for _ in range(2))
    ks, vs = (torch.rand(b, h, c, generator=g, device=dev) for _ in range(2))
    return [kc, vc, ks, vs]


QUANT_COMMIT_CASES = [  # (B, H, C, Dh, packed4): the split route's serving rings
    (64, 16, 768, 128, False), (64, 32, 384, 64, False), (24, 20, 3072, 128, False),
    (64, 16, 768, 128, True), (64, 32, 384, 64, True), (24, 20, 3072, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh,packed4", QUANT_COMMIT_CASES)
def test_quantize_commit_kernel_matches_plain(cuda_device, B, H, C, Dh, packed4):
    """At w = 0, mid and C - 1: three kernel runs and the plain version write
    the same four rings bit for bit, every row but w as it was; one launch a
    call, no ``ring_commit_q``."""
    k, v = _fresh_rows(cuda_device, B, H, Dh, 7.0 if packed4 else 127.0, seed=C)
    orig = _rings(cuda_device, B, H, C, Dh // 2 if packed4 else Dh, packed4, seed=C)
    for w in (0, C // 2, C - 1):
        plain = [x.clone() for x in orig]
        RK.quantize_commit_plain(k, v, *plain, w)
        before = _launches()
        for _ in range(3):
            kern = [x.clone() for x in orig]
            RK.quantize_commit(k, v, *kern, tick(w, cuda_device))
            torch.cuda.synchronize()
            for got, want in zip(kern, plain):
                assert _same_bits(got, want)
        after = _launches()
        assert after[8] - before[8] == 3 and after[:8] == before[:8] and after[9] == before[9]
        keep = torch.ones(C, dtype=torch.bool, device=cuda_device)
        keep[w] = False
        for got, ring in zip(kern, orig):
            assert torch.equal(got[:, :, keep], ring[:, :, keep])
        assert torch.isnan(kern[2][:, :, w]).sum() == 1 and kern[2][0, 0, w] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,Dh", [(64, 16, 768, 128), (64, 16, 1024, 128),
                                      (64, 32, 384, 64)])
def test_quantize_scale_commit_kernel_matches_plain(cuda_device, B, H, C, Dh):
    """The fused route's rings (stt-1b, TTS, stt-2.6b with ``fused_attn``): the
    returned rows contiguous int8 and both scale rings bit for bit with the
    plain version at w = 0, mid and C - 1, three runs; one launch a call."""
    k, v = _fresh_rows(cuda_device, B, H, Dh, 127.0, seed=C + 1)
    orig = _rings(cuda_device, B, H, C, Dh, False, seed=C)[2:]
    for w in (0, C // 2, C - 1):
        plain = [x.clone() for x in orig]
        want = RK.quantize_scale_commit_plain(k, v, *plain, w)
        before = _launches()
        for _ in range(3):
            kern = [x.clone() for x in orig]
            got = RK.quantize_scale_commit(k, v, *kern, tick(w, cuda_device))
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                assert g.is_contiguous() and g.dtype == torch.int8 and g.shape == (B, H, 1, Dh)
                assert _same_bits(g, p)
            for g, p in zip(kern, plain):
                assert _same_bits(g, p)
        after = _launches()
        assert after[9] - before[9] == 3 and after[:9] == before[:9]
        keep = torch.ones(C, dtype=torch.bool, device=cuda_device)
        keep[w] = False
        assert torch.equal(kern[0][:, :, keep], orig[0][:, :, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,packed4", [(96, False), (96, True), (256, True), (16, True),
                                        (8, False)])
def test_quantize_commit_kernel_takes_other_widths(cuda_device, Dh, packed4):
    """Row widths a segment of a power of two lanes holds with idle lanes
    (Dh = 96: 12 of 16), in a whole warp (Dh = 256) or in one or two lanes;
    K strided too."""
    b, h, c, w = 3, 5, 40, 39
    k, v = _fresh_rows(cuda_device, b, h, Dh, 7.0 if packed4 else 127.0, seed=Dh,
                       k_strided=True)
    orig = _rings(cuda_device, b, h, c, Dh // 2 if packed4 else Dh, packed4, seed=Dh)
    kern, plain = [x.clone() for x in orig], [x.clone() for x in orig]
    RK.quantize_commit(k, v, *kern, tick(w, cuda_device))
    RK.quantize_commit_plain(k, v, *plain, w)
    torch.cuda.synchronize()
    for got, want in zip(kern, plain):
        assert _same_bits(got, want)
    if not packed4:
        ks, vs = orig[2].clone(), orig[3].clone()
        got = RK.quantize_scale_commit(k, v, ks, vs, tick(w, cuda_device))
        want = RK.quantize_scale_commit_plain(k, v, orig[2].clone(), orig[3].clone(), w)
        assert all(_same_bits(g, p) for g, p in zip(got, want))


@pytest.mark.cuda
def test_quantize_commit_kernels_raise_on_unsupported(cuda_device):
    """What the kernel does not take raises before any launch."""
    k, v = _fresh_rows(cuda_device, 2, 4, 64, 127.0, seed=0)
    rings = _rings(cuda_device, 2, 4, 16, 64, False, seed=0)
    before = _launches()
    pos = tick(3, cuda_device)
    with pytest.raises(ValueError, match="Dh a multiple"):  # 12 bytes a row: not 8 lanes' worth
        RK.quantize_commit(k[..., :12], v[..., :12], rings[0][..., :12].contiguous(),
                           rings[1][..., :12].contiguous(), *rings[2:], pos)
    with pytest.raises(ValueError, match="bf16 rows"):
        RK.quantize_commit(k.float(), v.float(), *rings, pos)
    off = torch.zeros(k.numel() + 8, dtype=k.dtype, device=cuda_device)[4:4 + k.numel()]
    with pytest.raises(ValueError, match="16 bytes"):  # rows 8 bytes off 16
        RK.quantize_commit(off.view_as(k), v, *rings, pos)
    with pytest.raises(ValueError, match="do not fit"):  # a packed ring of Dh bytes a row
        RK.quantize_commit(k, v, *_rings(cuda_device, 2, 4, 16, 64, True, seed=1), pos)
    with pytest.raises(ValueError, match="0-d int32 tensor"):  # a host int
        RK.quantize_scale_commit(k, v, *rings[2:], 3)
    with pytest.raises(ValueError, match="the position is on cpu"):
        RK.quantize_scale_commit(k, v, *rings[2:], tick(3))
    with pytest.raises(ValueError, match="f32 scale rings"):
        RK.quantize_scale_commit(k, v, rings[2].double(), rings[3].double(), pos)
    assert _launches() == before


def test_quantize_commit_wrappers_raise_for_non_cuda_devices():
    """A tensor that is on neither the CPU nor a CUDA device goes to no
    plain version: the wrappers raise."""
    m = torch.device("meta")
    k = torch.empty(1, 8, 1, 64, dtype=torch.bfloat16, device=m)
    before = _launches()
    with pytest.raises(ValueError):
        RK.quantize_commit(k, k, torch.empty(1, 8, 32, 64, dtype=torch.int8, device=m),
                           torch.empty(1, 8, 32, 64, dtype=torch.int8, device=m),
                           torch.empty(1, 8, 32, device=m), torch.empty(1, 8, 32, device=m),
                           tick(0, m))
    with pytest.raises(ValueError):
        RK.quantize_scale_commit(k, k, torch.empty(1, 8, 32, device=m),
                                 torch.empty(1, 8, 32, device=m), tick(0, m))
    assert _launches() == before


def test_quantize_commit_on_cpu_tensors_takes_the_plain_version():
    k, v = _fresh_rows(torch.device("cpu"), 2, 4, 64, 127.0, seed=0)
    rings = _rings(torch.device("cpu"), 2, 4, 16, 64, False, seed=0)
    before = _launches()
    RK.quantize_commit(k, v, *rings, tick(5))
    kq, vq, ksn, vsn = A.quantize_kv_rows(k, v)
    assert torch.equal(rings[0][:, :, 5], kq[:, :, 0]) and torch.equal(rings[1][:, :, 5],
                                                                      vq[:, :, 0])
    got = RK.quantize_scale_commit(k, v, rings[2], rings[3], tick(6))
    assert torch.equal(got[0], kq) and _same_bits(rings[3][:, :, 6], vsn[:, :, 0])
    assert _launches() == before


# ---------------------------------------------------------------------------
# Rope and commit (TPU kernel 3 on the step's path) and the rope alone
# ---------------------------------------------------------------------------


def _rope_rows(dev, b, h, t, dh, dtype, seed, per_batch=False):
    """q, k, v ``(B, H, T, Dh)`` as strided views of one QKV product ``(B,
    T, 3, H, Dh)`` (``transformer._qkv``), and cos, sin ``(1, T, Dh/2)`` of
    positions past 3000 (``(B, T, Dh/2)``, a position a slot, with
    ``per_batch``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(b, t, 3, h, dh, generator=g, device=dev) * 2).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not any(x.is_contiguous() for x in (q, k, v))
    pos = torch.arange(t, device=dev)[None] + 3000 + seed
    if per_batch:
        pos = pos + 977 * torch.arange(b, device=dev)[:, None]
    cos, sin = A.rope_cos_sin(pos, dh, 10_000.0)
    return q, k, v, cos, sin


ROPE_CASES = [  # (B, H, C, T, Dh, dtype): the Mimi rings at B = 64 and 24, T = 1, f32
    (64, 8, 256, 2, 64, torch.bfloat16), (24, 8, 256, 2, 64, torch.bfloat16),
    (64, 8, 256, 1, 64, torch.bfloat16), (3, 4, 64, 2, 128, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("per_batch", [False, True], ids=["cos(1,T)", "cos(B,T)"])
@pytest.mark.parametrize("B,H,C,T,Dh,dtype", ROPE_CASES)
def test_rope_commit_kernel_matches_plain(cuda_device, B, H, C, T, Dh, dtype, per_batch):
    """At w = 0, mid and C - T: three kernel runs give the plain version's
    rotated q and k (contiguous) and rings bit for bit, every row but the
    written ones as it was; one launch a call."""
    q, k, v, cos, sin = _rope_rows(cuda_device, B, H, T, Dh, dtype, seed=C + T, per_batch=per_batch)
    g = torch.Generator(device=cuda_device).manual_seed(C)
    orig = [torch.randn(B, H, C, Dh, generator=g, device=cuda_device).to(dtype) for _ in range(2)]
    for w in (0, C // 2, C - T):
        plain = [x.clone() for x in orig]
        want = RK.rope_commit_plain(q, k, v, *plain, cos, sin, w)
        before = _launches()
        for _ in range(3):
            kern = [x.clone() for x in orig]
            got = RK.rope_commit(q, k, v, *kern, cos, sin, tick(w, cuda_device))
            torch.cuda.synchronize()
            assert all(x.is_contiguous() and x.dtype == dtype for x in got)
            for a, p in zip(list(got) + kern, list(want) + plain):
                assert _same_bits(a, p)
        after = _launches()
        assert after[10] - before[10] == 3 and after[:10] == before[:10]
        assert after[11] == before[11]
        keep = torch.ones(C, dtype=torch.bool, device=cuda_device)
        keep[w:w + T] = False
        for a, ring in zip(kern, orig):
            assert torch.equal(a[:, :, keep], ring[:, :, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Dh", [(64, 16, 128), (64, 32, 64), (24, 20, 128), (64, 8, 64)])
def test_rope_qk_kernel_matches_plain(cuda_device, B, H, Dh):
    """The LM rows of stt-1b / TTS, stt-2.6b / tts_202501 and s2s-2b, and the
    Mimi width: bit for bit, three runs, one launch a call."""
    q, k, _, cos, sin = _rope_rows(cuda_device, B, H, 1, Dh, torch.bfloat16, seed=Dh + H)
    want = RK.rope_qk_plain(q, k, cos, sin)
    before = _launches()
    for _ in range(3):
        got = RK.rope_qk(q, k, cos, sin)
        torch.cuda.synchronize()
        assert all(x.is_contiguous() for x in got)
        assert all(_same_bits(a, p) for a, p in zip(got, want))
    after = _launches()
    assert after[11] - before[11] == 3 and after[:11] == before[:11]


@pytest.mark.cuda
def test_rope_commit_wrappers_raise_on_unsupported(cuda_device):
    """CPU rings given CUDA rows, a host int for the position or one on the
    CPU, cos of another dtype or shape, rows of two dtypes or an odd Dh: each
    raises before any launch."""
    q, k, v, cos, sin = _rope_rows(cuda_device, 2, 4, 2, 64, torch.bfloat16, seed=0)
    rings = [torch.zeros(2, 4, 32, 64, dtype=torch.bfloat16, device=cuda_device)
             for _ in range(2)]
    before = _launches()
    pos = tick(0, cuda_device)
    with pytest.raises(ValueError, match="not the CUDA device"):
        RK.rope_commit(q, k, v, *(r.cpu() for r in rings), cos, sin, pos)
    with pytest.raises(ValueError, match="not the CUDA device"):
        RK.rope_qk(q, k, cos.cpu(), sin.cpu())
    for w in (1, 31, 32):
        with pytest.raises(ValueError, match="0-d int32 tensor"):
            RK.rope_commit(q, k, v, *rings, cos, sin, w)
        with pytest.raises(ValueError, match="the position is on cpu"):
            RK.rope_commit(q, k, v, *rings, cos, sin, tick(w))
    with pytest.raises(ValueError, match="f32"):
        RK.rope_commit(q, k, v, *rings, cos.double(), sin.double(), pos)
    with pytest.raises(ValueError, match="f32"):
        RK.rope_qk(q, k, cos[:, :1], sin[:, :1])
    with pytest.raises(ValueError, match="one dtype"):
        RK.rope_qk(q, k.float(), cos, sin)
    with pytest.raises(ValueError, match="do not fit"):
        RK.rope_commit(q, k, v, *(r[..., :32].contiguous() for r in rings), cos, sin, pos)
    with pytest.raises(ValueError, match="even Dh"):
        RK.rope_qk(q[..., :63], k[..., :63], cos[..., :31].contiguous(),
                   sin[..., :31].contiguous())
    assert _launches() == before


def test_rope_commit_wrappers_raise_for_non_cuda_devices():
    """A tensor that is on neither the CPU nor a CUDA device goes to no
    plain version: the wrappers raise."""
    m = torch.device("meta")
    x = torch.empty(1, 8, 2, 64, device=m)
    cs = torch.empty(1, 2, 32, device=m)
    ring = torch.empty(1, 8, 32, 64, device=m)
    before = _launches()
    with pytest.raises(ValueError):
        RK.rope_commit(x, x, x, ring, ring, cs, cs, tick(0, m))
    with pytest.raises(ValueError):
        RK.rope_qk(x, x, cs, cs)
    assert _launches() == before


def test_rope_commit_on_cpu_tensors_takes_the_plain_version():
    q, k, v, cos, sin = _rope_rows(torch.device("cpu"), 2, 4, 2, 64, torch.float32, seed=0)
    rings = [torch.zeros(2, 4, 32, 64) for _ in range(2)]
    before = _launches()
    qr, kr = RK.rope_commit(q, k, v, *rings, cos, sin, tick(6))
    assert torch.equal(qr, A.apply_rope(q, cos, sin)) and torch.equal(kr, A.apply_rope(k, cos, sin))
    assert torch.equal(rings[0][:, :, 6:8], kr) and torch.equal(rings[1][:, :, 6:8], v)
    assert all(torch.equal(a, b) for a, b in zip(RK.rope_qk(q, k, cos, sin), (qr, kr)))
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_step_folds_the_rope_into_the_commit_on_the_card(cuda_device, monkeypatch, dtype):
    """``transformer.step`` at the codec transformer's shapes (8 heads x 64,
    T = 2 frames, a 32-row ring, 20 steps: it wraps): one ``rope_commit``
    launch a layer, no ``ring_commit`` or ``rope_qk``; against the same
    steps through the plain version, outputs and every layer's rings bit
    for bit (the attention is plain PyTorch on both sides)."""
    cfg = T.TransformerConfig(d_model=512, num_heads=8, num_layers=2, dim_feedforward=256,
                              context=30, gating=False, norm="layer_norm", layer_scale=0.5)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init(cfg, gen, dtype)
    st = T.init_state(cfg, 3, dtype, step_t=2, device=cuda_device)
    ref = T.init_state(cfg, 3, dtype, step_t=2, device=cuda_device)
    xs = [torch.randn(3, 2, 512, generator=gen, device=cuda_device).to(dtype)
          for _ in range(20)]
    before = _launches()
    ys = []
    for x in xs:
        y, st = T.step(cfg, params, st, x)
        ys.append(y)
    torch.cuda.synchronize()
    after = _launches()
    assert after[10] - before[10] == 40 and after[0] == before[0] and after[11] == before[11]
    monkeypatch.setattr(RK, "rope_commit", RK.rope_commit_plain)
    for x, y in zip(xs, ys):
        yr, ref = T.step(cfg, params, ref, x)
        assert _same_bits(y, yr)
    for lt, lr in zip(st["layers"], ref["layers"]):
        assert _same_bits(lt["k"], lr["k"]) and _same_bits(lt["v"], lr["v"])


# ---------------------------------------------------------------------------
# The position in device memory, and the ASR step as one captured CUDA graph
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ring_commit", "ring_commit_q", "scale_commit",
                                    "quantize_commit", "quantize_scale_commit", "rope_commit"])
def test_commit_kernels_read_the_position_from_the_card(cuda_device, kernel):
    """Each commit kernel reads the step's tick from device memory and writes
    rows ``tick % C`` on: at w = 0, mid and C - 1 (C - T for rope_commit),
    the tick held at w + 3C, bit for bit the plain version's at w."""
    dev = cuda_device
    b, h, c, dh = 8, 4, 256, 64
    t = 2 if kernel == "rope_commit" else 1
    g = torch.Generator(device=dev).manual_seed(len(kernel))
    k, v = _fresh_rows(dev, b, h, dh, 127.0, seed=3)
    kn8, vn8, ksn, vsn = A.quantize_kv_rows(k, v)
    for w in (0, c // 2, c - t):
        tick_t = tick(w + 3 * c, dev)
        if kernel in ("ring_commit", "rope_commit"):
            rings = [torch.randn(b, h, c, dh, generator=g, device=dev).bfloat16()
                     for _ in range(2)]
        else:
            rings = _rings(dev, b, h, c, dh, False, seed=w)
            if kernel in ("scale_commit", "quantize_scale_commit"):
                rings = rings[2:]
        kern, plain = [x.clone() for x in rings], [x.clone() for x in rings]
        if kernel == "ring_commit":
            rows = [torch.randn(b, h, 1, dh, generator=g, device=dev).bfloat16()
                    for _ in range(2)]
            RK.ring_commit(*kern, *rows, tick_t)
            RK.ring_commit_plain(*plain, *rows, w)
        elif kernel == "ring_commit_q":
            RK.ring_commit(kern[0], kern[1], kn8, vn8, tick_t, kern[2], kern[3], ksn, vsn)
            RK.ring_commit_plain(plain[0], plain[1], kn8, vn8, w, plain[2], plain[3], ksn, vsn)
        elif kernel == "scale_commit":
            RK.scale_commit(*kern, ksn, vsn, tick_t)
            RK.scale_commit_plain(*plain, ksn, vsn, w)
        elif kernel == "quantize_commit":
            RK.quantize_commit(k, v, *kern, tick_t)
            RK.quantize_commit_plain(k, v, *plain, w)
        elif kernel == "quantize_scale_commit":
            got = RK.quantize_scale_commit(k, v, *kern, tick_t)
            want = RK.quantize_scale_commit_plain(k, v, *plain, w)
            assert all(_same_bits(a, p) for a, p in zip(got, want))
        else:
            q, kk, vv, cos, sin = _rope_rows(dev, b, h, t, dh, torch.bfloat16, seed=w)
            got = RK.rope_commit(q, kk, vv, *kern, cos, sin, tick_t)
            want = RK.rope_commit_plain(q, kk, vv, *plain, cos, sin, w)
            assert all(_same_bits(a, p) for a, p in zip(got, want))
        torch.cuda.synchronize()
        for a, p, r in zip(kern, plain, rings):
            assert _same_bits(a, p)
            assert not _same_bits(a, r)  # a row was written


def _small_asr(dev, d_model, heads, w8a8, kv_bits):
    """The smoke TOML's ASR module at B = 8, 2 LM layers of ``heads`` heads
    over a 128-row int8 ring (context 120), the codec at full size (a 256-row
    ring, 2 rows a step), built for the card: int8 LM weights (W8A8 or
    weight-only), int8 or packed-int4 rings."""
    import dataclasses
    import tomllib

    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG

    with open("configs/config-smoke.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["asr"]
    mod.update(batch_size=8, w8a8=w8a8)
    mod["model"]["transformer"].update(d_model=d_model, num_heads=heads, num_layers=2,
                                       dim_feedforward=768, context=120)
    built = B.build_batched_asr(CFG.Config.from_dict(raw).modules["asr"], dev, cuda_graph=False)
    return dataclasses.replace(built.cfg, kv_bits=kv_bits), built.params


def _traffic(b, frame, steps, seed):
    """Inputs of ``steps`` engine ticks: slots open (with a reset) and close,
    partial masks."""
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=b) < 0.7
    for i in range(steps):
        opening = ~active & (rng.uniform(size=b) < 0.15)
        closing = active & (rng.uniform(size=b) < 0.05)
        reset = opening | (active & (i == 0))
        active = (active | opening) & ~closing
        mask = active & (rng.uniform(size=b) < 0.9)
        yield (rng.standard_normal((b, 1, frame)) * 0.1).astype(np.float32), mask, reset


def _tree_same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_same(x, y) for x, y in zip(a, b))
    return _same_bits(a, b)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("d_model,heads,w8a8,kv_bits", [
    (1024, 8, True, 8), (512, 8, False, 8), (1024, 8, True, 4)],
    ids=["fused-w8a8", "split-qmm", "int4"])
def test_captured_asr_step_equals_the_eager_step(cuda_device, d_model, heads, w8a8, kv_bits):
    """``BatchedAsrEngine`` captures its step once and replays it; from one
    state the eager ``ASR.step`` beside it over 160 steps (both rings wrap),
    slots opened, closed and reset, partial masks: every step's outputs and
    the whole state bit for bit, each replay's outputs still equal after the
    next replay, and the state's buffers the same from start to end."""
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.sessions import asr as ASR

    cfg, params = _small_asr(cuda_device, d_model, heads, w8a8, kv_bits)
    eng = BatchedAsrEngine(cfg, params, batch_size=8, device=cuda_device, fill_gate_frac=0.0)
    assert eng.cuda_graph and eng._graph is None
    with pytest.raises(RuntimeError, match="not captured"):
        eng._invoke_step(np.zeros((8, 1, eng.frame_size), np.float32),
                         np.zeros(8, bool), np.zeros(8, bool))
    eng.warmup()
    assert eng._graph is not None
    ptrs = [t.data_ptr() for t in _tensors(eng.state)]
    ref = _tree_clone(eng.state)
    seeds = torch.as_tensor(eng._seeds, device=cuda_device)
    prev = None
    with torch.inference_mode():
        for pcm, mask, reset in _traffic(8, eng.frame_size, 160, seed=d_model + kv_bits):
            got = eng._invoke_step(pcm, mask, reset)
            want, ref = ASR.step(cfg, params, ref, *(torch.as_tensor(x, device=cuda_device)
                                                     for x in (pcm, mask, reset)), seeds=seeds)
            for key in ("text_token", "step_idx", "prs", "codes"):
                assert _same_bits(got[key], want[key]), key
            if prev is not None:  # the last replay's outputs survived this one
                assert all(_same_bits(prev[0][k], prev[1][k]) for k in prev[0])
            prev = (got, want)
    assert int(ref["lm"]["t"]["pos"]) > 128 and int(ref["mimi_enc"]["enc_t"]["pos"]) > 256
    assert _tree_same(eng.state, ref)
    assert [t.data_ptr() for t in _tensors(eng.state)] == ptrs


@pytest.mark.cuda
def test_asr_step_body_makes_no_host_sync(cuda_device):
    """The fixed-buffer step (the body the engine captures) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the card,
    so nothing the host reads back can go stale in a replay."""
    from dsm_tpu_torch.sessions import asr as ASR

    cfg, params = _small_asr(cuda_device, 1024, 8, True, 8)
    state = ASR.init_state(cfg, 8, torch.bfloat16, cuda_device)
    pcm = torch.randn(8, 1, cfg.mimi.frame_size, device=cuda_device) * 0.1
    mask = torch.ones(8, dtype=torch.bool, device=cuda_device)
    seeds = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with torch.inference_mode():
        ASR.step_in_place(cfg, params, state, pcm, mask, mask, seeds=seeds)  # lazy constants
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                ASR.step_in_place(cfg, params, state, pcm, mask, ~mask, seeds=seeds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(state["lm"]["t"]["pos"]) == 4


@pytest.mark.cuda
def test_captured_tp_asr_engine_equals_the_eager_tp_engine(cuda_device):
    """A dp = 1 x tp = 2 ``BatchedAsrEngine`` on the card, its two tp shards
    captured as one graph (the joins summed on the device), beside the eager
    tp engine (host threads and ``TpGroup``) from the same seeded state: every
    step's outputs bit for bit over 24 steps of traffic, each tp shard's whole
    state at the end, the kernels launched only in the warm-up and capture,
    the shard threads ended; then four streams through ``tick()`` event for
    event (steps, words, markers, VAD bits)."""
    from dsm_tpu_torch.parallel import mesh as M
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine

    cfg, params = _small_asr(cuda_device, 1024, 8, True, 8)

    def engine(graph):
        eng = BatchedAsrEngine(cfg, params, batch_size=8, device=cuda_device,
                               fill_gate_frac=0.0, cuda_graph=graph,
                               mesh=M.make_mesh(1, 2, devices=[cuda_device] * 2))
        eng._seeds[:] = np.arange(8) + 11
        eng.warmup()
        return eng

    eager = engine(False)
    eng = engine(True)
    assert eng.cuda_graph and not eager.cuda_graph and eng._runner._queues is None
    assert isinstance(eng.shards[0][1]._graph, M._PeerGraph)
    launched = RK.rope_qk.launches
    with torch.inference_mode():
        for pcm, mask, reset in _traffic(8, eng.frame_size, 24, seed=22):
            got = eng._invoke_step(pcm, mask, reset)
            want = eager._invoke_step(pcm, mask, reset)
            for key in ("text_token", "step_idx", "prs", "codes"):
                assert _same_bits(got[key], want[key]), key
    assert RK.rope_qk.launches - launched == 2 * 24 * cfg.lm.transformer.num_layers
    for t in range(2):
        assert _tree_same(eng.shards[0][t].state, eager.shards[0][t].state)
    eager.stop()
    assert _asr_serve(engine(True)) == _asr_serve(engine(False))


# ---------------------------------------------------------------------------
# The TTS tick as one captured CUDA graph
# ---------------------------------------------------------------------------


def _small_tts(dev, cfg_enabled, fuse_ticks=1, pipeline_depth=1):
    """The TTS serving TOML at B = 8 on the card: 2 LM layers of 8 heads x 128
    over a 128-row int8 ring (context 120; the fused route), the int8 voice
    store, W8A8, the int16 wire, a DepFormer of 8 slices x 2 layers, the codec
    at full size (a 256-row ring, 2 rows a tick); single-tick unless
    ``fuse_ticks`` says otherwise."""
    import tomllib

    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG

    with open("configs/config-tts-tpu-serving.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["tts"]
    mod.update(batch_size=8, fuse_ticks=fuse_ticks, pipeline_depth=pipeline_depth,
               cfg_enabled=cfg_enabled)
    mod["model"]["transformer"].update(d_model=1024, num_heads=8, num_layers=2,
                                       dim_feedforward=768, context=120)
    mod["model"]["depformer"].update(num_slices=8)
    mod["model"]["depformer"]["transformer"].update(d_model=64, num_heads=2, num_layers=2,
                                                    dim_feedforward=192, context=8)
    mod["model"].update(audio_codebooks=8)
    mod["generation"].update(speaker_cond_n_speakers=1, text_audio_delay_in_tokens=3)
    return B.build_batched_tts(CFG.Config.from_dict(raw).modules["tts"], dev)


def _tts_traffic(b, steps, seed):
    """Inputs of ``steps`` engine ticks: slots open (with a reset) and close,
    partial masks, the three constraint modes."""
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=b) < 0.7
    for i in range(steps):
        opening = ~active & (rng.uniform(size=b) < 0.15)
        closing = active & (rng.uniform(size=b) < 0.05)
        reset = opening | (active & (i == 0))
        active = (active | opening) & ~closing
        mask = active & (rng.uniform(size=b) < 0.9)
        modes = rng.integers(0, 3, size=b).astype(np.int32)
        toks = rng.integers(4, 200, size=b).astype(np.int32)
        yield modes, toks, mask, reset


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_enabled", [False, True], ids=["plain", "cfg"])
def test_captured_tts_tick_equals_the_eager_tick(cuda_device, cfg_enabled):
    """``BatchedTtsEngine`` captures its tick once (the default on CUDA) and
    replays it; the eager tick (``TTS.step`` + ``MIMI.decode_step``) runs
    beside it from a clone of its state over 160 ticks, past a wrap of the LM
    ring and of the codec ring, slots opened, closed and reset, partial masks,
    a voice written and a pad overwrite between replays: the packed array of
    every tick and the whole state at the end bit for bit, the state's
    buffers the same from start to end."""
    import copy

    from dsm_tpu_torch.ops import transformer as TT
    from dsm_tpu_torch.sessions import tts as TTS

    eng = _small_tts(cuda_device, cfg_enabled)
    b = eng.batch_size
    assert eng.cuda_graph and eng._graph is None
    off = np.zeros(b, bool)
    with pytest.raises(RuntimeError, match="not captured"):
        eng._invoke_step(np.zeros(b, np.int32), np.zeros(b, np.int32), off, off)
    rng = np.random.default_rng(1)
    eng._text_temp[:] = rng.uniform(0.0, 1.0, b)
    eng._audio_temp[:] = rng.uniform(0.0, 1.0, b)
    eng._seeds[:] = np.arange(b) + 40
    if cfg_enabled:
        eng._cfg_alpha[:] = rng.uniform(1.0, 3.0, b)
    eng.warmup()
    assert eng._graph is not None
    ref = copy.copy(eng)  # the eager tick on a clone of the state; params, voices shared
    ref.cuda_graph = False
    ref.state, ref.mimi_state = _tree_clone(eng.state), _tree_clone(eng.mimi_state)
    ptrs = [t.data_ptr() for t in _tensors(eng.state) + _tensors(eng.mimi_state)]
    tcfg = eng.cfg.lm.transformer
    voice = TT.precompute_ca_kv(
        tcfg, eng.params["lm"]["transformer"],
        torch.randn(1, eng.ca_len, tcfg.ca_dim or tcfg.d_model, device=cuda_device).bfloat16())
    with torch.inference_mode():
        for i, (modes, toks, mask, reset) in enumerate(_tts_traffic(b, 160, seed=7)):
            if i == 50:  # shared voice store: written once for both
                eng._apply_voice_writes([(3, voice)])
            if i == 70:
                slots = torch.as_tensor(eng._rows(mask), device=cuda_device)
                for e in (eng, ref):
                    TTS.overwrite_last_text_token_in_place(e.state, eng.cfg.text_pad_token,
                                                           slots)
            got = eng._invoke_step(modes, toks, mask, reset).copy()
            want = ref._invoke_step(modes, toks, mask, reset)
            assert np.array_equal(got, want), i
    assert int(ref.state["lm"]["t"]["pos"]) > 128
    assert int(ref.mimi_state["dec_t"]["pos"]) > 256
    assert _tree_same(eng.state, ref.state) and _tree_same(eng.mimi_state, ref.mimi_state)
    assert [t.data_ptr() for t in _tensors(eng.state) + _tensors(eng.mimi_state)] == ptrs
    assert int(np.asarray(got[2 * b:3 * b]).sum()) > 0, "no frame was decoded"


@pytest.mark.cuda
def test_tts_tick_body_makes_no_host_sync(cuda_device):
    """The fixed-buffer tick (the body the engine captures: the TTS step,
    the DepFormer's per-tick carry and Gumbel noise, top-k, the gated Mimi
    decode) under ``torch.cuda.set_sync_debug_mode("error")``: nothing waits
    on the card, so nothing the host reads back can go stale in a replay."""
    eng = _small_tts(cuda_device, True)
    r, dev = eng.rows, cuda_device
    x = {"modes": torch.full((r,), 2, dtype=torch.int32, device=dev),
         "toks": torch.zeros(r, dtype=torch.int32, device=dev),
         "mask": torch.ones(r, dtype=torch.bool, device=dev),
         "reset": torch.zeros(r, dtype=torch.bool, device=dev),
         "text_temp": torch.full((r,), 0.6, device=dev),
         "audio_temp": torch.full((r,), 0.8, device=dev),
         "seeds": torch.arange(r, dtype=torch.int64, device=dev),
         "alpha": torch.full((eng.batch_size,), 2.0, device=dev)}
    with torch.inference_mode():
        eng._device_tick(x, in_place=True)  # lazy constants
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(8):
                eng._device_tick(x, in_place=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(eng.state["step_idx"][0]) == 9


# ---------------------------------------------------------------------------
# The duplex tick as one captured CUDA graph
# ---------------------------------------------------------------------------


def _small_duplex(dev, kv_bits=8, pipeline_depth=1, cuda_graph=None):
    """The duplex serving TOML at B = 8 on the card: 2 LM layers of 4 heads x
    128 over a 128-row int8 or packed-int4 ring (context 120; the split
    route, as s2s-2b's 20 heads take), W8A8, a DepFormer of 4 slices x 2
    layers, 4 + 4 codebooks, the codec at full size (a 256-row ring, 2 rows a
    tick)."""
    import tomllib

    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG

    with open("configs/config-duplex-tpu-serving.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["duplex"]
    mod.update(batch_size=8, pipeline_depth=pipeline_depth, kv_bits=kv_bits)
    mod["model"].update(audio_codebooks=8, text_in_vocab_size=321, text_out_vocab_size=320)
    mod["model"]["transformer"].update(d_model=512, num_heads=4, num_layers=2,
                                       dim_feedforward=768, context=120)
    mod["model"]["depformer"].update(num_slices=4)
    mod["model"]["depformer"]["transformer"].update(d_model=64, num_heads=2, num_layers=2,
                                                    dim_feedforward=192, context=4)
    mod["generation"].update(generated_audio_codebooks=4, input_audio_codebooks=4)
    return B.build_duplex(CFG.Config.from_dict(raw).modules["duplex"], dev,
                          cuda_graph=cuda_graph)


def _duplex_traffic(b, frame, steps, seed):
    """Inputs of ``steps`` engine ticks: slots open (with a reset) and close,
    partial masks, a text-only (ASR-delay) slot among them."""
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=b) < 0.7
    delay = np.where(np.arange(b) == 2, 5, 0).astype(np.int32)
    for i in range(steps):
        opening = ~active & (rng.uniform(size=b) < 0.15)
        closing = active & (rng.uniform(size=b) < 0.05)
        reset = opening | (active & (i == 0))
        active = (active | opening) & ~closing
        mask = active & (rng.uniform(size=b) < 0.9)
        pcm = (rng.standard_normal((b, 1, frame)) * 0.1).astype(np.float32)
        yield pcm, mask, reset, delay


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_captured_duplex_tick_equals_the_eager_tick(cuda_device, kv_bits):
    """``BatchedDuplexEngine`` captures its tick once (the default on CUDA)
    and replays it; the eager tick runs beside it from a clone of its key and
    states, every ring 40 ticks before its end, over 80 ticks (every ring
    wraps), slots opened, closed and reset, partial
    masks and a text-only slot: the packed array of every tick and, at the
    end, the key and every state bit for bit, the buffers the same from
    start to end."""
    import copy

    eng = _small_duplex(cuda_device, kv_bits)
    b, frame = eng.batch_size, eng.mimi_cfg.frame_size
    assert eng.cuda_graph and eng._graph is None
    off = np.zeros(b, bool)
    with pytest.raises(RuntimeError, match="not captured"):
        eng._invoke_step(eng._pcm_buf, off, off, np.zeros(b, np.int32))
    eng.warmup()
    assert eng._graph is not None
    lm_t = eng.state["lm"]["t"]
    lm_t["pos"].fill_(lm_t["valid"].shape[1] - 40)
    for t in (eng.enc_state["enc_t"], eng.dec_state["dec_t"]):
        t["pos"].fill_(t["valid"].shape[1] - 80)  # 2 rows a tick
    ref = copy.copy(eng)  # the eager tick on clones; params shared
    ref.cuda_graph = False
    ref.rng = eng.rng.clone()
    ref.state, ref.enc_state, ref.dec_state = (
        _tree_clone(eng.state), _tree_clone(eng.enc_state), _tree_clone(eng.dec_state))
    def trees(e):
        return [e.rng] + _tensors(e.state) + _tensors(e.enc_state) + _tensors(e.dec_state)

    ptrs = [t.data_ptr() for t in trees(eng)]
    decoded = 0
    with torch.inference_mode():
        for i, (pcm, mask, reset, delay) in enumerate(_duplex_traffic(b, frame, 80, kv_bits)):
            got = eng._invoke_step(pcm, mask, reset, delay).copy()
            want = ref._invoke_step(pcm, mask, reset, delay)
            assert np.array_equal(got, want), i
            decoded += int(got[2 * b:3 * b].sum())
    assert _tree_same(eng.state, ref.state) and _tree_same(eng.enc_state, ref.enc_state)
    assert _tree_same(eng.dec_state, ref.dec_state) and _same_bits(eng.rng, ref.rng)
    assert [t.data_ptr() for t in trees(eng)] == ptrs
    assert int(ref.state["lm"]["t"]["pos"]) > ref.state["lm"]["t"]["valid"].shape[1]
    assert int(ref.enc_state["enc_t"]["pos"]) > ref.enc_state["enc_t"]["valid"].shape[1]
    assert decoded > 0, "no frame was decoded"


@pytest.mark.cuda
def test_duplex_tick_body_makes_no_host_sync(cuda_device):
    """The fixed-buffer tick (the body the engine captures: the key split,
    Mimi encode, the LM step, the DepFormer's carry and draws, the codec
    resets, the gated Mimi decode) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits on the card,
    so nothing the host reads back can go stale in a replay."""
    eng = _small_duplex(cuda_device, cuda_graph=False)
    b, dev = eng.batch_size, cuda_device
    x = {"pcm": torch.randn(b, 1, eng.mimi_cfg.frame_size, device=dev) * 0.1,
         "mask": torch.ones(b, dtype=torch.bool, device=dev),
         "reset": torch.zeros(b, dtype=torch.bool, device=dev),
         "asr_delay": torch.tensor([0, 3] * (b // 2), dtype=torch.int32, device=dev)}
    with torch.inference_mode():
        eng._device_tick(x, in_place=True)  # lazy constants
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                eng._device_tick(x, in_place=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(eng.state["step_idx"][0]) == 5


@pytest.mark.cuda
def test_captured_duplex_engine_at_depth_2_gives_the_depth_1_events(cuda_device):
    """Five dialogues (one text-only, two in reused slots) served by the
    captured engine at ``pipeline_depth`` 2 and 1 and by the eager engine:
    every dialogue's events equal (text, every frame bit for bit), Done
    last; at depth 2 ``stop()`` delivers the tick still in flight."""
    def serve(**kw):
        eng = _small_duplex(cuda_device, **kw)
        eng.warmup()
        frame = eng.mimi_cfg.frame_size
        events = [[] for _ in range(5)]
        drivers = []
        for sid in range(5):
            if sid == 3:  # the next two land in the slots of the first two
                for _ in range(12):
                    eng.tick()
                for drv in drivers[:2]:
                    assert drv.finished
                    eng.close_session(drv)
            drv = eng.open_session(events[sid].append, asr_delay_in_tokens=4 * (sid == 1))
            pcm = np.random.default_rng(sid).standard_normal(frame * (6 + sid))
            drv.push_pcm((pcm * 0.1).astype(np.float32))
            drv.end_input()
            drivers.append(drv)
        for _ in range(10):  # the last dialogue's last frame: dispatched, not fetched
            eng.tick()
        before = sum(map(len, events))
        eng.stop()
        drained = sum(map(len, events)) - before
        for _ in range(3):
            eng.tick()
        return events, drained

    runs = {"eager": serve(cuda_graph=False), "graph 1": serve(),
            "graph 2": serve(pipeline_depth=2)}
    assert runs["eager"][1] == runs["graph 1"][1] == 0 and runs["graph 2"][1] > 0
    for sid in range(5):
        logs = {name: [(type(e).__name__, getattr(e, "text", None),
                        None if not hasattr(e, "pcm") else e.pcm.tobytes()) for e in evs[sid]]
                for name, (evs, _) in runs.items()}
        assert logs["graph 2"] == logs["graph 1"] == logs["eager"], sid
        assert logs["graph 2"][-1][0] == "DuplexDoneEvent"
        n_audio = sum(k == "DuplexAudioEvent" for k, _, _ in logs["graph 2"])
        assert n_audio == (0 if sid == 1 else 6 + sid - 2), (sid, n_audio)


def _asr_serve(eng, n_frames=(40, 30, 24, 20), seed=3):
    """Four streams with markers on an 8-slot engine (the fourth in the slot
    of the first, closed once it is done; the other slots idle), driven by
    ``tick()`` -> each stream's events with the VAD probabilities' bits."""
    frame = eng.frame_size
    logs = [[] for _ in n_frames]
    chans = []
    rng = np.random.default_rng(seed)

    def open_(i):
        ch = eng.open_channel(logs[i].append, seed=40 + i)
        ch.push_pcm((rng.standard_normal(frame * n_frames[i]) * 0.1 * (1 + 3 * (i == 1)))
                    .astype(np.float32))  # stream 1 loud: the int16 wire clips it
        eng.add_marker(ch, 100 + i)
        ch.push_pcm(np.zeros(frame * 8, np.float32))
        chans.append(ch)

    for i in range(3):
        open_(i)
    for _ in range(n_frames[0] + 10):
        eng.tick()
    eng.flush()
    eng.close_channel(chans[0])
    open_(3)
    while any(ch.buffered_samples() >= frame for ch in chans[1:]):
        eng.tick()
    eng.stop()  # tick()-driven: delivers every step in flight
    return [[(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                            getattr(w, "start_time", None)) for w in e.words],
              list(e.markers), e.prs.tobytes()) for e in evs] for evs in logs]


@pytest.mark.cuda
def test_captured_asr_engine_at_depth_2_gives_the_depth_1_events(cuda_device):
    """The captured engine on the int16 wire at ``pipeline_depth`` 2, 1 and
    0 and the eager engine at 1: every stream's events equal (steps, words,
    markers, VAD probabilities bit for bit).  At depth 2 the fetch of step N
    waits on its own copy's event, which fires while replay N + 1 still
    runs; each step's packed array lands in a pinned buffer of its own."""
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
    from dsm_tpu_torch.server.cuda_graph import fetch

    cfg, params = _small_asr(cuda_device, 1024, 8, True, 8)

    def engine(depth, graph=True):
        eng = BatchedAsrEngine(cfg, params, batch_size=8, device=cuda_device,
                               fill_gate_frac=0.0, cuda_graph=graph, pipeline_depth=depth,
                               pcm_wire_int16=True)
        eng.warmup()
        return eng

    runs = {name: _asr_serve(engine(depth, graph))
            for name, depth, graph in (("graph 2", 2, True), ("graph 1", 1, True),
                                       ("graph 0", 0, True), ("eager 1", 1, False))}
    for i in range(4):
        assert runs["graph 2"][i] == runs["graph 1"][i] == runs["graph 0"][i] \
            == runs["eager 1"][i], i
        assert [m for e in runs["graph 2"][i] for m in e[2]] == [100 + i]
    eng = engine(2)
    assert len(eng._outputs.buffers) == 3 and all(t.is_pinned() for t in eng._outputs.buffers)
    b, frame = eng.batch_size, eng.frame_size
    pcm = (np.random.default_rng(1).standard_normal((b, 1, frame)) * 0.1).astype(np.float32)
    on, off = np.ones(b, bool), np.zeros(b, bool)
    fetch(eng._dispatch(pcm, on, on))
    torch.cuda.synchronize()
    first = eng._dispatch(pcm, on, off)
    second = eng._dispatch(pcm, on, off)
    packed = fetch(first)
    assert not second[1].query(), "the fetch of step N waited for replay N + 1"
    assert first[0].data_ptr() != second[0].data_ptr()
    assert packed.shape == (2 * b + b * 4,) and (packed[b:2 * b] == 2).all()
    assert (fetch(second)[b:2 * b] == 3).all()


@pytest.mark.cuda
def test_captured_asr_engine_observers_fire_once_a_replayed_step(cuda_device):
    """With the step captured at depth 2, ``step_observer`` and
    ``phase_observer`` fire once a replayed step (none in the warm-up and
    capture), with the JAX engine's keys and the share of slots stepped."""
    from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine

    cfg, params = _small_asr(cuda_device, 1024, 8, True, 8)
    eng = BatchedAsrEngine(cfg, params, batch_size=8, device=cuda_device, fill_gate_frac=0.0,
                           cuda_graph=True, pipeline_depth=2)
    steps, phases = [], []
    eng.step_observer = lambda dt, u: steps.append((dt, u))
    eng.phase_observer = phases.append
    eng.warmup()
    assert eng._graph is not None and not steps and not phases
    steps0 = eng.step_count
    _asr_serve(eng)
    assert len(steps) == len(phases) == eng.step_count - steps0 > 40
    assert all(set(p) == {"t0", "queue_ms", "fetch_ms", "post_ms", "util"} for p in phases)
    assert [p["util"] for p in phases] == [u for _, u in steps]
    assert all(0.0 <= u <= 1.0 and dt > 0 for dt, u in steps)
    assert max(u for _, u in steps) == 3 / 8  # three streams at once on 8 slots


@pytest.mark.cuda
def test_bench_mimi_and_lm_on_the_card(cuda_device):
    """``bench_perf.bench_mimi`` and ``bench_lm`` at a small batch on the card
    (the LM step captured and replayed): the JAX functions' keys, positive
    device times."""
    from dsm_tpu_torch import bench_perf as BP

    mimi = BP.bench_mimi(4, 3, device=cuda_device)
    assert set(mimi) == {"mimi_encode_p50_ms", "mimi_decode_p50_ms", "batch"}
    assert mimi["mimi_encode_p50_ms"] > 0 and mimi["mimi_decode_p50_ms"] > 0
    lm = BP.bench_lm(4, 3, device=cuda_device)
    assert set(lm) == {"lm_step_ms", "batch", "fused_steps", "model"}
    assert lm["lm_step_ms"] > 0 and lm["fused_steps"] == 3 and lm["model"] == "stt-1b"
    mem = BP.bench_memory(cuda_device)
    assert 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"]


def _tts_fused_serve(eng):
    """Slot 0: a long session; slot 1: a short one, closed at frame 48 and its
    slot reopened; slot 2: a session fed in two parts; the other slots hold
    wordless sessions that never end, so every frame up to 400 has an active
    slot and both engines step the same frames -> each session's events with
    pcm bits and the frames run."""
    texts = ["one two three four five six seven eight nine ten one two three",
             "hi there", "the quick brown fox jumps", "see you"]
    logs = [[] for _ in texts]
    live = {}

    def open_(i, first=None):
        drv = eng.open_session(logs[i].append, seed=70 + i)
        words, _ = eng.encode_words(texts[i], inserted_bos=False)
        drv.feed_words(words if first is None else words[:first])
        if first is None:
            drv.end_input()
        live[i] = (drv, words[first:] if first is not None else [])
        return drv

    open_(0)
    open_(1)
    open_(2, first=2)
    idle = [eng.open_session(lambda ev: None, seed=80 + i)  # so slot 1 is the one reused
            for i in range(eng.batch_size - 3)]
    frames = 0
    while frames < 400:
        if frames == 8:
            drv, rest = live[2]
            drv.feed_words(rest)
            drv.end_input()
        if frames == 48:
            drv = live[1][0]
            assert drv.finished
            eng.close_session(drv)
            assert open_(3).slot == drv.slot
        if not eng.tick():
            break
        frames += eng.fuse
    eng.stop()
    assert all(drv.finished for drv, _ in live.values())
    for drv in idle:
        eng.close_session(drv)
    return [[(type(e).__name__, getattr(e, "text", None), getattr(e, "start_s", None),
              None if not hasattr(e, "pcm") else e.pcm.tobytes()) for e in evs]
            for evs in logs], frames


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_enabled", [False, True], ids=["plain", "cfg"])
def test_captured_fused_tts_engine_equals_the_single_tick_engine(cuda_device, cfg_enabled):
    """The serving TOML at a small width on the card: the fused engine
    (``fuse_ticks`` 4, depth 2; one frame captured, replayed 4 times a
    dispatch) and the captured single-tick engine deliver the same events,
    pcm bit for bit, Done last, past the 128-row LM ring's wrap."""
    single = _small_tts(cuda_device, cfg_enabled)
    fused = _small_tts(cuda_device, cfg_enabled, fuse_ticks=4, pipeline_depth=2)
    assert fused.fuse == 4 and fused.pipeline_depth == 2 and fused.cuda_graph
    for eng in (single, fused):
        eng.warmup()
    (ev_s, n_s), (ev_f, n_f) = _tts_fused_serve(single), _tts_fused_serve(fused)
    assert n_s > 128
    for a, b in zip(ev_s, ev_f):
        assert a == b
        assert a[-1][0] == "DoneEvent" and sum(k == "AudioEvent" for k, *_ in a) > 0
    assert len(fused._outputs.buffers) == 2 and fused._frames.shape[0] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_ops_on_the_card_equals_the_cpu(cuda_device, seed):
    """``tts_script.apply_ops`` on the card from a random machine, a random
    op table (same-slot orders, word chunks that wrap a 32-token ring, NOP
    rows): every field equal to the CPU's."""
    from dsm_tpu_torch.sessions import tts_script as S

    rng = np.random.default_rng(seed)
    batch, cap = 8, 32
    m = S.init(batch, cap)
    for key in ("toks", "ptr", "widx", "n_toks", "n_words", "past_last"):
        m[key] = torch.from_numpy(rng.integers(0, 40, m[key].shape).astype(np.int32))
    m["word_of"] = torch.from_numpy(rng.integers(-1, 9, (batch, cap)).astype(np.int32))
    for key in ("eos", "drained", "active"):
        m[key] = torch.from_numpy(rng.uniform(size=batch) < 0.5)
    ops = []
    for _ in range(200):
        kind, slot = int(rng.integers(0, 5)), int(rng.integers(0, batch))
        count = int(rng.integers(0, S.WORD_CHUNK + 1))
        toks = rng.integers(1, 100, S.WORD_CHUNK).astype(np.int32)
        ops.append((kind, slot, toks, count, int(rng.integers(0, 20)),
                    int(rng.integers(0, 100))))
    table = S.op_table(ops)
    on_card = {k: v.to(cuda_device) for k, v in m.items()}
    S.apply_ops(m, torch.from_numpy(table))
    S.apply_ops(on_card, torch.from_numpy(table).to(cuda_device))
    for key in m:
        assert torch.equal(on_card[key].cpu(), m[key]), key


# ---------------------------------------------------------------------------
# The single-session TTS tick as one captured CUDA graph; checkpoints
# ---------------------------------------------------------------------------


def _single_tts_module(**files):
    """configs/config-tts.toml (no ``batch_size``: the single-session engine)
    on the card: 2 LM layers of 8 heads x 128 over a 128-row int8 ring
    (context 40), the int8 voice store, W8A8, a DepFormer of 8 slices x 2
    layers, the codec at full size (a 256-row ring)."""
    import tomllib

    from dsm_tpu_torch.server import config as CFG

    with open("configs/config-tts.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["tts"]
    mod.update(files)
    mod["model"]["transformer"].update(d_model=1024, num_heads=8, num_layers=2,
                                       dim_feedforward=768, context=40)
    mod["model"]["depformer"].update(num_slices=8)
    mod["model"]["depformer"]["transformer"].update(d_model=64, num_heads=2, num_layers=2,
                                                    dim_feedforward=192, context=8)
    mod["model"].update(audio_codebooks=8)
    mod["generation"].update(speaker_cond_n_speakers=1, speaker_cond_dim=1024,
                             text_audio_delay_in_tokens=3)
    return CFG.Config.from_dict(raw).modules["tts"]


def _single_tts(dev, cuda_graph=None, **files):
    from dsm_tpu_torch.server import builder as B

    return B.build_tts(_single_tts_module(**files), dev, cuda_graph=cuda_graph)


def _params_same(a, b):
    """Param trees bit for bit; a weight's profile (``w8a8``) equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_params_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_params_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return _same_bits(a, b)
    return a == b


def _single_ticks(eng, n, seed, voice, start_rings=None):
    """``n`` ticks of one session (random constraints, a pad overwrite every
    ninth tick) -> the packed arrays; ``start_rings``: the LM and codec ring
    positions the session starts from (rows before their wraps)."""
    rng = np.random.default_rng(seed)
    eng.begin(seed, voice)
    if start_rings is not None:
        eng.state["lm"]["t"]["pos"].fill_(start_rings[0])
        eng.mimi_state["dec_t"]["pos"].fill_(start_rings[1])
    out = []
    for i in range(n):
        out.append(eng.tick(int(rng.integers(0, 3)), int(rng.integers(4, 200))).copy())
        if i % 9 == 8:
            eng.overwrite_last_text_token(eng.cfg.text_pad_token)
    return out


@pytest.mark.cuda
def test_captured_single_tts_tick_equals_the_eager_tick(cuda_device):
    """``TtsEngine`` on the card captures its tick (the key split, the TTS
    step, the gated Mimi decode, the packing) and replays it; an engine of
    the same weights runs the eager tick: over 48 ticks from 20 rows before
    the LM ring's wrap and 40 before the codec ring's, with a voice, then a
    session without one, and a pad overwrite between replays, the packed
    array of every tick bit for bit, the state's buffers the same."""
    eng = _single_tts(cuda_device)
    ref = _single_tts(cuda_device, cuda_graph=False)
    assert eng.cuda_graph and not ref.cuda_graph and eng.ca_quant
    eng.warmup()
    assert list(eng._graphs) == [False]
    ptrs = [t.data_ptr() for t in _tensors(eng.state) + _tensors(eng.mimi_state)]
    c_lm = eng.state["lm"]["t"]["valid"].shape[1]
    c_dec = eng.mimi_state["dec_t"]["valid"].shape[1]
    tcfg = eng.cfg.lm.transformer
    with torch.inference_mode():
        src = torch.randn(1, eng.ca_len, tcfg.d_model, device=cuda_device).bfloat16()
        from dsm_tpu_torch.ops import transformer as TT

        voice = TT.quantize_ca_kv(TT.precompute_ca_kv(
            tcfg, eng.params["lm"]["transformer"], src), s_len=eng.ca_len)
    decoded = 0
    for v, seed in ((voice, 3), (None, 4)):
        got = _single_ticks(eng, 48, seed, v, (c_lm - 20, c_dec - 40))
        want = _single_ticks(ref, 48, seed, v, (c_lm - 20, c_dec - 40))
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (seed, i)
        decoded += sum(int(a[2]) for a in got)
        assert int(eng.state["lm"]["t"]["pos"]) == c_lm + 28
    assert decoded > 0, "no frame was decoded"
    assert [t.data_ptr() for t in _tensors(eng.state) + _tensors(eng.mimi_state)] == ptrs


@pytest.mark.cuda
def test_engine_from_checkpoint_files_equals_the_engine_from_memory(cuda_device, tmp_path):
    """The TOML's model written from the builder's own seeded tree (the
    generator on the card, seeds 0 and 1) to reference-layout bf16
    safetensors by the port's writer, then built from those files: every
    parameter, the quantised ones included, and every tick of a session bit
    for bit the engine built at random from the same seeds."""
    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.models import mimi as MIMI
    from dsm_tpu_torch.utils import checkpoint as CK

    mod = _single_tts_module()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    lm = LM.init(mod.lm, gen, torch.bfloat16)
    gen.manual_seed(1)
    mimi_cfg = MIMI.v0_1(mod.lm.generated_codebooks)
    mimi = MIMI.init(mimi_cfg, gen, torch.bfloat16)
    CK.save_safetensors(str(tmp_path / "lm.safetensors"), CK.lm_params_to_reference(mod.lm, lm))
    CK.save_safetensors(str(tmp_path / "mimi.safetensors"),
                        CK.mimi_params_to_reference(mimi_cfg, mimi))
    assert CK.load_safetensors(str(tmp_path / "lm.safetensors")).dtype("text_emb.weight") == "BF16"
    del lm, mimi
    a = _single_tts(cuda_device)
    b = _single_tts(cuda_device, lm_model_file=str(tmp_path / "lm.safetensors"),
                    audio_tokenizer_file=str(tmp_path / "mimi.safetensors"))
    assert _params_same(b.params, a.params) and _params_same(b.mimi_params, a.mimi_params)
    a.warmup()
    b.warmup()
    for x, y in zip(_single_ticks(a, 24, 5, None), _single_ticks(b, 24, 5, None)):
        assert np.array_equal(x, y)


@pytest.mark.cuda
def test_safetensors_reader_maps_a_file_over_2gb(tmp_path):
    """A file of 2.5 GB (sparse: the header, a 2.4 GB zero tensor, then a
    small one written at its end): the reader maps it and reads the tensor
    past the 2 GiB offset, and a slice of the large one, without reading
    the file."""
    import json

    from dsm_tpu_torch.utils import checkpoint as CK

    n_big = 600_000_000
    tail = np.arange(64, dtype=np.float32) - 7.5
    header = {"big": {"dtype": "F32", "shape": [n_big], "data_offsets": [0, 4 * n_big]},
              "tail": {"dtype": "F32", "shape": [8, 8],
                       "data_offsets": [4 * n_big, 4 * n_big + tail.nbytes]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "big.safetensors"
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        f.seek(8 + len(blob) + 4 * n_big)
        f.write(tail.tobytes())
    assert path.stat().st_size > 2**31
    t = CK.load_safetensors(str(path))
    np.testing.assert_array_equal(t["tail"], tail.reshape(8, 8))
    assert isinstance(t["big"], np.memmap) and t["big"].shape == (n_big,)
    assert not t["big"][n_big - 1000:].any()


def _cut_moshi(num_slices=16):
    """Moshi 7B's layout (16 codebooks in, its slices, norms and rope) at
    narrow widths."""
    import dataclasses

    from dsm_tpu_torch.models import lm as LM

    full = LM.moshi_v0_1_streaming(num_slices)
    t = dataclasses.replace(full.transformer, d_model=256, num_heads=2, num_layers=2,
                            dim_feedforward=512, context=64)
    d = full.depformer
    return dataclasses.replace(
        full, transformer=t, text_in_vocab_size=301, text_out_vocab_size=300,
        depformer=dataclasses.replace(d, transformer=dataclasses.replace(
            d.transformer, d_model=64, num_heads=2, num_layers=2, dim_feedforward=128)))


@pytest.mark.cuda
def test_generate_on_the_card_does_not_depend_on_the_chunk(cuda_device):
    """``lm_gen_simple.generate`` on the card, bf16 weights and rings (the
    LM's rings through ``rope_commit``): the same tokens at chunk 1, 4 and 12,
    one rope_commit a layer and step."""
    from dsm_tpu_torch.models import lm as LM
    from dsm_tpu_torch.sessions import lm_gen_simple as G

    lm = _cut_moshi()
    cfg = G.GenConfig(lm=lm, audio_delays=(0,) + (2,) * 15, text_start_token=lm.text_start_token,
                      max_steps=20)
    params = {"lm": LM.init(lm, torch.Generator(device=cuda_device).manual_seed(0),
                            dtype=torch.bfloat16)}
    before = RK.rope_commit.launches
    runs = [G.generate(cfg, params, 12, seed=5, forced_text=[7, G.ZERO], chunk=c)
            for c in (1, 4, 12)]
    assert RK.rope_commit.launches - before == 3 * 12 * lm.transformer.num_layers
    for texts, frames in runs[1:]:
        assert texts == runs[0][0] and np.array_equal(frames, runs[0][1])
    assert runs[0][0][0] == 7 and runs[0][1].shape == (10, 16)


@pytest.mark.cuda
def test_offline_transcription_on_the_card_equals_the_frame_at_a_time_path(cuda_device,
                                                                            tmp_path):
    """``offline.transcribe_file`` (the step captured and replayed 50 frames a
    dispatch) bit for bit the eager frame-at-a-time path, VAD steps
    included; two files on the batch dimension give the same words, and
    bit for bit what the eager B=2 step gives; one file twice at B=2 gives
    two equal rows."""
    import tomllib

    from dsm_tpu_torch import offline
    from dsm_tpu_torch.server import builder as B
    from dsm_tpu_torch.server import config as CFG
    from dsm_tpu_torch.utils.audio import write_wav

    with open("configs/config-smoke.toml", "rb") as f:
        raw = tomllib.load(f)
    mod = CFG.Config.from_dict(raw).modules["asr"]
    mod.batch_size = 1
    engine = B.build_batched_asr(mod, cuda_device, cuda_graph=False)
    rng = np.random.default_rng(0)
    paths = []
    for i, secs in enumerate((1.5, 0.7)):
        paths.append(str(tmp_path / f"{i}.wav"))
        write_wav(paths[-1], rng.standard_normal(int(24_000 * secs)) * 0.2, 24_000)
        got = offline.transcribe_file(paths[-1], engine=engine, vad=True)
        assert got == offline.transcribe_per_frame(paths[-1], engine, vad=True)
        frames = int(24_000 * secs) // 1920 + engine.cfg.asr_delay_in_tokens + 8
        assert len(got["vad"]) == frames
    batched = offline.transcribe_files(paths, engine=engine, vad=True)
    assert batched == offline.transcribe_files(paths, engine=engine, vad=True, cuda_graph=False)
    twin = offline.transcribe_files(paths[:1] * 2, engine=engine, vad=True)
    assert twin[0] == twin[1]
    for p, r in zip(paths, batched):
        solo = offline.transcribe_file(p, engine=engine, vad=True)
        assert r["words"] == solo["words"]
        assert [v["step_idx"] for v in r["vad"]] == [v["step_idx"] for v in solo["vad"]]
