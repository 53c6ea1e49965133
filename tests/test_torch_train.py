"""The port's training step (``dsm_tpu_torch.train``) against the JAX
package's (``dsm_tpu.train``) on the CPU, at ``tests/test_lm.py``'s
``small_lm`` in f32, and the ring commit under autograd.

JAX weights are made with numpy from a seed (``test_torch_moshi.np_lm_params``)
and carried into the port through the bridge.  The DepFormer's ring is f32
(``T.init_state(..., cache_dtype=h.dtype)``), which the port's step could not
differentiate before ``ring_commit`` became an autograd Function.

Bars, each against the jitted JAX function: relative error 1e-5 on ``loss``,
``text_loss`` and ``audio_loss`` (measured: 0, the three losses bit for bit);
relative L2 1e-5 on every gradient leaf (measured at most 1.7e-6); relative
L2 1e-5 on every param leaf after 3 steps of ``make_train_step`` at the
default learning rate, with the global-norm clip taken and not taken
(measured at most 5.8e-7 and 2.5e-7; the losses of the 3 steps bit for bit),
and on a model with cross-attention leaves that get no gradient and only
decay (measured at most 6.3e-8; losses within 2.2e-7).  The ring commit's
plain backward equals autograd's gradient of an out-of-place ``index_copy``
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu import train as jtrain
from dsm_tpu_torch import train as ttrain
from dsm_tpu_torch.ops import attention as A
from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.ops import qmm as QM
from dsm_tpu_torch.ops import ring_kernels as RK
from tests.test_lm import small_lm
from tests.test_torch_moshi import np_lm_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_lm_cfg

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-5


def _cfgs(jlm, **kw):
    return jtrain.TrainConfig(lm=jlm, **kw), ttrain.TrainConfig(lm=port_lm_cfg(jlm), **kw)


def _batch(seed, b=2, t=8, text_vocab=10, audio_vocab=9, k=4):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, text_vocab, (b, t)).astype(np.int32)
    audio = rng.integers(0, audio_vocab, (b, t, k)).astype(np.int32)
    return ({"text": jnp.asarray(text), "audio": jnp.asarray(audio)},
            {"text": torch.from_numpy(text), "audio": torch.from_numpy(audio)})


def _pairs(tp, jt, path=""):
    """(path, port leaf, JAX leaf in the port's layout) for every leaf of
    the port tree ``tp``, matched by key and index."""
    if isinstance(tp, dict):
        for k, v in tp.items():
            yield from _pairs(v, jt[k], f"{path}/{k}")
    elif isinstance(tp, list):
        for i, v in enumerate(tp):
            yield from _pairs(v, jt[i], f"{path}/{i}")
    else:
        yield path, tp, jt


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def _worst(pairs) -> float:
    return max(_rel(a, b) for _, a, b in pairs)


@pytest.fixture(scope="module")
def small():
    """small_lm with the VAD heads (leaves with no gradient), f32 weights
    from numpy, and one batch."""
    jlm = small_lm(extra_heads=(2, 6))
    jp = np_lm_params(jlm, 0)
    jb, tb = _batch(0)
    return jlm, jp, jb, tb


def test_build_delayed_inputs_pattern():
    """``tests/test_train.py``'s pattern, on the port."""
    _, cfg = _cfgs(small_lm(), acoustic_delay=2)
    t, k = 6, 3
    text = torch.arange(1, t + 1, dtype=torch.int32)[None]
    audio = (torch.arange(t)[None, :, None] * 10 + torch.arange(k)).to(torch.int32)
    text_in, audio_in = ttrain.build_delayed_inputs(cfg, text, audio)
    assert text_in[0].tolist() == [cfg.lm.text_start_token, 1, 2, 3, 4, 5]
    pad = cfg.lm.audio_pad_token
    assert audio_in[0, :, 0].tolist() == [pad, 0, 10, 20, 30, 40]
    assert audio_in[0, :, 1].tolist() == [pad, pad, pad, 1, 11, 21]
    assert audio_in[0, :, 2].tolist() == [pad, pad, pad, 2, 12, 22]
    assert text_in.dtype == audio_in.dtype == torch.int32


@pytest.mark.parametrize("delay", [0, 2, 5])
def test_build_delayed_inputs_matches_jax(delay):
    jcfg, tcfg = _cfgs(small_lm(), acoustic_delay=delay)
    jb, tb = _batch(delay, b=3, t=9, k=4)
    jt, ja = jtrain.build_delayed_inputs(jcfg, jb["text"], jb["audio"])
    tt, ta = ttrain.build_delayed_inputs(tcfg, tb["text"], tb["audio"])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_losses_and_every_gradient_leaf_match_jax(small):
    jlm, jp, jb, tb = small
    jcfg, tcfg = _cfgs(jlm)
    fn = jax.jit(jax.value_and_grad(lambda p: jtrain.loss_fn(jcfg, p, jb), has_aux=True))
    (jl, jaux), jg = fn(jp)
    tp = to_port(jp)
    for p in ttrain.leaves(tp):
        p.requires_grad_(True)
    tl, taux = ttrain.loss_fn(tcfg, tp, tb)
    tl.backward()
    tl, taux = tl.detach(), {k: v.detach() for k, v in taux.items()}
    for got, want in ((tl, jl), (taux["text_loss"], jaux["text_loss"]),
                      (taux["audio_loss"], jaux["audio_loss"])):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    grads = []
    for path, p, g in _pairs(tp, to_port(jg)):
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        grads.append((path, got, g))
        if "extra_heads" in path:  # no gradient reaches the VAD heads
            assert p.grad is None and not g.any()
    # Every element of the JAX tree (layers stacked there) has its port leaf.
    assert sum(x.numel() for _, x, _ in grads) == sum(
        x.size for x in jax.tree_util.tree_leaves(jp))
    worst = _worst(grads)
    assert worst <= LEAF_RTOL, worst
    # The DepFormer's layers, stepped over the f32 ring, got their gradients.
    dep = [x for path, x, _ in grads if path.startswith("/depformer/transformer")]
    assert dep and all(x.any() for x in dep)


def _steps(jlm, n, seed=0, **kw):
    """``n`` steps of each side's train step on one batch -> the losses and
    the (path, port param, JAX param) pairs after them."""
    jcfg, tcfg = _cfgs(jlm, **kw)
    jp = np_lm_params(jlm, seed)
    tp = to_port(jp)
    jb, tb = _batch(seed)
    opt = jtrain.make_optimizer(jcfg)
    jstate = opt.init(jp)
    jstep = jtrain.make_train_step(jcfg, opt)
    jp = jax.tree_util.tree_map(jnp.array, jp)  # the step donates its params
    topt = ttrain.make_optimizer(tcfg)
    tstate = topt.init(tp)
    tstep = ttrain.make_train_step(tcfg, topt)
    losses = []
    for _ in range(n):
        jp, jstate, jl, _ = jstep(jp, jstate, jb)
        tp2, tstate2, tl, _ = tstep(tp, tstate, tb)
        assert tp2 is tp and tstate2 is tstate  # updated in place
        losses.append((float(tl), float(jl)))
    return losses, list(_pairs(tp, to_port(jp)))


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
def test_params_after_three_steps_match_jax(clip):
    """The global norm of small_lm's gradient at this batch is some 2.9: a
    clip of 0.5 scales every step's gradient, one of 100 none."""
    jlm = small_lm(extra_heads=(2, 6))
    grad_clip = 0.5 if clip == "clipped" else 100.0
    _, tcfg = _cfgs(jlm)
    tp = to_port(np_lm_params(jlm, 0))
    for p in ttrain.leaves(tp):
        p.requires_grad_(True)
    ttrain.loss_fn(tcfg, tp, _batch(0)[1])[0].backward()
    g_norm = float(torch.stack([p.grad.norm() for p in ttrain.leaves(tp)
                                if p.grad is not None]).norm())
    assert (g_norm > grad_clip) == (clip == "clipped"), g_norm
    losses, pairs = _steps(jlm, 3, grad_clip=grad_clip)
    for got, want in losses:
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    worst = _worst(pairs)
    assert worst <= LEAF_RTOL, worst


def test_leaves_without_gradient_decay_as_optax():
    """small_lm with cross-attention: the loss passes no voice, so the CA
    leaves get no gradient; optax's adamw still decays them (torch's AdamW
    would skip them)."""
    jlm = small_lm(ca=True)
    p0 = to_port(np_lm_params(jlm, 1))
    losses, pairs = _steps(jlm, 3, seed=1, weight_decay=0.1)
    ca = [(path, a, b) for path, a, b in pairs if "/ca_" in path or "norm_cross" in path]
    assert ca
    for path, a, _ in ca:
        before = dict((q, x) for q, x, _ in _pairs(p0, p0))[path]
        assert not torch.equal(a.detach(), before), path  # decayed
    worst = _worst(pairs)
    assert worst <= LEAF_RTOL, worst
    for got, want in losses:
        assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_loss_decreases():
    """``tests/test_train.py::test_loss_decreases`` on the port."""
    jlm = small_lm()
    _, cfg = _cfgs(jlm, learning_rate=3e-3)
    params = to_port(np_lm_params(jlm, 0))
    _, batch = _batch(0, k=4)
    batch["audio"] = batch["audio"] % 7
    opt = ttrain.make_optimizer(cfg)
    state = opt.init(params)
    step = ttrain.make_train_step(cfg, opt)
    losses = []
    for _ in range(8):
        params, state, loss, aux = step(params, state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    assert "audio_loss" in aux


# ---------------------------------------------------------------------------
# The ring commit under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,w", [(1, 0), (1, 16), (1, 31), (2, 0), (2, 14), (2, 30)])
def test_ring_commit_backward_matches_out_of_place_index_copy(dtype, t, w):
    """Commit into a ring that carries a gradient, read the ring, then commit
    again and read it again: the gradients of the ring before the commits and
    of every committed row equal those of the same function written with
    out-of-place ``index_copy``, bit for bit."""
    b, h, c, dh = 2, 3, 32, 8
    g = torch.Generator().manual_seed(w * 10 + t)
    base = torch.randn(b, h, c, dh, generator=g).to(dtype)
    rows = [torch.randn(b, h, t, dh, generator=g).to(dtype) for _ in range(4)]
    weight = torch.randn(b, h, c, dh, generator=g)
    w2 = (w + t) % c

    def run(commit):
        leaf = base.clone().requires_grad_(True)
        news = [x.clone().requires_grad_(True) for x in rows]
        k, v = leaf * 1, leaf * 2
        k, v = commit(k, v, news[0], news[1], w)
        # f32 rings are read through a copy (A._ring_f32): the square saves it
        loss = (k.float() * weight).sum() + (A._ring_f32(v, torch.float32) ** 2).sum()
        k, v = commit(k, v, news[2], news[3], w2)
        loss = loss + (k.float() * weight * 3).sum() + (v.float() * weight).sum()
        loss.backward()
        return [leaf.grad] + [x.grad for x in news]

    def in_place(k, v, kn, vn, at):
        RK.ring_commit(k, v, kn, vn, torch.tensor(at, dtype=torch.int32))
        assert type(k.grad_fn).__name__ == "_RingCommitBackward"
        return k, v

    def out_of_place(k, v, kn, vn, at):
        idx = torch.arange(at, at + t)
        return k.index_copy(2, idx, kn), v.index_copy(2, idx, vn)

    for got, want in zip(run(in_place), run(out_of_place)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_ring_commit_backward_plain_splits_the_gradient():
    g, gv = torch.randn(2, 2, 8, 4), torch.randn(2, 2, 8, 4)
    keep = g.clone(), gv.clone()
    gk_old, gv_old, gk_new, gv_new = RK.ring_commit_backward(
        g, gv, torch.tensor(4, dtype=torch.int32), 2)
    assert torch.equal(gk_new, g[:, :, 4:6]) and torch.equal(gv_new, gv[:, :, 4:6])
    assert not gk_old[:, :, 4:6].any() and not gv_old[:, :, 4:6].any()
    assert torch.equal(gk_old[:, :, :4], g[:, :, :4])
    assert torch.equal(gv_old[:, :, 6:], gv[:, :, 6:])
    assert torch.equal(g, keep[0]) and torch.equal(gv, keep[1])  # read, not written
    with pytest.raises(ValueError):  # pos % T != 0
        RK.ring_commit_backward(g, gv, torch.tensor(3, dtype=torch.int32), 2)


def test_ring_commit_without_autograd_stays_plain():
    """Serving: grad mode off, or nothing that requires a gradient, touches
    no autograd Function."""
    kc, vc = torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 8, 4)
    new = torch.randn(1, 2, 1, 4, requires_grad=True)
    with torch.no_grad():
        RK.ring_commit(kc, vc, new, new, torch.tensor(3, dtype=torch.int32))
    RK.ring_commit(kc, vc, new.detach(), new.detach(), torch.tensor(4, dtype=torch.int32))
    assert kc.grad_fn is None and not kc.requires_grad
    assert torch.equal(kc[:, :, 3:5], torch.cat([new.detach()] * 2, dim=2))


def test_f32_ring_read_under_autograd_saves_a_copy():
    """attend_global_split over an f32 ring that a later commit overwrites in
    place: the backward runs (it raised on the version counter before)."""
    b, h, c, dh = 2, 2, 32, 8
    kc, vc = torch.zeros(b, h, c, dh), torch.zeros(b, h, c, dh)
    q = torch.randn(b, h, 1, dh, requires_grad=True)
    pos = torch.zeros((), dtype=torch.int32)
    valid = torch.zeros(b, c, dtype=torch.bool)
    outs = []
    for i in range(3):
        rows = torch.randn(b, h, 1, dh, requires_grad=True)
        plan = A.global_ring_plan(pos, c, 1)
        RK.ring_commit(kc, vc, rows * q, rows, pos)
        outs.append(A.attend_global_split(q, kc, vc, rows * q, rows, plan, valid, window=c))
        valid = A.update_valid_bitmap(valid, plan["w"], None)
        pos = plan["new_pos"]
    torch.stack(outs).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# Kernels without a backward raise under autograd
# ---------------------------------------------------------------------------


def _int8_rings(b, h, c, dh):
    return (torch.zeros(b, h, c, dh, dtype=torch.int8), torch.zeros(b, h, c, dh, dtype=torch.int8),
            torch.zeros(b, h, c), torch.zeros(b, h, c))


def _no_backward_calls():
    b, h, c, dh = 1, 2, 32, 8
    tick = torch.zeros((), dtype=torch.int32)
    q, k, v = (torch.randn(b, h, 1, dh, requires_grad=True) for _ in range(3))
    cos, sin = A.rope_cos_sin(torch.zeros(1, 1, dtype=torch.int32), dh, 10_000.0)
    kc, vc = torch.zeros(b, h, c, dh), torch.zeros(b, h, c, dh)
    kq, vq, ks, vs = _int8_rings(b, h, c, dh)
    plan = A.global_ring_plan(tick, c, 1)
    valid = torch.ones(b, c, dtype=torch.bool)
    x = torch.randn(3, 16, requires_grad=True)
    wq = torch.ones(4, 16, dtype=torch.int8)
    return {
        "rope_commit": lambda: RK.rope_commit(q, k, v, kc, vc, cos, sin, tick),
        "rope_qk": lambda: RK.rope_qk(q, k, cos, sin),
        "quantize_commit": lambda: RK.quantize_commit(k, v, kq, vq, ks, vs, tick),
        "quantize_scale_commit": lambda: RK.quantize_scale_commit(k, v, ks, vs, tick),
        "decode_attend": lambda: DA.decode_attend(q, kq, vq, ks, vs, k, v, plan, valid,
                                                  window=c),
        "decode_attend_commit": lambda: DA.decode_attend_commit(
            q, kq, vq, ks, vs, kq[:, :, :1], vq[:, :, :1], k, v, plan, valid, window=c),
        "ca_decode_attend": lambda: DA.ca_decode_attend(q, kq, vq, ks, vs, c),
        "qmm": lambda: QM.qmm(x, wq, torch.ones(4)),
    }


@pytest.mark.parametrize("name", list(_no_backward_calls()))
def test_kernels_without_a_backward_raise_under_autograd(name):
    """On the CPU through their plain routes; the wrappers run the same
    check on the card before any launch."""
    call = _no_backward_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    with torch.no_grad():
        call()  # without autograd the plain route runs
