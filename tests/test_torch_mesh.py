"""The port's device mesh (``dsm_tpu_torch/parallel/mesh.py``) against the
JAX package's on the CPU, on the 8-device virtual JAX mesh of
``tests/conftest.py`` and port meshes that repeat the CPU device: the mesh's
validation, the tp permutation and the shards of params and states bit for
bit the JAX shards (``addressable_shards``), the three tp joins of
``transformer.step`` against ``dp_tp_shard_step``, the ASR step at dp=4 x
tp=2 with int8 weights (weight-only and W8A8) token for token against the
jitted JAX meshed step, the batched ASR engine at dp=8 and dp=4 x tp=2
event for event against the JAX meshed engine and the port's unmeshed one,
and the sampler's row offset that lets a dp shard draw its rows of the
batch's draw.  The TTS and duplex engines and the builders are in
``tests/test_torch_mesh_engines.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import qmm as jqmm
from dsm_tpu.ops import transformer as jT
from dsm_tpu.parallel import mesh as jM
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxAsrEngine
from dsm_tpu.sessions import asr as jASR
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.parallel import mesh as tM
from dsm_tpu_torch.server import batched_asr as tBA
from dsm_tpu_torch.sessions import asr as tASR
from tests.test_torch_asr_pipeline import _serve, _small_asr
from tests.test_torch_ops import to_port
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg, port_tcfg

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return jM.make_mesh(dp=4, tp=2)


@pytest.fixture
def jax_w8a8():
    """The JAX package's process-wide W8A8 switch, put back afterwards."""
    yield jqmm
    jqmm.set_w8a8_default(False)
    jqmm.set_w8a8_sites(None)


def _leaves(tree, path=""):
    """``(path, tensor)`` of a port tree, in order (non-tensor leaves kept as
    they are: the ring tick, an int8 weight's profile)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _same_trees(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)
        else:
            assert a == b, path


def _jax_shard(tree, device):
    """The numpy tree of each leaf's shard on ``device``."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)),
        tree)


# ---------------------------------------------------------------------------
# The mesh and its rules
# ---------------------------------------------------------------------------


def test_make_mesh_validates_as_the_jax_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    for make in (lambda **kw: jM.make_mesh(**kw), lambda **kw: tM.make_mesh(devices=CPU8, **kw)):
        with pytest.raises(ValueError, match="devices"):
            make(dp=9, tp=1)
        with pytest.raises(ValueError, match="devices"):
            make(dp=3, tp=3)
        assert dict(make(dp=3, tp=2).shape) == {"dp": 3, "tp": 2}  # a subset is valid
        assert dict(make(tp=2).shape) == {"dp": 4, "tp": 2}  # dp = n // tp
    m = tM.make_mesh(dp=2, tp=2, devices=["cpu", "cpu", "cpu", "cpu", "meta"])
    assert m.devices == ((torch.device("cpu"),) * 2,) * 2  # the leading dp * tp, rows of tp
    # The default devices are the CUDA cards: none here, so any mesh raises.
    with pytest.raises(ValueError, match=f"> {torch.cuda.device_count()} devices"):
        tM.make_mesh(dp=torch.cuda.device_count() + 1)


def _lm_params(variant):
    """An LM with every kind of split leaf: cross-attention, attention
    biases, the gated MLP (``plain_mlp``: linear1/linear2), a DepFormer that
    stays whole; ``int8``: its main transformer quantised."""
    tcfg = jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64,
                                context=16, bias_attn=True, cross_attention=True, ca_dim=16,
                                gating=variant != "plain_mlp")
    dep = jLM.DepFormerConfig(transformer=jT.TransformerConfig(
        d_model=16, num_heads=2, num_layers=2, dim_feedforward=48, context=2,
        positional_embedding="none"), num_slices=2)
    cfg = jLM.LmConfig(transformer=tcfg, depformer=dep, text_in_vocab_size=17,
                       text_out_vocab_size=16, audio_vocab_size=9, audio_codebooks=2)
    lm = jLM.init(cfg, jax.random.PRNGKey(3))
    if variant == "int8":
        # Every matrix, none of the (L, O) biases.
        lm = dict(lm, transformer=jT.quantize_weights(lm["transformer"], min_size=256))
        assert isinstance(lm["transformer"]["out_proj_w"], dict)
        assert not isinstance(lm["transformer"]["in_proj_b"], dict)
    return {"lm": lm, "mimi": {"transformer": {"in_proj_w": jnp.ones((6, 4))}}}


@pytest.mark.parametrize("variant", ["dense", "int8", "plain_mlp"])
def test_tp_params_are_the_jax_shards_bit_for_bit(jmesh, variant):
    """``permute_tp_params`` then ``tp_shard_params`` give each tp shard the
    JAX ``place_tp_params(permute_tp_params(...))`` shard: the [q|k|v],
    [k|v] and [a|b] interleave, rows and columns, an int8 weight's ``q``
    rows with their ``s`` (whole where its columns split); the codec and the
    DepFormer whole."""
    params = _lm_params(variant)
    placed = jM.place_tp_params(jmesh, jM.permute_tp_params(params, 2))
    permuted = tM.permute_tp_params(to_port(params), 2)
    for t in range(2):
        want = to_port(_jax_shard(placed, jmesh.devices[0, t]))
        got = tM.tp_shard_params(permuted, 2, t)
        _same_trees(got, want)
        if variant != "plain_mlp":
            layer = got["lm"]["transformer"][1]
            w = layer["in_proj_w"]["q"] if variant == "int8" else layer["in_proj_w"]
            assert w.shape == (3 * 2 * 8, 32)  # 2 of 4 heads x 8 dims, q, k and v


def test_state_shards_are_the_jax_shards_bit_for_bit(jmesh):
    """``state_shard`` of an ASR state: the LM rings over (dp, tp), every
    batch-leading leaf over dp, the tick whole (JAX ``place_dp_tp_state``),
    and a generator key whole even where the batch is 2."""
    acfg, _, _ = _small_asr()
    acfg = dataclasses.replace(acfg, lm=dataclasses.replace(
        acfg.lm, transformer=dataclasses.replace(acfg.lm.transformer, num_heads=4)))
    state = jASR.init_state(acfg, 8, jnp.float32)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.integers(0, 100, a.shape).astype(a.dtype)), state)
    placed = jM.place_dp_tp_state(jmesh, state, 8, 4)
    port = to_port(state)
    for d in range(4):
        for t in range(2):
            want = to_port(_jax_shard(placed, jmesh.devices[d, t]))
            got = tM.state_shard(port, 4, 2, d, t, 8, 4)
            _same_trees(got, want)
    assert got["lm"]["t"]["layers"][0]["k"].shape[:2] == (2, 2)
    key = tS.prng_key(5)
    assert tM.state_shard({"rng": key}, 2, 1, 1, 0, 2, 4)["rng"] is key


def test_tp_local_config_and_the_engines_checks():
    tcfg = tT.TransformerConfig(d_model=64, num_heads=4, num_layers=1, dim_feedforward=128,
                                context=8)
    local = tM.tp_local_transformer_cfg(tcfg, 2)
    jlocal = jM.tp_local_transformer_cfg(
        jT.TransformerConfig(d_model=64, num_heads=4, num_layers=1, dim_feedforward=128,
                             context=8), 2)
    want = dataclasses.replace(port_tcfg(jlocal), tp_shard=jlocal.tp_axis == "tp")
    assert local == want and (local.num_heads, local.hd, local.tp_shard) == (2, 16, True)
    with pytest.raises(ValueError, match="not divisible"):
        tM.tp_local_transformer_cfg(tcfg, 3)
    mesh = tM.make_mesh(dp=2, tp=2, devices=CPU8)
    with pytest.raises(ValueError, match="batch 3 not divisible by dp=2"):
        tM.check_divisible(mesh, 3, 4)
    with pytest.raises(ValueError, match="num_heads 6 not divisible by tp=4"):
        tM.check_divisible(tM.make_mesh(dp=1, tp=4, devices=CPU8), 4, 6)
    # The captured step: on CUDA by default, under tp too where a replica's tp
    # shards share a device; a replica across devices runs eagerly, and asked
    # for there, the graph raises.
    cuda = torch.device("cuda", 0)
    assert tM.pick_cuda_graph(None, cuda, tM.make_mesh(dp=2, devices=CPU8), "asr")
    assert tM.pick_cuda_graph(None, cuda, mesh, "asr")
    assert tM.pick_cuda_graph(True, cuda, mesh, "asr")
    across = tM.make_mesh(dp=1, tp=2, devices=["cuda:0", "cuda:1"])
    assert not tM.pick_cuda_graph(None, cuda, across, "asr")
    with pytest.raises(ValueError, match="tp=2 replica across cards"):
        tM.pick_cuda_graph(True, cuda, across, "asr")
    with pytest.raises(ValueError, match="no CUDA graph on cpu"):
        tM.pick_cuda_graph(True, torch.device("cpu"), None, "asr")


def test_all_reduce_needs_a_shard_and_sums_in_shard_order():
    with pytest.raises(RuntimeError, match="outside a tp shard"):
        tM.all_reduce(torch.ones(2))
    mesh = tM.make_mesh(dp=2, tp=4, devices=CPU8)
    parts = [[torch.tensor([1e8, 1.0]) * (d + 1) * (-1) ** t for t in range(4)]
             for d in range(2)]
    runner = tM.ShardRunner(mesh, parts)
    for _ in range(3):  # the slots come round again
        out = runner.run(lambda d, t, p: tM.all_reduce(p + t))
    for d in range(2):
        want = ((parts[d][0] + parts[d][1] + 1) + (parts[d][2] + 2)) + (parts[d][3] + 3)
        for t in range(4):
            np.testing.assert_array_equal(out[d][t].numpy(), want.numpy())

    def fail(d, t, p):
        if t == 1:
            raise KeyError("shard 1")
        return tM.all_reduce(p)

    with pytest.raises(KeyError, match="shard 1"):  # the peers do not wait for ever
        runner.run(fail)
    assert runner.run(lambda d, t, p: tM.all_reduce(p))[1][2].shape == (2,)
    runner.close()


def test_all_reduce_holds_with_more_threads_than_cores_switching_often():
    """12 tp shards (more threads than cores) through 40 joins in a row with
    the interpreter switching threads every microsecond: every shard gets
    each join's sum of that join's partials (a slot reused before every
    shard had read it would mix two joins), and the run ends in time."""
    import sys
    import threading

    mesh = tM.make_mesh(dp=1, tp=12, devices=["cpu"] * 12)
    runner = tM.ShardRunner(mesh, [[None] * 12])
    out = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=lambda: out.extend(runner.run(
            lambda d, t, _: [float(tM.all_reduce(torch.tensor([t + 100.0 * j])))
                             for j in range(40)])))
        th.start()
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        runner.close()
    want = [sum(t + 100.0 * j for t in range(12)) for j in range(40)]
    assert out and all(row == want for row in out[0])


def test_merge_packed_is_the_unmeshed_layout():
    shards = [np.array([1, 2, 10, 20, 100, 101, 200, 201]),
              np.array([3, 4, 30, 40, 300, 301, 400, 401])]
    got = tM.merge_packed(shards, 2, (1, 1, None))
    assert got.tolist() == [1, 2, 3, 4, 10, 20, 30, 40, 100, 101, 200, 201, 300, 301, 400, 401]
    rows = tM.merge_packed([s.reshape(2, 4) for s in shards], 2, (1, None))
    assert rows.tolist() == [[1, 2, 3, 4, 10, 20, 30, 40], [100, 101, 300, 301, 200, 201, 400, 401]]


def test_a_shards_draw_is_its_rows_of_the_batch_draw():
    """The bits depend on the flat index alone (threefry's partitionable
    form): rows ``row0 ..`` of a (B, V) draw are the shard's draw at
    ``row0``, so dp shards sample the unmeshed batch's tokens."""
    key = tS.prng_key(11)
    full = tS.gumbel(key, (8, 37))
    for d in range(4):
        np.testing.assert_array_equal(tS.gumbel(key, (2, 37), row0=2 * d).numpy(),
                                      full[2 * d:2 * d + 2].numpy())
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (8, 37)))
    np.testing.assert_array_equal(full.numpy(), want)
    logits = torch.randn(8, 37, generator=torch.Generator().manual_seed(0))
    cfg = tS.SamplingConfig(temperature=0.8)
    whole = tS.sample(cfg, logits, key)
    assert torch.equal(torch.cat([tS.sample(cfg, logits[2 * d:2 * d + 2], key, row0=2 * d)
                                  for d in range(4)]), whole)


# ---------------------------------------------------------------------------
# transformer.step's joins and the ASR step at dp x tp
# ---------------------------------------------------------------------------


def _jax_dp_tp(jmesh, local_cfg_fn, global_cfg_fn, params, state, batch, heads, *args):
    return jax.jit(jM.dp_tp_shard_step(jmesh, local_cfg_fn, global_cfg_fn, batch, heads,
                                       params, state, *args))


def _port_shards(mesh, params, init_state):
    """``(params_t, state_dt)`` a shard: the tp slice of the permuted params,
    a fresh state at the shard's batch and heads."""
    permuted = tM.permute_tp_params(params, mesh.tp)
    return [[(tM.tp_shard_params(permuted, mesh.tp, t), init_state())
             for t in range(mesh.tp)] for _ in range(mesh.dp)]


def test_tp_transformer_step_matches_the_jax_dp_tp_shard_step(jmesh):
    """dp=4 x tp=2, 3 steps: the out_proj join before its bias, the MLP join
    before ``layer_scale_2``; outputs and every shard's rings against the
    JAX shard_map step, and every tp shard of a replica alike."""
    jcfg = jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64,
                                context=16, bias_attn=True, layer_scale=0.3)
    jlocal = jM.tp_local_transformer_cfg(jcfg, 2)
    params = {"lm": {"transformer": jT.init(jcfg, jax.random.PRNGKey(1))}}
    params["lm"]["transformer"]["out_proj_b"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(2), params["lm"]["transformer"]["out_proj_b"].shape)
    b = 8
    state0 = {"lm": jT.init_state(jcfg, b, jnp.float32)}
    xs = np.random.default_rng(0).standard_normal((3, b, 1, 32)).astype(np.float32)

    def local(p, s, x):
        y, st = jT.step(jlocal, p["lm"]["transformer"], s["lm"], x)
        return y, {"lm": st}

    def glob(p, s, x):
        y, st = jT.step(jcfg, p["lm"]["transformer"], s["lm"], x)
        return y, {"lm": st}

    pparams = jM.permute_tp_params(params, 2)
    step = _jax_dp_tp(jmesh, local, glob, pparams, state0, b, 4, jnp.asarray(xs[0]))
    mesh = tM.make_mesh(dp=4, tp=2, devices=CPU8)
    tlocal = tM.tp_local_transformer_cfg(port_tcfg(jcfg), 2)
    shards = _port_shards(mesh, to_port(params),
                          lambda: {"lm": tT.init_state(tlocal, 2, torch.float32)})
    runner = tM.ShardRunner(mesh, shards)
    js = state0
    for i in range(3):
        yj, js = step(pparams, js, jnp.asarray(xs[i]))

        def run(d, t, sh, i=i):
            y, st = tT.step(tlocal, sh[0]["lm"]["transformer"], sh[1]["lm"],
                            torch.from_numpy(xs[i, 2 * d:2 * d + 2]))
            sh[1]["lm"] = st
            return y

        out = runner.run(run)
        for d in range(4):
            assert torch.equal(out[d][0], out[d][1])
        got = torch.cat([row[0] for row in out]).numpy()
        np.testing.assert_allclose(got, np.asarray(yj), rtol=0, atol=2e-6)
    placed = jax.tree_util.tree_map(np.asarray, js)
    for d in range(4):
        for t in range(2):
            want = _jax_shard(js, jmesh.devices[d, t])["lm"]["layers"][1]["k"]
            np.testing.assert_allclose(shards[d][t][1]["lm"]["layers"][1]["k"].numpy(), want,
                                       rtol=0, atol=2e-6)
    assert placed["lm"]["layers"][0]["k"].shape == (8, 4, 32, 8)
    runner.close()


def test_tp_cross_attention_join_matches_the_unsplit_step():
    """The ``ca_out`` join (summed before the gate, which reads the
    replicated ``xn``): a tp=2 step with a voice split over heads against
    the one-device step."""
    jcfg = jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64,
                                context=16, cross_attention=True, ca_dim=16,
                                ca_gating="conditional_tanh")
    params = {"lm": to_port({"transformer": jT.init(jcfg, jax.random.PRNGKey(4))})}
    cfg = port_tcfg(jcfg)
    lp = params["lm"]["transformer"]
    src = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 6, 16)).astype(np.float32))
    ca_k, ca_v = tT.precompute_ca_kv(cfg, lp, src)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 2, 1, 32)).astype(np.float32))
    want_state = tT.init_state(cfg, 2, torch.float32)
    mesh = tM.make_mesh(dp=1, tp=2, devices=CPU8)
    local = tM.tp_local_transformer_cfg(cfg, 2)
    shards = _port_shards(mesh, params, lambda: {"t": tT.init_state(local, 2, torch.float32)})
    runner = tM.ShardRunner(mesh, shards)
    for i in range(3):
        want, want_state = tT.step(cfg, lp, want_state, x[i], ca_kv=(ca_k, ca_v))

        def run(d, t, sh, i=i):
            heads = slice(2 * t, 2 * t + 2)
            y, sh[1]["t"] = tT.step(local, sh[0]["lm"]["transformer"], sh[1]["t"], x[i],
                                    ca_kv=(ca_k[:, :, heads], ca_v[:, :, heads]))
            return y

        out = runner.run(run)[0]
        assert torch.equal(out[0], out[1])
        np.testing.assert_allclose(out[0].numpy(), want.numpy(), rtol=0, atol=2e-6)
    runner.close()


@pytest.mark.parametrize("profile", ["weight_only", "w8a8"])
def test_asr_step_at_dp4_tp2_with_int8_weights_is_the_jax_meshed_step(jmesh, jax_w8a8,
                                                                      profile):
    """The serving profile's int8 weights under tp: each shard quantises its
    slice of the activation row at the row-parallel products (W8A8), as the
    JAX meshed step does.  Three greedy steps, the text tokens of the
    jitted JAX ``dp_tp_shard_step`` token for token, and the VAD heads'
    probabilities within 1e-5."""
    jcfg, _, _ = _small_asr()
    # An MLP hidden of 352 (176 a shard): the int8 GEMM takes widths of 8.
    jcfg = dataclasses.replace(jcfg, temperature=0.0, lm=dataclasses.replace(
        jcfg.lm, transformer=dataclasses.replace(jcfg.lm.transformer, dim_feedforward=512)))
    tcfg = _fields(tASR.AsrConfig, jcfg, lm=port_lm_cfg(jcfg.lm), mimi=port_mimi_cfg(jcfg.mimi))
    key = jax.random.PRNGKey(5)
    params = {"lm": jLM.init(jcfg.lm, key),
              "mimi": jMIMI.init(jcfg.mimi, jax.random.fold_in(key, 1))}
    w8a8 = profile == "w8a8"
    jax_w8a8.set_w8a8_default(w8a8)
    params_q = {"mimi": params["mimi"], "lm": dict(
        params["lm"], transformer=jT.quantize_weights(params["lm"]["transformer"], min_size=0))}
    jlocal = dataclasses.replace(jcfg, lm=dataclasses.replace(
        jcfg.lm, transformer=jM.tp_local_transformer_cfg(jcfg.lm.transformer, 2)))
    b = 8
    pcm = (np.random.default_rng(1).standard_normal((3, b, 1, jcfg.mimi.frame_size))
           .astype(np.float32) * 0.1)
    mask, reset = np.ones(b, bool), np.zeros(b, bool)
    seeds = np.arange(b, dtype=np.uint32)
    rng = jax.random.PRNGKey(7)

    def local(p, s, x, m, r, k, sd):
        return jASR.step(jlocal, p, s, x, m, r, k, seeds=sd)

    def glob(p, s, x, m, r, k, sd):
        return jASR.step(jcfg, p, s, x, m, r, k, seeds=sd)

    pparams = jM.permute_tp_params(params_q, 2)
    state = jASR.init_state(jcfg, b, jnp.float32)
    args = (jnp.asarray(pcm[0]), jnp.asarray(mask), jnp.asarray(reset), rng, jnp.asarray(seeds))
    step = _jax_dp_tp(jmesh, local, glob, pparams, state, b, 2, *args)

    mesh = tM.make_mesh(dp=4, tp=2, devices=CPU8)
    tlocal = dataclasses.replace(tcfg, lm=dataclasses.replace(
        tcfg.lm, transformer=tM.tp_local_transformer_cfg(tcfg.lm.transformer, 2)))
    tparams = to_port(params)
    tparams["lm"]["transformer"] = tT.quantize_weights(tparams["lm"]["transformer"], min_size=0,
                                                       w8a8=w8a8)
    shards = _port_shards(mesh, tparams, lambda: tASR.init_state(tlocal, 2, torch.float32))
    runner = tM.ShardRunner(mesh, shards)
    for i in range(3):
        out_j, state = step(pparams, state, jnp.asarray(pcm[i]), *args[1:])

        def run(d, t, sh, i=i):
            rows = slice(2 * d, 2 * d + 2)
            out, st = tASR.step(tlocal, sh[0], sh[1], torch.from_numpy(pcm[i, rows]),
                                torch.from_numpy(mask[rows]), torch.from_numpy(reset[rows]),
                                seeds=torch.from_numpy(seeds[rows].astype(np.int64)))
            sh[1].update(st)
            return out

        outs = runner.run(run)
        got = torch.cat([row[0]["text_token"] for row in outs]).numpy()
        assert [torch.equal(r[0]["text_token"], r[1]["text_token"]) for r in outs] == [True] * 4
        np.testing.assert_array_equal(got, np.asarray(out_j["text_token"]))
        prs = torch.cat([row[0]["prs"] for row in outs]).numpy()
        np.testing.assert_allclose(prs, np.asarray(out_j["prs"]), rtol=0, atol=1e-5)
    runner.close()


# ---------------------------------------------------------------------------
# The batched ASR engine on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2)])
def test_asr_engine_on_a_mesh_matches_the_jax_meshed_engine(dp, tp):
    """Eight slots (three streams with markers, one slot reused) on a dp x
    tp mesh of the CPU: events, markers and words equal to the JAX engine on
    the same mesh and to the port's unmeshed engine (per-slot keys: the
    meshed draws are the unmeshed ones); VAD probabilities within one 1e-6
    step of both."""
    jcfg, tcfg, params = _small_asr()
    frame = jcfg.mimi.frame_size
    kw = dict(batch_size=8, fill_gate_frac=0.0, use_native_packer=False, pipeline_depth=1)
    ej = JaxAsrEngine(jcfg, params, mesh=jM.make_mesh(dp=dp, tp=tp), **kw)
    et = tBA.BatchedAsrEngine(tcfg, to_port(params), device="cpu",
                              mesh=tM.make_mesh(dp, tp, devices=CPU8), **kw)
    assert et.state is None and len(et.shards) == dp and len(et.shards[0]) == tp
    assert et.shards[-1][-1].cfg.lm.transformer.num_heads == 2 // tp
    e1 = tBA.BatchedAsrEngine(tcfg, to_port(params), device="cpu", **kw)
    (got, got_prs), (want, want_prs), (one, one_prs) = (_serve(e, frame) for e in (et, ej, e1))
    assert got == want == one
    assert any(e[1] for evs in got.values() for e in evs), "no word came out"
    for i in got_prs:
        assert np.abs(got_prs[i] - want_prs[i]).max() <= 1.5e-6
        assert np.abs(got_prs[i] - one_prs[i]).max() <= 1.5e-6
    assert int(et.shards[0][0].state["lm"]["t"]["pos"]) > 64
