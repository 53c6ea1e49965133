"""The port's checkpoint loaders (``dsm_tpu_torch/utils/checkpoint.py``)
against the JAX package's.

Reference-layout files are written by the test itself from JAX-initialised
trees at small sizes (``lm_params_to_reference`` / ``mimi_params_to_reference``
of the JAX package), in f32 and in bf16.  Bars, all exact:

* the port's ``build_lm_params`` / ``build_mimi_params`` equal
  ``bridge.from_numpy_tree`` of the JAX loaders' output bit for bit on every
  leaf, with the same dtypes and the same tree (cross-attention, extra
  heads, low-rank DepFormer embeddings, the root-level and shared DepFormer
  fallbacks, weight-norm convs); a missing key raises the JAX loader's
  ``KeyError`` message;
* the port's ``*_params_to_reference`` equals the JAX export key for key and
  bit for bit;
* stt-1b at full size: export and reimport give every leaf back bit for bit
  (bf16);
* the port's safetensors reader equals ``safetensors.numpy.load_file`` on
  BF16 (widened to f32), F16, F32 and I8, its writer's files read back
  bit for bit by the package, and neither needs the package;
* native checkpoints round-trip bit for bit.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import transformer as jT
from dsm_tpu.utils import checkpoint as jCK
from dsm_tpu_torch import bridge
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.utils import checkpoint as tCK
from tests.test_lm import small_lm
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_tts import port_lm_cfg, port_mimi_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def assert_same_tree(got, want, path=""):
    """Same structure, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(_bits(got), _bits(want)), path


def _jax_ref(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _bf16(ref):
    return {k: np.asarray(v, np.float32).astype(ml_dtypes.bfloat16) for k, v in ref.items()}


def _jax_low_rank_lm():
    cfg = small_lm(extra_heads=(2, 6), ca=True)
    return cfg.__class__(**{**cfg.__dict__, "depformer": jLM.DepFormerConfig(
        transformer=cfg.depformer.transformer, num_slices=4, low_rank_embeddings=8)})


LM_CASES = {
    "ca+extra_heads": lambda: small_lm(extra_heads=(2, 6), ca=True),
    "low_rank": _jax_low_rank_lm,
    "no_depformer": lambda: small_lm(depformer=False),
}


@pytest.mark.parametrize("width", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(LM_CASES))
def test_build_lm_params_equals_the_jax_loader_through_the_bridge(tmp_path, case, width):
    jcfg = LM_CASES[case]()
    params = jLM.init(jcfg, jax.random.PRNGKey(0))
    ref = _jax_ref(jCK.lm_params_to_reference(jcfg, params))
    path = str(tmp_path / "lm.safetensors")
    save_file(_bf16(ref) if width == "bf16" else ref, path)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = bridge.from_numpy_tree(jax.tree_util.tree_map(
            np.asarray, jCK.build_lm_params(jcfg, jCK.load_tensors(path), dtype=jdtype)))
        got = tCK.build_lm_params(port_lm_cfg(jcfg), tCK.load_tensors(path), dtype=dtype)
        assert_same_tree(got, want)


def test_lm_export_equals_the_jax_export():
    jcfg = _jax_low_rank_lm()
    params = jLM.init(jcfg, jax.random.PRNGKey(1))
    want = _jax_ref(jCK.lm_params_to_reference(jcfg, params))
    got = tCK.lm_params_to_reference(port_lm_cfg(jcfg), bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, params)))
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _root_fallbacks(ref, s):
    """Per-slice DepFormer keys renamed to the reference's root aliases
    (``depformer_in`` has 11 entries at the root: the shared layout's case)."""
    ref = dict(ref)
    for i in range(s):
        ref[f"linears.{i}.weight"] = ref.pop(f"depformer.slices.{i}.linear_out.weight")
        emb = ref.pop(f"depformer.slices.{i}.emb.weight")
        ref["depformer_text_emb.weight" if i == 0 else f"depformer_emb.{i - 1}.weight"] = emb
    return ref


def _shared_transformer(ref, cfg, rng):
    """One DepFormer stack for every slice (``depformer.layers``), with the
    gating weights indexed by ``slice * 11 // slices``."""
    ref = {k: v for k, v in ref.items() if ".transformer.layers." not in k
           or not k.startswith("depformer.slices.")}
    d = cfg.depformer.transformer.d_model
    hidden = 2 * cfg.depformer.transformer.dim_feedforward // 3
    for l in range(cfg.depformer.transformer.num_layers):
        p = f"depformer.layers.{l}"
        ref[f"{p}.self_attn.in_proj_weight"] = rng.standard_normal((3 * d, d)).astype(np.float32)
        ref[f"{p}.self_attn.out_proj.weight"] = rng.standard_normal((d, d)).astype(np.float32)
        for nm in ("norm1", "norm2"):
            ref[f"{p}.{nm}.alpha"] = rng.standard_normal((1, 1, d)).astype(np.float32)
        for g in range(11):
            ref[f"{p}.gating.{g}.linear_in.weight"] = rng.standard_normal(
                (2 * hidden, d)).astype(np.float32)
            ref[f"{p}.gating.{g}.linear_out.weight"] = rng.standard_normal(
                (d, hidden)).astype(np.float32)
    return ref


@pytest.mark.parametrize("layout", ["root_fallbacks", "shared_transformer"])
def test_depformer_fallback_chains_match_jax(layout):
    jcfg = small_lm()
    params = jLM.init(jcfg, jax.random.PRNGKey(2))
    ref = _jax_ref(jCK.lm_params_to_reference(jcfg, params))
    if layout == "root_fallbacks":
        ref = _root_fallbacks(ref, jcfg.depformer.num_slices)
    else:
        ref = _shared_transformer(ref, jcfg, np.random.default_rng(3))
        ref["depformer_in.0.weight"] = ref.pop("depformer.slices.0.linear_in.weight")
        for i in range(1, 4):
            del ref[f"depformer.slices.{i}.linear_in.weight"]
        for j in range(1, 11):
            ref[f"depformer_in.{j}.weight"] = ref["depformer_in.0.weight"] * (j + 1)
    want = bridge.from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jCK.build_lm_params(jcfg, ref, dtype=jnp.float32)))
    got = tCK.build_lm_params(port_lm_cfg(jcfg), ref, dtype=torch.float32)
    assert_same_tree(got, want)
    if layout == "shared_transformer":  # slices 0 and 3 read different gating indices
        a = got["depformer"]["transformer"][0][0]["mlp"]["linear_in"]
        b = got["depformer"]["transformer"][3][0]["mlp"]["linear_in"]
        assert not torch.equal(a, b)


def test_missing_lm_key_raises_the_jax_error():
    jcfg = small_lm(ca=True)
    ref = _jax_ref(jCK.lm_params_to_reference(jcfg, jLM.init(jcfg, jax.random.PRNGKey(4))))
    del ref["transformer.layers.1.self_attn.out_proj.weight"]
    del ref["text_linear.weight"]
    with pytest.raises(KeyError) as ej:
        jCK.build_lm_params(jcfg, ref, dtype=jnp.float32)
    with pytest.raises(KeyError) as et:
        tCK.build_lm_params(port_lm_cfg(jcfg), ref)
    assert str(et.value) == str(ej.value)


def _weight_norm(ref, rng):
    """Two convs stored as weight-norm pairs (``weight_g``, ``weight_v``)."""
    ref = dict(ref)
    for key in ("encoder.model.0.conv.conv", "decoder.model.2.convtr.convtr"):
        w = ref.pop(f"{key}.weight")
        ref[f"{key}.weight_v"] = (w * 3.0).astype(np.float32)
        ref[f"{key}.weight_g"] = rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)).astype(np.float32)
    return ref


@pytest.mark.parametrize("width", ["f32", "bf16"])
def test_build_mimi_params_equals_the_jax_loader_through_the_bridge(tmp_path, width):
    jcfg = small_mimi_cfg()
    params = jMIMI.init(jcfg, jax.random.PRNGKey(5))
    ref = _weight_norm(_jax_ref(jCK.mimi_params_to_reference(jcfg, params)),
                       np.random.default_rng(6))
    path = str(tmp_path / "mimi.safetensors")
    save_file(_bf16(ref) if width == "bf16" else ref, path)
    want = bridge.from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jCK.build_mimi_params(jcfg, jCK.load_tensors(path))))
    got = tCK.build_mimi_params(port_mimi_cfg(jcfg), tCK.load_tensors(path))
    assert_same_tree(got, want)
    got16 = tCK.build_mimi_params(port_mimi_cfg(jcfg), tCK.load_tensors(path), torch.bfloat16)
    assert got16["encoder"]["init"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(got16["encoder"]["init"]["w"],
                               got["encoder"]["init"]["w"].to(torch.bfloat16), rtol=0, atol=0)
    del ref["quantizer.rvq_rest.vq.layers.1._codebook.embedding_sum"]
    del ref["decoder.model.0.conv.conv.bias"]
    with pytest.raises(KeyError) as ej:
        jCK.build_mimi_params(jcfg, ref)
    with pytest.raises(KeyError) as et:
        tCK.build_mimi_params(port_mimi_cfg(jcfg), ref)
    assert str(et.value) == str(ej.value)


def test_mimi_export_equals_the_jax_export():
    jcfg = small_mimi_cfg()
    params = jMIMI.init(jcfg, jax.random.PRNGKey(7))
    want = _jax_ref(jCK.mimi_params_to_reference(jcfg, params))
    got = tCK.mimi_params_to_reference(port_mimi_cfg(jcfg), bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, params)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_stt1b_export_reimport_identity():
    """stt-1b at full size, bf16: the port's tree -> reference layout ->
    rebuilt, every leaf bit for bit (no quantisation, no dtype drift)."""
    cfg = tLM.stt_1b_en_fr()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tLM.init(cfg, gen, torch.bfloat16)
    ref = tCK.lm_params_to_reference(cfg, params)
    assert "transformer.layers.15.self_attn.in_proj_weight" in ref
    assert ref["out_norm.alpha"].shape == (1, 1, 2048)
    loaded = tCK.build_lm_params(cfg, ref, dtype=torch.bfloat16)
    assert_same_tree(loaded, params)


def test_native_checkpoint_round_trip(tmp_path):
    jcfg = small_lm(extra_heads=(2, 6), ca=True)
    tree = bridge.from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jLM.init(jcfg, jax.random.PRNGKey(8))))
    tree["transformer"][0]["in_proj_w"] = tree["transformer"][0]["in_proj_w"].to(torch.bfloat16)
    path = str(tmp_path / "native.safetensors")
    tCK.save_native(path, tree)
    assert "['transformer'][1]['mlp']['linear_in']" in load_file(path)
    assert_same_tree(tCK.load_native(path, tree), tree)
    # Through a quantised tree too: {q, s} leaves are tensors like any other.
    qtree = {"lm": jT.quantize_weights({"w": np.ones((4, 70000), np.float32)})}
    qt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, qtree))
    tCK.save_native(path, qt)
    assert_same_tree(tCK.load_native(path, qt), qt)


def test_safetensors_reader_equals_the_package(tmp_path):
    rng = np.random.default_rng(9)
    tensors = {
        "bf": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "h": rng.standard_normal((2, 7)).astype(np.float16),
        "f": rng.standard_normal((4, 2, 3)).astype(np.float32),
        "i": rng.integers(-128, 127, (9,)).astype(np.int8),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    want = load_file(path)
    got = tCK.load_safetensors(path)
    assert set(got) == set(want) and got.metadata == {"format": "np"}
    assert got.dtype("bf") == "BF16" and got["bf"].dtype == np.float32
    for k, v in want.items():
        ref = np.asarray(v, np.float32) if k == "bf" else v
        assert got[k].dtype == ref.dtype and got[k].shape == ref.shape, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
    # The writer: f32 and bf16 (numpy or torch) bit for bit.
    out = str(tmp_path / "w.safetensors")
    tCK.save_safetensors(out, {**tensors, "t16": torch.from_numpy(tensors["f"]).bfloat16()})
    back = load_file(out)
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k].view(np.uint8), v.view(np.uint8), err_msg=k)
    np.testing.assert_array_equal(back["t16"].view(np.uint16),
                                  tensors["f"].astype(ml_dtypes.bfloat16).view(np.uint16))
    tCK.save_safetensors(out, {"f": tensors["f"]}, dtype=torch.bfloat16)
    assert load_file(out)["f"].dtype == ml_dtypes.bfloat16


def test_reader_and_writer_never_import_safetensors(tmp_path):
    path = tmp_path / "x.safetensors"
    save_file({"a": np.arange(6, dtype=np.float32).reshape(2, 3)}, str(path))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["safetensors"] = None  # any import of it now raises
        import numpy as np, torch
        from dsm_tpu_torch.utils import checkpoint as CK
        from dsm_tpu_torch.server import voices
        t = CK.load_tensors({str(path)!r})
        assert t["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
        CK.save_safetensors({str(tmp_path / 'y.safetensors')!r}, {{"b": torch.ones(2, 3)}})
        assert voices.load_voice_embedding({str(tmp_path / 'y.safetensors')!r}).shape == (1, 2, 3)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
