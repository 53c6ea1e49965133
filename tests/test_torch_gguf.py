"""The port's GGUF reader and writer (``dsm_tpu_torch/utils/gguf.py``, a
copy of ``dsm_tpu/utils/gguf.py``) against the JAX package's.

Bars, all exact: files written by either side read back on the other with
the same metadata and the same tensors, bit for bit (F32, F16, BF16, I32
and Q8_0, dequantised and raw); a q8 GGUF LM checkpoint loads through the
port's ``load_tensors`` and ``build_lm_params`` into the tree
``bridge.from_numpy_tree`` makes of the JAX loader's output.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.utils import checkpoint as jCK
from dsm_tpu.utils import gguf as jG
from dsm_tpu_torch import bridge
from dsm_tpu_torch.utils import checkpoint as tCK
from dsm_tpu_torch.utils import gguf as tG
from tests.test_lm import small_lm
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_tts import port_lm_cfg


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "a.weight": rng.standard_normal((5, 64)).astype(np.float32),
        "b.bias": rng.standard_normal((11,)).astype(np.float32),
        "c.f16": rng.standard_normal((3, 4)).astype(np.float16),
        "d.ints": np.arange(6, dtype=np.int32).reshape(2, 3),
        "e.bf16": rng.standard_normal((2, 32)).astype(ml_dtypes.bfloat16),
    }


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            for part in ("q", "s"):
                np.testing.assert_array_equal(got[k][part].view(np.uint8),
                                              v[part].view(np.uint8), err_msg=k)
            assert tuple(got[k]["shape"]) == tuple(v["shape"])
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8), v.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gguf_files_read_alike_on_both_sides(tmp_path, writer, quantize):
    path = str(tmp_path / "t.gguf")
    meta = {"general.name": "test", "x.count": 3, "x.neg": -2, "x.f": 0.5, "x.flag": True}
    (jG if writer == "jax" else tG).write_gguf(path, _tensors(), meta, quantize=quantize)
    for raw in (False, True):
        mj, tj = jG.read_gguf(path, raw_quant=raw)
        mt, tt = tG.read_gguf(path, raw_quant=raw)
        assert mt == mj and mt["general.name"] == "test" and mt["x.neg"] == -2
        _same(tt, tj)
    # Both writers make the same bytes.
    other = str(tmp_path / "u.gguf")
    (tG if writer == "jax" else jG).write_gguf(other, _tensors(), meta, quantize=quantize)
    with open(path, "rb") as f1, open(other, "rb") as f2:
        assert f1.read() == f2.read()


def test_q8_gguf_lm_checkpoint_loads_as_the_jax_loader(tmp_path):
    jcfg = small_lm(extra_heads=(2, 6), ca=True)
    params = jLM.init(jcfg, jax.random.PRNGKey(0))
    ref = {k: np.asarray(v) for k, v in jCK.lm_params_to_reference(jcfg, params).items()}
    path = str(tmp_path / "model.gguf")
    jG.write_gguf(path, ref, {"general.architecture": "moshi"}, quantize=True)
    tensors = tCK.load_tensors(path)  # by extension
    assert set(tensors) == set(ref)
    want = bridge.from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jCK.build_lm_params(jcfg, jCK.load_tensors(path), dtype=jnp.float32)))
    got = tCK.build_lm_params(port_lm_cfg(jcfg), tensors, dtype=torch.float32)
    assert_same_tree(got, want)
    # q8: the quantisation error only.
    w = got["transformer"][0]["in_proj_w"].numpy()
    w0 = np.asarray(params["transformer"]["in_proj_w"][0])
    assert 0 < np.abs(w - w0).max() < 0.02 * np.abs(w0).max()
