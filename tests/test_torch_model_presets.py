"""The port's model presets (``dsm_tpu_torch/server/model_presets.py``)
against the JAX loader, as ``tests/test_protocol.py`` tests it.

Bars: every file in ``configs/models/`` loads to the JAX loader's fields:
the ``LmConfig`` equal to the JAX one carried into the port's dataclasses
(``tests/test_torch_tts.port_lm_cfg``), and the model type, delays,
generation defaults, timing metadata and names equal; the bare-model TOML
gives the same ``LmConfig`` and conditioner tables; no weights are built.
"""

import glob
import os

import pytest

from dsm_tpu.server import model_presets as J
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.server import model_presets as P
from tests.test_torch_tts import port_lm_cfg

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "models")
JSONS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "*.json")))


def test_every_shipped_descriptor_is_tested():
    assert JSONS == ["moshi_7b.json", "stt_1b_en_fr.json", "stt_2.6b_en.json"]
    assert os.path.exists(os.path.join(ROOT, "s2st-1b.toml"))


@pytest.mark.parametrize("name", JSONS)
def test_preset_json_loads_to_the_jax_fields(name):
    got = P.load_preset(os.path.join(ROOT, name))
    want = J.load_preset(os.path.join(ROOT, name))
    assert isinstance(got.lm, tLM.LmConfig)
    assert got.lm == port_lm_cfg(want.lm)
    for field in ("model_type", "delays", "audio_delay_seconds",
                  "audio_silence_prefix_seconds", "mimi_name", "tokenizer_name"):
        assert getattr(got, field) == getattr(want, field), field
    assert vars(got.gen) == vars(want.gen)


def test_preset_values_as_the_jax_test_states():
    stt = P.load_preset(os.path.join(ROOT, "stt_1b_en_fr.json"))
    assert stt.model_type == "stt" and stt.lm.transformer.d_model == 2048
    assert stt.audio_delay_seconds == 0.5 and stt.delays == (0,) * 33
    assert stt.gen.top_k_text == 50
    en = P.load_preset(os.path.join(ROOT, "stt_2.6b_en.json"))
    assert en.lm.transformer.num_layers == 48 and en.audio_silence_prefix_seconds == 1.0
    moshi = P.load_preset(os.path.join(ROOT, "moshi_7b.json"))
    assert moshi.model_type == "moshi" and moshi.lm.transformer.d_model == 4096
    assert moshi.lm.depformer.num_slices == 8 and moshi.lm.audio_codebooks == 16
    assert moshi.lm.transformer.dim_feedforward == int(4096 * 4.125)


def test_bare_model_toml_loads_to_the_jax_fields():
    path = os.path.join(ROOT, "s2st-1b.toml")
    lm, conds = P.load_model_toml(path)
    lm_j, conds_j = J.load_model_toml(path)
    assert lm == port_lm_cfg(lm_j) and conds == conds_j
    assert lm.text_in_vocab_size == 48001 and lm.audio_codebooks == 16
    assert lm.depformer.num_slices == 8 and lm.depformer.transformer.dim_feedforward == 4096
    assert conds["description"]["type"] == "Lut"
    assert len(conds["description"]["possible_values"]) == 5
