"""Model preset JSONs (``configs/models/*.json``) and bare-model TOMLs
(counterpart of ``dsm_tpu/server/model_presets.py``).

Reference: configs/models/{stt_1b_enfr,stt_2.6b_en,moshi_7b_202409}.json,
small JSON descriptors shipped beside checkpoints that carry (a) generation
sampling defaults, (b) client-facing timing metadata
(``audio_delay_seconds`` / ``audio_silence_prefix_seconds``) and, for the
Moshi family, (c) the whole architecture (dim, layers, delays), so that
loaders do not hard-code shapes.

``load_preset`` maps a JSON file onto the port's dataclasses: a ``preset``
that ``models/lm.py`` has gives its ``LmConfig``; otherwise the ``LmConfig``
is made from the raw moshi-style fields.  Configuration only: no weights are
built.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

from ..models import lm as LM
from ..ops import transformer as T


@dataclasses.dataclass(frozen=True)
class GenDefaults:
    temp: float = 0.0
    temp_text: float = 0.0
    top_k: int = 250
    top_k_text: int = 50


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    model_type: str  # "stt" | "tts" | "moshi"
    lm: LM.LmConfig
    delays: Tuple[int, ...]
    gen: GenDefaults
    audio_delay_seconds: float = 0.0
    audio_silence_prefix_seconds: float = 0.0
    mimi_name: Optional[str] = None
    tokenizer_name: Optional[str] = None


def _lm_from_raw(d: dict) -> LM.LmConfig:
    """An ``LmConfig`` from moshi-style raw fields (dim, n_q, card, ...)."""
    dim = int(d["dim"])
    ff = int(round(dim * float(d.get("hidden_scale", 4.0))))
    tf = T.TransformerConfig(
        d_model=dim,
        num_heads=int(d["num_heads"]),
        num_layers=int(d["num_layers"]),
        dim_feedforward=ff,
        context=int(d["context"]),
        norm="rms_norm" if "rms" in d.get("norm", "rms_norm") else "layer_norm",
        positional_embedding=d.get("positional_embedding", "rope"),
        max_period=float(d.get("max_period", 10_000.0)),
        layer_scale=d.get("layer_scale"),
    )
    dep = None
    if d.get("dep_q"):
        dep = LM.DepFormerConfig(
            transformer=T.TransformerConfig(
                d_model=int(d.get("depformer_dim", 1024)),
                num_heads=int(d.get("depformer_num_heads", 16)),
                num_layers=int(d.get("depformer_num_layers", 6)),
                dim_feedforward=int(d.get("depformer_dim_feedforward", 4224)),
                context=int(d.get("depformer_context", 8)),
                positional_embedding=d.get("depformer_pos_emb", "none"),
            ),
            num_slices=int(d["dep_q"]),
            low_rank_embeddings=d.get("depformer_low_rank_embeddings"),
        )
    card = int(d.get("card", 2048))
    text_card = int(d.get("text_card", 32000))
    return LM.LmConfig(
        transformer=tf,
        depformer=dep,
        text_in_vocab_size=text_card + 1,
        text_out_vocab_size=text_card,
        audio_vocab_size=card + 1,
        audio_codebooks=int(d["n_q"]),
    )


def load_model_toml(path: str):
    """A bare-model TOML (the reference's s2st-1b.toml schema: the model
    tables at the top level, not under ``[modules.x.model]``) ->
    ``(LmConfig, conditioner-config dict)``."""
    import tomllib

    from . import config as C

    with open(path, "rb") as f:
        m = tomllib.load(f)
    return C.lm_from_toml(m), m.get("conditioners", {})


def load_preset(path: str) -> ModelPreset:
    with open(path) as f:
        d = json.load(f)
    preset_name = d.get("preset")
    if preset_name and hasattr(LM, preset_name):
        lm_cfg = getattr(LM, preset_name)()
    else:
        lm_cfg = _lm_from_raw(d)
    g = d.get("lm_gen_config", {})
    stt = d.get("stt_config", {})
    return ModelPreset(
        model_type=d.get("model_type", "stt"),
        lm=lm_cfg,
        delays=tuple(d.get("delays", ())),
        gen=GenDefaults(
            temp=float(g.get("temp", 0.0)),
            temp_text=float(g.get("temp_text", 0.0)),
            top_k=int(g.get("top_k", 250)),
            top_k_text=int(g.get("top_k_text", 50)),
        ),
        audio_delay_seconds=float(stt.get("audio_delay_seconds", 0.0)),
        audio_silence_prefix_seconds=float(stt.get("audio_silence_prefix_seconds", 0.0)),
        mimi_name=d.get("mimi_name"),
        tokenizer_name=d.get("tokenizer_name"),
    )
