"""Build a serving module from a TOML config (counterpart of
``dsm_tpu/server/builder.py:build_batched_asr``).

No checkpoint loading yet: with its weights absent the module runs at its
configured width with random weights from a seeded ``torch.Generator``,
logged as a warning, as the JAX builder does without weights.  Options the
port does not serve yet raise instead of being ignored.
"""

from __future__ import annotations

import logging

import torch

from ..models import lm as LM
from ..models import mimi as MIMI
from ..ops import transformer as T
from ..sessions import asr as ASR
from . import config as CFG
from .batched_asr import BatchedAsrEngine

log = logging.getLogger("dsm.torch.builder")

# TOML keys of the JAX builder that select paths the port has not ported.
_UNPORTED = {
    "mesh": "multi-device serving",
    "pcm_wire": "the int16 pcm wire",
    "w8a8_sites": "the mixed W8A8 profile",
}


def _random_init_warning(what: str, spec) -> None:
    if spec and CFG.resolve_path(spec):
        raise NotImplementedError(
            f"{what} {spec!r} exists locally but checkpoint loading is not "
            "ported yet; see ROADMAP.md")
    log.warning("%s %s not available locally; using random init", what, spec)


def build_batched_asr(mod: CFG.ModuleConfig, device) -> BatchedAsrEngine:
    """The engine for a ``BatchedAsr`` module on ``device``.

    On CUDA it takes the JAX builder's accelerator profile: int8 KV rings,
    int8 LM weights with W8A8 matmuls, bf16 codec and bf16 LM activations.
    On the CPU: f32 throughout, no quantisation."""
    device = torch.device(device)
    if mod.type != "BatchedAsr" or mod.lm is None:
        raise ValueError(f"module {mod.name}: not a BatchedAsr module with a model")
    for key, what in _UNPORTED.items():
        if mod.raw.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet; see ROADMAP.md")
    if int(mod.raw.get("pipeline_depth", 1)) != 1:
        raise NotImplementedError("pipeline_depth > 1 is not ported yet; see ROADMAP.md")
    on_accel = device.type == "cuda"
    mimi_cfg = MIMI.v0_1(mod.lm.audio_codebooks)
    asr_cfg = ASR.AsrConfig(
        lm=mod.lm,
        mimi=mimi_cfg,
        asr_delay_in_tokens=mod.asr_delay_in_tokens,
        temperature=mod.temperature,
        kv_quant=on_accel and bool(mod.raw.get("kv_quant", True)),
        mimi_dtype="bfloat16" if on_accel else "float32",
    )
    dtype = torch.bfloat16 if on_accel else torch.float32

    _random_init_warning("LM weights", mod.lm_model_file)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lm_params = LM.init(mod.lm, gen, dtype)
    _random_init_warning("Mimi weights", mod.audio_tokenizer_file)
    gen.manual_seed(1)
    mimi_params = MIMI.init(mimi_cfg, gen, dtype)
    if on_accel and mod.raw.get("weight_quant", True):
        if not mod.raw.get("w8a8", True):
            raise NotImplementedError(
                "w8a8 = false (weight-only dequant matmuls) is not ported yet; "
                "see ROADMAP.md")
        lm_params = T.quantize_weights(lm_params)
    return BatchedAsrEngine(
        asr_cfg, {"mimi": mimi_params, "lm": lm_params},
        batch_size=int(mod.batch_size), device=device,
        fill_gate_frac=float(mod.raw.get("fill_gate_frac", 0.2)),
    )
