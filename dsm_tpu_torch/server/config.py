"""Server configuration from the reference TOML schema (counterpart of
``dsm_tpu/server/config.py``, which imports JAX through its model modules).

Reads the top-level keys and one ``[modules.<name>]`` table per module with
its ``model`` / ``model.transformer`` / ``model.extra_heads`` tables.  The
port serves ``BatchedAsr`` modules only; the LM config of other module
types is not read.  Artifact references: a plain path is used when the
file exists; ``hf://`` and ``hf-snapshot://`` references resolve to absent,
since the port loads no checkpoint yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import re
import tomllib
from typing import Any, Dict, List, Optional

from ..models import lm as LM
from ..ops import transformer as T


def expand_env(s: str) -> str:
    """``$VAR`` substitution."""
    return re.sub(r"\$([A-Za-z_][A-Za-z0-9_]*)",
                  lambda m: os.environ.get(m.group(1), ""), s)


def resolve_path(spec: str) -> Optional[str]:
    """A local path for a model-file reference, or None when absent."""
    spec = expand_env(spec)
    if spec.startswith(("hf://", "hf-snapshot://")):
        return None
    return spec if os.path.exists(spec) else None


def _norm_kind(v: str) -> str:
    return {"RmsNorm": "rms_norm", "LayerNorm": "layer_norm"}[v]


def _pe_kind(v: str) -> str:
    return {"Rope": "rope", "Sin": "sin", "None": "none"}[
        v.capitalize() if v else "None"]


def transformer_from_toml(t: Dict[str, Any]) -> T.TransformerConfig:
    return T.TransformerConfig(
        d_model=t["d_model"],
        num_heads=t["num_heads"],
        num_layers=t["num_layers"],
        dim_feedforward=t["dim_feedforward"],
        context=t["context"],
        gating=t.get("gating") is not None and t.get("gating") != "none",
        norm=_norm_kind(t.get("norm", "RmsNorm")),
        positional_embedding=_pe_kind(t.get("positional_embedding", "None")),
        max_period=float(t.get("max_period", 10_000)),
        bias_attn=t.get("bias_attn", False),
        head_dim=t.get("head_dim"),
    )


def lm_from_toml(m: Dict[str, Any]) -> LM.LmConfig:
    if "depformer" in m:
        raise NotImplementedError(
            "the DepFormer (TTS, duplex) is not ported yet; see ROADMAP.md")
    extra = None
    if "extra_heads" in m:
        extra = (m["extra_heads"]["num_heads"], m["extra_heads"]["dim"])
    return LM.LmConfig(
        transformer=transformer_from_toml(m["transformer"]),
        text_in_vocab_size=m["text_in_vocab_size"],
        text_out_vocab_size=m["text_out_vocab_size"],
        audio_vocab_size=m["audio_vocab_size"],
        audio_codebooks=m["audio_codebooks"],
        extra_heads=extra,
    )


@dataclasses.dataclass
class ModuleConfig:
    name: str
    type: str
    path: str
    raw: Dict[str, Any]
    lm: Optional[LM.LmConfig] = None
    lm_model_file: Optional[str] = None
    text_tokenizer_file: Optional[str] = None
    audio_tokenizer_file: Optional[str] = None
    asr_delay_in_tokens: int = 6
    batch_size: int = 8
    temperature: float = 0.0


@dataclasses.dataclass
class Config:
    instance_name: str
    static_dir: Optional[str]
    log_dir: Optional[str]
    authorized_ids: List[str]
    modules: Dict[str, ModuleConfig]

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        modules: Dict[str, ModuleConfig] = {}
        for name, m in raw.get("modules", {}).items():
            typ = m["type"]
            lm_cfg = None
            if "model" in m and typ in ("Asr", "BatchedAsr"):
                lm_cfg = lm_from_toml(m["model"])
            modules[name] = ModuleConfig(
                name=name,
                type=typ,
                path=m.get("path", f"/api/{name}"),
                raw=m,
                lm=lm_cfg,
                lm_model_file=m.get("lm_model_file"),
                text_tokenizer_file=m.get("text_tokenizer_file"),
                audio_tokenizer_file=m.get("audio_tokenizer_file"),
                asr_delay_in_tokens=m.get("asr_delay_in_tokens", 6),
                batch_size=m.get("batch_size", 8),
                temperature=float(m.get("temperature", 0.0)),
            )
        return cls(
            instance_name=raw.get("instance_name", "dsm-tpu"),
            static_dir=raw.get("static_dir"),
            log_dir=raw.get("log_dir"),
            authorized_ids=raw.get("authorized_ids", []),
            modules=modules,
        )
