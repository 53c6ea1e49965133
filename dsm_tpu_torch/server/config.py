"""Server configuration from the reference TOML schema (counterpart of
``dsm_tpu/server/config.py``, which imports JAX through its model modules).

Reads the top-level keys and one ``[modules.<name>]`` table per module with
its ``model`` / ``model.transformer`` / ``model.depformer`` /
``model.extra_heads`` tables.  The port serves ``BatchedAsr``, ``Tts`` and
``Lm`` (full-duplex dialogue) modules (a ``Tts`` LM gets the voice
cross-attention, with a LayerNorm ``norm_cross``; an ``Lm`` module's
``generation`` table holds its codebook counts and ``acoustic_delay``, its
``kv_quant``, ``kv_bits`` and ``pipeline_depth`` stay in ``raw`` for the
builder); the LM config of other module types is not read.
Artifact references: a plain path (with ``$VAR`` substitution) is used
when the file exists; ``hf://`` and ``hf-snapshot://`` references resolve to
absent, since the port reads no download cache (ROADMAP.md), and the
builders then initialise at random.  :meth:`Config.validate` reports what is
missing, as the reference's ``validate`` does.
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


def transformer_from_toml(t: Dict[str, Any], cross_attention: bool = False,
                          ca_norm: Optional[str] = None) -> T.TransformerConfig:
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
        cross_attention=cross_attention,
        ca_norm=ca_norm,
    )


def lm_from_toml(m: Dict[str, Any], cross_attention: bool = False) -> LM.LmConfig:
    dep = None
    if "depformer" in m:
        d = m["depformer"]
        dep = LM.DepFormerConfig(
            transformer=transformer_from_toml(d["transformer"]),
            num_slices=d["num_slices"],
            low_rank_embeddings=d.get("low_rank_embeddings"),
        )
    extra = None
    if "extra_heads" in m:
        extra = (m["extra_heads"]["num_heads"], m["extra_heads"]["dim"])
    return LM.LmConfig(
        transformer=transformer_from_toml(
            m["transformer"], cross_attention=cross_attention,
            ca_norm="layer_norm" if cross_attention else None),
        text_in_vocab_size=m["text_in_vocab_size"],
        text_out_vocab_size=m["text_out_vocab_size"],
        audio_vocab_size=m["audio_vocab_size"],
        audio_codebooks=m["audio_codebooks"],
        extra_heads=extra,
        depformer=dep,
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
    voice_dir: Optional[str] = None
    voices: Optional[Dict[str, str]] = None
    generation: Optional[Dict[str, Any]] = None
    n_q: Optional[int] = None  # a Mimi module's codebooks


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
            if "model" in m and typ in ("Asr", "BatchedAsr", "Tts", "Lm"):
                lm_cfg = lm_from_toml(m["model"], cross_attention=typ == "Tts")
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
                voice_dir=m.get("voice_dir"),
                voices=m.get("voices"),
                generation=m.get("generation"),
                n_q=m.get("n_q"),
            )
        return cls(
            instance_name=raw.get("instance_name", "dsm-tpu"),
            static_dir=raw.get("static_dir"),
            log_dir=raw.get("log_dir"),
            authorized_ids=raw.get("authorized_ids", []),
            modules=modules,
        )

    def validate(self) -> List[str]:
        """Problems with the config, reported and not raised: unknown module
        types, a model table missing where one is needed, model files not
        available locally."""
        problems = []
        for name, m in self.modules.items():
            if m.type not in ("Asr", "BatchedAsr", "Tts", "Mimi", "Lm"):
                problems.append(f"module {name}: unknown type {m.type}")
            if m.type in ("Asr", "BatchedAsr", "Tts") and m.lm is None:
                problems.append(f"module {name}: missing [modules.{name}.model]")
            for label, spec in (("lm_model_file", m.lm_model_file),
                                ("audio_tokenizer_file", m.audio_tokenizer_file),
                                ("text_tokenizer_file", m.text_tokenizer_file)):
                if spec and resolve_path(spec) is None:
                    problems.append(f"module {name}: {label} {spec!r} not available locally")
        return problems
