"""Build a serving module from a TOML config (counterpart of
``dsm_tpu/server/builder.py``: ``build_batched_asr``, ``build_tts`` with the
single-session engine for ``batch_size = 1`` and the batched one above,
``build_duplex`` and ``build_mimi_rooms``).

Weights come from the files the TOML names (``lm_model_file``,
``audio_tokenizer_file``) when they exist locally: reference-layout
safetensors, or GGUF by extension (``utils/checkpoint.py``).  An ``hf://``
or ``hf-snapshot://`` reference, or a missing file, leaves the module at its
configured width with random weights from a seeded ``torch.Generator``,
logged as a warning, as the JAX builder does without weights.  The serving
profile then runs on the tree either way.  The text tokenizer is loaded from
``text_tokenizer_file`` when the file is there, else the byte-level
fallback.  ``[modules.X.mesh] dp = N [tp = M]`` serves the batched ASR, TTS
and duplex engines on a device mesh (:func:`build_mesh_from_config`); the
single-session engines and the Mimi rooms take none, as in the JAX builder.
Options the port does not serve raise instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

from ..models import conditioner as COND
from ..models import lm as LM
from ..models import mimi as MIMI
from ..ops import transformer as T
from ..sessions import asr as ASR
from ..sessions import lm_gen
from ..sessions import tts as TTS
from ..models import speaker as SPK
from ..parallel import mesh as M
from ..utils import checkpoint as CK
from ..utils.tokenizer import load_tokenizer
from . import config as CFG
from .autoconfig import auto_batch_size, device_memory_bytes
from .batched_asr import BatchedAsrEngine
from .duplex import DuplexEngine
from .duplex_batched import BatchedDuplexEngine
from .mimi_rooms import MimiRoomsEngine
from .tts_batched import BatchedTtsEngine
from .tts_module import TtsEngine
from .voices import VoiceResolver

log = logging.getLogger("dsm.torch.builder")

def _load_or_init_lm(mod: CFG.ModuleConfig, gen: torch.Generator, dtype):
    """The LM's params from ``lm_model_file`` when it is a local file, else
    random ones from ``gen`` seeded 0 -> ``(params, loaded)``."""
    path = CFG.resolve_path(mod.lm_model_file) if mod.lm_model_file else None
    if path:
        log.info("loading LM weights from %s", path)
        return CK.build_lm_params(mod.lm, CK.load_tensors(path), dtype, gen.device), True
    log.warning("LM weights %s not available locally; using random init", mod.lm_model_file)
    gen.manual_seed(0)
    return LM.init(mod.lm, gen, dtype), False


def _load_or_init_mimi(mod: CFG.ModuleConfig, mimi_cfg, gen: torch.Generator, dtype):
    """The codec's params from ``audio_tokenizer_file`` when it is a local
    file, else random ones from ``gen`` seeded 1 -> ``(params, loaded)``."""
    spec = mod.audio_tokenizer_file
    path = CFG.resolve_path(spec) if spec else None
    if path:
        log.info("loading Mimi weights from %s", path)
        return CK.build_mimi_params(mimi_cfg, CK.load_tensors(path), dtype, gen.device), True
    log.warning("Mimi weights %s not available locally; using random init", spec)
    gen.manual_seed(1)
    return MIMI.init(mimi_cfg, gen, dtype), False


def build_batched_asr(mod: CFG.ModuleConfig, device,
                      cuda_graph: Optional[bool] = None) -> BatchedAsrEngine:
    """The engine for a ``BatchedAsr`` module on ``device``.

    ``cuda_graph`` is the engine's (``BatchedAsrEngine``: the step captured
    as one CUDA graph, the default on CUDA; False for the eager step); no
    TOML key sets it.

    On CUDA it takes the JAX builder's accelerator profile: int8 KV rings,
    int8 LM weights, bf16 codec and bf16 LM activations.  The matmuls are
    W8A8, or weight-only (``qmm.qmm``) with ``w8a8 = false``, or W8A8 at the
    sites of ``w8a8_sites`` (a list or a comma string) and weight-only at the
    others; the profile is written into the weights.  ``batch_size`` is
    clamped to the card's memory (``autoconfig.auto_batch_size``).  On the
    CPU: f32 throughout, no quantisation.  ``pipeline_depth`` (default 1) is
    the engine's dispatch-ahead and ``pcm_wire = "int16"`` its int16 pcm
    upload, as in the JAX builder."""
    device = torch.device(device)
    if mod.type not in ("BatchedAsr", "Asr") or mod.lm is None:
        raise ValueError(f"module {mod.name}: not a BatchedAsr module with a model")
    mesh = build_mesh_from_config(mod, device)
    wire = _pcm_wire(mod)
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
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    gen = torch.Generator(device=device)
    lm_params, _ = _load_or_init_lm(mod, gen, dtype)
    mimi_params, _ = _load_or_init_mimi(mod, mimi_cfg, gen, dtype)
    if on_accel:  # the dense copy is freed before the engine allocates its rings
        lm_params = _quantize_lm(mod, lm_params, _w8a8_sites(mod))
    batch = auto_batch_size(int(mod.batch_size), mod.lm, device_memory_bytes(device))
    engine = BatchedAsrEngine(
        asr_cfg, {"mimi": mimi_params, "lm": lm_params},
        batch_size=batch, device=device,
        fill_gate_frac=float(mod.raw.get("fill_gate_frac", 0.2)),
        cuda_graph=cuda_graph, pipeline_depth=int(mod.raw.get("pipeline_depth", 1)),
        pcm_wire_int16=wire == "int16", mesh=mesh,
    )
    engine.tokenizer = _tokenizer(mod)
    return engine


def build_mesh_from_config(mod: CFG.ModuleConfig, device) -> Optional[M.Mesh]:
    """TOML ``[modules.X.mesh] dp = N [tp = M]`` -> the module's serving
    mesh, as the JAX builder's: None without the section or for one shard.
    On CUDA the shards are the cards ``cuda:0 ..`` in order, and a mesh of
    more shards than cards raises (a silent fallback would misreport
    capacity); on ``--device cpu`` every shard is the CPU."""
    spec = mod.raw.get("mesh")
    if not spec:
        return None
    dp, tp = int(spec.get("dp", 1)), int(spec.get("tp", 1))
    if dp * tp <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if dp * tp > n:
            raise ValueError(f"mesh dp={dp} x tp={tp} needs {dp * tp} devices, have {n}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [device] * (dp * tp)
    log.info("serving mesh: dp=%d tp=%d over %d devices", dp, tp, dp * tp)
    return M.make_mesh(dp=dp, tp=tp, devices=devices)


def _pcm_wire(mod: CFG.ModuleConfig) -> str:
    """TOML ``pcm_wire``, lower case: ``"int16"``, or ``""`` for the f32
    wire (``"f32"``, ``"float32"`` or no key); any other name raises, where
    the JAX builder would fall back to f32 without a word."""
    wire = str(mod.raw.get("pcm_wire", "")).lower()
    if wire not in ("", "int16", "f32", "float32"):
        raise ValueError(f"unknown pcm_wire {wire!r}")
    return "int16" if wire == "int16" else ""


def _tokenizer(mod: CFG.ModuleConfig):
    spec = mod.text_tokenizer_file
    return load_tokenizer(CFG.resolve_path(spec) if spec else None)


def _w8a8_sites(mod: CFG.ModuleConfig):
    """TOML ``w8a8_sites``: a list or a comma string of matmul sites that
    keep W8A8; None without the key."""
    sites = mod.raw.get("w8a8_sites")
    if isinstance(sites, str):
        sites = [s.strip() for s in sites.split(",") if s.strip()]
    return sites


def _quantize_lm(mod: CFG.ModuleConfig, lm_params: dict, sites=None) -> dict:
    """The accelerator profile's LM weights: int8, carrying the profile of
    their matmuls: W8A8, weight-only with ``w8a8 = false``, or W8A8 at
    ``sites`` only."""
    if not mod.raw.get("weight_quant", True):
        return lm_params
    w8a8 = bool(mod.raw.get("w8a8", True))
    if w8a8 and sites is not None:
        w8a8 = frozenset(sites)
    return T.quantize_weights(lm_params, w8a8=w8a8)


# TOML keys of the JAX TTS builder that select paths the port has not ported.
_TTS_UNPORTED = {
    "w8a8_sites": "the mixed W8A8 profile",
}


def build_tts(mod: CFG.ModuleConfig, device, cuda_graph: Optional[bool] = None):
    """The engine for a ``Tts`` module on ``device``, as the JAX
    ``build_tts`` picks it: :class:`BatchedTtsEngine` for ``batch_size > 1``
    (:func:`build_batched_tts`), else the single-session :class:`TtsEngine`.

    Both take the weights the TOML names (or the seeded random init), the
    voices (the voice directory, ``[...voices]`` and ``.wav`` samples through
    the speaker encoder, random from the generator as in the JAX builder,
    which never loads it either) and the ``[...conditioners]`` provider with
    its weights adopted from the LM checkpoint and the default
    ``description`` condition.  On CUDA the JAX builder's accelerator
    profile: bf16, int8 LM KV rings, int8 LM weights with W8A8 matmuls
    (weight-only with ``w8a8 = false``) and a bf16 codec; the single-session
    engine's voice store is int8 unless the TOML sets ``ca_int8 = false``
    (the batched engine's only with ``ca_int8 = true``).  On the CPU: f32
    throughout, no quantisation.  ``cuda_graph`` is the engine's (the tick
    captured as one CUDA graph, the default on CUDA; False for the eager
    tick); no TOML key sets it."""
    device = torch.device(device)
    if int(mod.raw.get("batch_size", 1)) > 1:
        return build_batched_tts(mod, device, cuda_graph)
    parts = _tts_parts(mod, device)
    ca_int8 = mod.raw.get("ca_int8")
    engine = TtsEngine(parts["cfg"], {"lm": parts["lm"]}, parts["mimi_cfg"], parts["mimi"],
                       _tokenizer(mod), device=device, cuda_graph=cuda_graph,
                       ca_quant=None if ca_int8 is None else bool(ca_int8))
    return _attach_tts_extras(engine, parts)


def build_batched_tts(mod: CFG.ModuleConfig, device,
                      cuda_graph: Optional[bool] = None) -> BatchedTtsEngine:
    """The continuously batched engine for a ``Tts`` module with
    ``batch_size > 1`` on ``device`` (:func:`build_tts` has the profile).

    ``cuda_graph`` is the engine's (``BatchedTtsEngine``: the tick captured
    as one CUDA graph, the default on CUDA; False for the eager tick); no
    TOML key sets it.  With ``ca_int8`` the voice store is int8.
    ``fuse_ticks`` (frames a dispatch, through the device script machine,
    whose ring keeps the engine's default ``script_cap`` of 1024 tokens),
    ``pipeline_depth`` (the fused path's dispatch-ahead) and ``pcm_wire =
    "int16"`` (the int16 audio download) and ``[mesh]`` (the device mesh) are
    the JAX builder's.  The batched step does not add the default condition
    (nor does the JAX package's)."""
    device = torch.device(device)
    raw = mod.raw
    if int(mod.batch_size) <= 1:
        raise ValueError("batch_size <= 1 selects the single-session engine: use build_tts")
    mesh = build_mesh_from_config(mod, device)
    parts = _tts_parts(mod, device)
    engine = BatchedTtsEngine(
        parts["cfg"], {"lm": parts["lm"]}, parts["mimi_cfg"], parts["mimi"], _tokenizer(mod),
        batch_size=int(mod.batch_size),
        cfg_enabled=bool(raw.get("cfg_enabled", False)),
        ca_quant=bool(raw.get("ca_int8", False)), device=device,
        pcm_wire_int16=_pcm_wire(mod) == "int16", cuda_graph=cuda_graph,
        fuse_ticks=int(raw.get("fuse_ticks", 1)),
        pipeline_depth=int(raw.get("pipeline_depth", 1)), mesh=mesh,
    )
    return _attach_tts_extras(engine, parts)


def _tts_parts(mod: CFG.ModuleConfig, device: torch.device) -> dict:
    """What both TTS engines are built from: the ``TtsConfig``, the codec
    config, the LM and codec params (loaded or seeded, in the device's
    profile), the voice resolver and the condition provider."""
    raw = mod.raw
    if mod.type != "Tts" or mod.lm is None or mod.lm.depformer is None:
        raise ValueError(f"module {mod.name}: not a Tts module with a DepFormer model")
    for key, what in _TTS_UNPORTED.items():
        if raw.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet; see ROADMAP.md")
    _pcm_wire(mod)  # an unknown wire raises here, whichever engine is built
    on_accel = device.type == "cuda"
    gen_cfg = mod.generation or {}
    keys = ("acoustic_delay", "text_pad_token", "text_bos_token", "text_eos_token",
            "text_eop_token", "text_start_token", "text_audio_delay_in_tokens",
            "max_consecutive_pads", "extra_steps", "speaker_cond_duration_s",
            "speaker_cond_dim", "speaker_cond_n_speakers")
    tts_cfg = TTS.TtsConfig(
        lm=mod.lm, kv_quant=on_accel and bool(raw.get("kv_quant", True)),
        **{k: gen_cfg[k] for k in keys if k in gen_cfg})
    mimi_cfg = MIMI.v0_1(mod.lm.generated_codebooks)
    dtype = torch.bfloat16 if on_accel else torch.float32

    gen = torch.Generator(device=device)
    lm_params, lm_loaded = _load_or_init_lm(mod, gen, dtype)
    mimi_params, _ = _load_or_init_mimi(mod, mimi_cfg, gen, dtype)
    if on_accel:
        lm_params = _quantize_lm(mod, lm_params)

    voice_dir = CFG.resolve_path(mod.voice_dir) if mod.voice_dir else None
    if voice_dir is not None and not os.path.isdir(voice_dir):
        voice_dir = os.path.dirname(voice_dir)
    preloaded = {name: CFG.resolve_path(spec) for name, spec in (mod.voices or {}).items()
                 if CFG.resolve_path(spec)}
    spk_cfg = SPK.SpeakerEncoderConfig(
        cond_dim=tts_cfg.speaker_cond_dim, n_speakers=tts_cfg.speaker_cond_n_speakers,
        duration_s=tts_cfg.speaker_cond_duration_s, mimi=mimi_cfg)
    gen.manual_seed(2)
    voices = VoiceResolver(voice_dir=voice_dir, preloaded=preloaded, speaker_cfg=spk_cfg,
                           speaker_params=SPK.init(spk_cfg, gen), mimi_params=mimi_params)

    provider = default_condition = None
    cond_raw = (raw.get("model") or {}).get("conditioners")
    if cond_raw:
        gen.manual_seed(3)
        provider = COND.ConditionProvider(mod.lm.d_model, COND.configs_from_toml(cond_raw),
                                          gen)
        if lm_loaded:
            adopted = provider.load_params(CK.load_tensors(CFG.resolve_path(mod.lm_model_file)))
            log.info("conditioner weights adopted from checkpoint: %d", adopted)
        for name, c in cond_raw.items():
            if c.get("type") == "Lut" and c.get("possible_values"):
                default_condition = provider.condition_lut(name, c["possible_values"][-1])
                break
    return {"cfg": tts_cfg, "mimi_cfg": mimi_cfg, "lm": lm_params, "mimi": mimi_params,
            "voices": voices, "provider": provider, "default_condition": default_condition}


def _attach_tts_extras(engine, parts: dict):
    engine.voices = parts["voices"]
    engine.condition_provider = parts["provider"]
    engine.default_condition = parts["default_condition"]
    return engine


def duplex_model(mod: CFG.ModuleConfig) -> LM.LmConfig:
    """The model of an ``Lm`` module: its ``[model]``, else Moshi 7B in the
    dialogue layout of ``configs/models/moshi_7b.json`` (16 codebooks in, 8
    generated: ``moshi_v0_1_streaming(8)``).  The JAX builder's default,
    ``moshi_v0_1_streaming(16)``, cannot take a step: 16 generated and 8
    input codebooks make 24 columns against its 16 embedding tables."""
    return mod.lm or LM.moshi_v0_1_streaming(8)


def build_duplex(mod: CFG.ModuleConfig, device, cuda_graph: Optional[bool] = None):
    """The engine for an ``Lm`` (full-duplex dialogue) module on ``device``:
    :class:`BatchedDuplexEngine` for ``batch_size > 1``, else the
    single-dialogue :class:`DuplexEngine`.

    ``cuda_graph`` is the batched engine's (the tick captured as one CUDA
    graph, the default on CUDA; False for the eager tick); no TOML key sets
    it.  ``pipeline_depth`` (TOML, default 1) is the batched engine's
    dispatch-ahead, as in the JAX builder.

    The TOML's ``kv_quant`` selects the serving profile (int8 KV rings, int8
    LM weights, quantised here once, with W8A8 matmuls or, with ``w8a8 =
    false``, weight-only ones); without the key it follows the device: on
    CUDA, off on the CPU, as in the JAX builder.  ``kv_bits = 4``
    packs the batched engine's rings as int4 (8 is the default; anything else
    raises).  ``[mesh]`` shards the batched engine (:func:`build_mesh_from_config`);
    the single dialogue takes none, as in the JAX builder.
    On CUDA the weights and the codec are bf16, on the CPU f32."""
    device = torch.device(device)
    raw = mod.raw
    if mod.type != "Lm":
        raise ValueError(f"module {mod.name}: not an Lm module")
    for key, what in _TTS_UNPORTED.items():
        if raw.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet; see ROADMAP.md")
    kv_bits = int(raw.get("kv_bits", 8))
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    lm_cfg = duplex_model(mod)
    if lm_cfg.depformer is None:
        raise ValueError(f"module {mod.name}: a dialogue model needs a DepFormer")
    gen_cfg = mod.generation or {}
    cfg = lm_gen.DuplexConfig(
        lm=lm_cfg,
        generated_audio_codebooks=gen_cfg.get("generated_audio_codebooks",
                                              lm_cfg.generated_codebooks or 8),
        input_audio_codebooks=gen_cfg.get("input_audio_codebooks", 8),
        acoustic_delay=gen_cfg.get("acoustic_delay", 2),
        text_start_token=lm_cfg.text_start_token,
    )
    mimi_cfg = MIMI.v0_1(cfg.input_audio_codebooks)
    # Without the key the rings follow the device, as in the JAX builder:
    # int8 (or int4 with kv_bits = 4) on CUDA, bf16/f32 on the CPU.
    kv_quant = raw.get("kv_quant")
    kv_quant = device.type == "cuda" if kv_quant is None else bool(kv_quant)
    if kv_quant and not raw.get("weight_quant", True):
        raise NotImplementedError(
            "weight_quant = false with int8 KV rings is not a profile of the "
            "dialogue engine")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    gen = torch.Generator(device=device)
    lm_params, _ = _load_or_init_lm(dataclasses.replace(mod, lm=lm_cfg), gen, dtype)
    mimi_params, _ = _load_or_init_mimi(mod, mimi_cfg, gen, dtype)
    if kv_quant:  # before the engine allocates its rings beside the dense copy
        lm_params = T.quantize_weights(lm_params, w8a8=bool(raw.get("w8a8", True)))
    batch = int(raw.get("batch_size", 1))
    if batch > 1:
        return BatchedDuplexEngine(
            cfg, {"lm": lm_params}, mimi_cfg, mimi_params, _tokenizer(mod),
            batch_size=batch, kv_quant=kv_quant, kv_bits=kv_bits, device=device,
            cuda_graph=cuda_graph, pipeline_depth=int(raw.get("pipeline_depth", 1)),
            mesh=build_mesh_from_config(mod, device))
    return DuplexEngine(cfg, {"lm": lm_params}, mimi_cfg, mimi_params, _tokenizer(mod),
                        kv_quant=kv_quant, device=device)


def build_mimi_rooms(mod: CFG.ModuleConfig, device) -> MimiRoomsEngine:
    """The codec-as-a-service rooms of a ``Mimi`` module on ``device``
    (moshi-server/src/mimi.rs): Mimi v0_1 with the module's ``n_q`` (16 by
    default), the codec loaded from ``audio_tokenizer_file`` or seeded, bf16
    on CUDA and f32 on the CPU."""
    device = torch.device(device)
    mimi_cfg = MIMI.v0_1(mod.n_q or 16)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, _ = _load_or_init_mimi(mod, mimi_cfg, torch.Generator(device=device), dtype)
    return MimiRoomsEngine(cfg=mimi_cfg, params=params, device=device)
