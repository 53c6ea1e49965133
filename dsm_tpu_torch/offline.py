"""File-to-file STT and TTS (counterpart of ``dsm_tpu/offline.py``).

STT: decode the audio, then the streaming ASR step frame by frame (Mimi
encode, LM step, word assembly), with trailing silence so that the delayed
words flush.  :func:`transcribe_files` puts N files on the batch dimension
and runs K = min(50, frames) frames a dispatch: on the card one captured
step (``sessions.asr.step_in_place``) replayed K times, on the CPU the eager
step; the host fetches a dispatch's tokens once.  A file that has run out
freezes behind its mask.  The frame-at-a-time path (``transcribe_per_frame``:
the eager step and a fetch a frame) is what the batched path is held to.

TTS: :func:`synthesize_file` and :func:`synthesize_jsonl` (the reference's
audio/tts.jsonl format) through a TTS engine.

Without local weights the builders take seeded random ones (``hf://``
references resolve to absent, ``server/config.py``): the transcripts then
mean nothing, but the whole path runs.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Optional

import numpy as np
import torch

from .models import lm as LM
from .server import builder
from .server.config import Config, ModuleConfig
from .server.cuda_graph import capture
from .sessions import asr as ASR
from .utils.audio import decode_audio, write_wav
from .utils.state import copy_into


SAMPLE_RATE = 24_000
CHUNK_FRAMES = 50  # frames a dispatch of the batched path
# The default TTS deployment: the repo's shipped kyutai/tts-1.6b-en_fr TOML.
DEFAULT_TTS_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "configs", "config-tts.toml")


def _default_asr_module() -> ModuleConfig:
    return ModuleConfig(
        name="asr", type="BatchedAsr", path="/api/asr-streaming", raw={},
        lm=LM.stt_1b_en_fr(),
        lm_model_file="hf://kyutai/stt-1b-en_fr-candle/model.safetensors",
        text_tokenizer_file="hf://kyutai/stt-1b-en_fr-candle/tokenizer_en_fr_audio_8000.model",
        audio_tokenizer_file="hf://kyutai/stt-1b-en_fr-candle/mimi-pytorch-e351c8d8@125.safetensors",
        asr_delay_in_tokens=6, batch_size=1, temperature=0.0,
    )


def build_asr_engine(config_path: Optional[str] = None, module_name: Optional[str] = None,
                     device="cuda"):
    """The ASR engine of the TOML's first ``BatchedAsr``/``Asr`` module (or
    the one named), else of stt-1b, at one slot (the batched path builds
    its own state)."""
    if config_path:
        cfg = Config.load(config_path)
        mods = [m for m in cfg.modules.values() if m.type in ("BatchedAsr", "Asr")]
        mod = next((m for m in mods if m.name == module_name), mods[0])
    else:
        mod = _default_asr_module()
    mod.batch_size = 1
    return builder.build_batched_asr(mod, device, cuda_graph=False)


def build_tts_engine(config_path: Optional[str] = None, device="cuda"):
    """The engine of the TOML's first ``Tts`` module, by default
    DEFAULT_TTS_CONFIG's (tts-1.6b, one session at a time)."""
    cfg = Config.load(config_path or DEFAULT_TTS_CONFIG)
    mod = next(m for m in cfg.modules.values() if m.type == "Tts")
    return builder.build_tts(mod, device)


def _padded_pcm(path: str, acfg) -> np.ndarray:
    """The file's pcm and trailing silence: the delay's frames and 8 more."""
    pcm = decode_audio(path, int(acfg.mimi.sample_rate))
    tail = (acfg.asr_delay_in_tokens + 8) * acfg.mimi.frame_size
    return np.concatenate([pcm, np.zeros(tail, np.float32)])


def transcribe_file(path: str, config_path: Optional[str] = None, vad: bool = False,
                    module_name: Optional[str] = None, engine=None, device="cuda",
                    cuda_graph: bool = True) -> dict:
    """One file -> ``{"words": [{"text", "start_s", "stop_s"}], "text"}``
    (and ``"vad"``, the steps' probabilities, with ``vad``)."""
    return transcribe_files([path], config_path, vad, module_name, engine, device=device,
                            cuda_graph=cuda_graph)[0]


def transcribe_files(paths, config_path: Optional[str] = None, vad: bool = False,
                     module_name: Optional[str] = None, engine=None, batch_cap: int = 16,
                     device="cuda", cuda_graph: bool = True) -> list:
    """N files on the batch dimension, ``batch_cap`` at a time -> one
    :func:`transcribe_file` result a path, in order.  ``cuda_graph=False``
    runs the eager step on the card too.  The steps (a captured graph and a
    state a batch size) live for this call only."""
    if engine is None:
        engine = build_asr_engine(config_path, module_name, device)
    acfg = engine.cfg
    pcms = [_padded_pcm(p, acfg) for p in paths]
    steps = {}
    results = []
    for g0 in range(0, len(pcms), batch_cap):
        group = pcms[g0:g0 + batch_cap]
        if len(group) not in steps:
            steps[len(group)] = _OfflineStep(engine, acfg, len(group), cuda_graph)
        results.extend(_scan_transcribe(engine, acfg, group, vad, steps[len(group)]))
    return results


class _OfflineStep:
    """The ASR step for B files on the engine's device and params: on CUDA
    captured once (on a state reset to fresh afterwards) and replayed a
    frame at a time, each replay's outputs copied into the dispatch's
    device arrays; on the CPU, or with ``cuda_graph=False``, the eager
    step."""

    def __init__(self, engine, acfg, b: int, cuda_graph: bool = True):
        self.acfg, self.params, self.b = acfg, engine.params, b
        self.device = dev = engine.device
        self.cache_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        self.state = ASR.init_state(acfg, b, self.cache_dtype, dev)
        frame = acfg.mimi.frame_size
        self.inputs = {"pcm": torch.zeros((b, 1, frame), device=dev),
                       "mask": torch.zeros(b, dtype=torch.bool, device=dev),
                       "reset": torch.zeros(b, dtype=torch.bool, device=dev),
                       "seeds": torch.zeros(b, dtype=torch.int64, device=dev)}
        self.graph = None
        if dev.type == "cuda" and cuda_graph:
            self.graph, self.out = capture(self._body, 2, dev)

    def reset(self) -> None:
        """A fresh state in the same buffers: every transcription starts
        from it, whatever the capture's warm steps or an earlier file left."""
        copy_into(self.state, ASR.init_state(self.acfg, self.b, self.cache_dtype, self.device))

    def _body(self) -> dict:
        x = self.inputs
        return ASR.step_in_place(self.acfg, self.params, self.state, x["pcm"], x["mask"],
                                 x["reset"], seeds=x["seeds"])

    def frame(self, pcm: torch.Tensor, mask: torch.Tensor) -> dict:
        """One frame of every file -> the step's ``text_token``,
        ``step_idx`` and ``prs`` on the device (the graph's static outputs,
        valid until the next call)."""
        self.inputs["pcm"].copy_(pcm)
        self.inputs["mask"].copy_(mask)
        if self.graph is not None:
            self.graph.replay()
            return self.out
        return self._body()


def _scan_transcribe(engine, acfg, pcms, vad, runner: _OfflineStep) -> list:
    """The batched path: ``pcms`` (already padded) on the batch dimension,
    K frames a dispatch, one fetch a dispatch, through ``runner``."""
    b = len(pcms)
    frame = acfg.mimi.frame_size
    frames_per = [len(p) // frame for p in pcms]
    n_frames = max(frames_per)
    k = min(CHUNK_FRAMES, max(1, n_frames))
    n_prs = (acfg.lm.extra_heads or (0, 0))[0]
    runner.reset()
    dev = engine.device
    words_state = ASR.WordState(acfg, b)
    words = [[] for _ in range(b)]
    vad_steps = [[] for _ in range(b)]
    open_word = [None] * b
    with torch.inference_mode():
        for c0 in range(0, n_frames, k):
            nk = min(k, n_frames - c0)
            pcm_k = np.zeros((nk, b, 1, frame), np.float32)
            mask_k = np.zeros((nk, b), bool)
            for i, (pcm, nf) in enumerate(zip(pcms, frames_per)):
                hi = min(c0 + nk, nf)
                if hi > c0:
                    pcm_k[:hi - c0, i, 0, :] = pcm[c0 * frame:hi * frame].reshape(-1, frame)
                    mask_k[:hi - c0, i] = True
            pcm_d = torch.from_numpy(pcm_k).to(dev)
            mask_d = torch.from_numpy(mask_k).to(dev)
            text_d = torch.empty((nk, b), dtype=torch.int32, device=dev)
            steps_d = torch.empty((nk, b), dtype=torch.int32, device=dev)
            prs_d = torch.empty((nk, b, n_prs), dtype=torch.float32, device=dev)
            for i in range(nk):
                out = runner.frame(pcm_d[i], mask_d[i])
                text_d[i].copy_(out["text_token"])
                steps_d[i].copy_(out["step_idx"])
                prs_d[i].copy_(out["prs"])
            text_k, steps_k = text_d.cpu().numpy(), steps_d.cpu().numpy()
            prs_k = prs_d.cpu().numpy()
            for i in range(nk):
                if vad and n_prs:
                    for j in range(b):
                        if mask_k[i, j]:
                            vad_steps[j].append({"step_idx": int(steps_k[i, j]),
                                                 "prs": prs_k[i, j].tolist()})
                for ev in words_state.process(text_k[i], steps_k[i], mask_k[i]):
                    _word_event(engine, ev, words[ev.batch_idx], open_word, ev.batch_idx)
    return [_result(words[j], vad_steps[j] if vad else None) for j in range(b)]


def _word_event(engine, ev, words: list, open_word: list, j: int) -> None:
    if isinstance(ev, ASR.WordEvent):
        open_word[j] = {"text": engine.tokenizer.decode(ev.tokens),
                        "start_s": ev.start_time, "stop_s": None}
        words.append(open_word[j])
    elif isinstance(ev, ASR.EndWordEvent) and open_word[j] is not None:
        open_word[j]["stop_s"] = ev.stop_time
        open_word[j] = None


def _result(words: list, vad_steps: Optional[list]) -> dict:
    result = {"words": [{"text": w["text"], "start_s": w["start_s"], "stop_s": w["stop_s"]}
                        for w in words],
              "text": " ".join(w["text"] for w in words)}
    if vad_steps is not None:
        result["vad"] = vad_steps
    return result


def transcribe_per_frame(path: str, engine, vad: bool = False) -> dict:
    """:func:`transcribe_file` frame by frame: the eager step on one slot and a
    fetch a frame (the reference of the batched path)."""
    acfg = engine.cfg
    pcm = _padded_pcm(path, acfg)
    dev = engine.device
    frame = acfg.mimi.frame_size
    cache_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    state = ASR.init_state(acfg, 1, cache_dtype, dev)
    words_state = ASR.WordState(acfg, 1)
    mask = torch.ones(1, dtype=torch.bool, device=dev)
    reset = torch.zeros(1, dtype=torch.bool, device=dev)
    seeds = torch.zeros(1, dtype=torch.int64, device=dev)
    mask_h = np.ones(1, bool)
    words, vad_steps, open_word = [], [], [None]
    with torch.inference_mode():
        for i in range(len(pcm) // frame):
            chunk = torch.from_numpy(pcm[i * frame:(i + 1) * frame]).to(dev)[None, None, :]
            out, state = ASR.step(acfg, engine.params, state, chunk, mask, reset, seeds=seeds)
            text = out["text_token"].cpu().numpy()
            steps = out["step_idx"].cpu().numpy()
            if vad and out["prs"].shape[-1]:
                vad_steps.append({"step_idx": int(steps[0]),
                                  "prs": out["prs"].cpu().numpy()[0].tolist()})
            for ev in words_state.process(text, steps, mask_h):
                _word_event(engine, ev, words, open_word, 0)
    return _result(words, vad_steps if vad else None)


def synthesize_file(text: str, out_path: str, config_path: Optional[str] = None,
                    engine=None, device="cuda") -> dict:
    """``text`` -> a 24 kHz wav at ``out_path``; returns its duration and
    the word transcript."""
    if engine is None:
        engine = build_tts_engine(config_path, device)
    pcm, transcript = engine.synthesize(text)
    write_wav(out_path, pcm, SAMPLE_RATE)
    return {
        "out": out_path,
        "duration_s": round(len(pcm) / float(SAMPLE_RATE), 3),
        "transcript": [{"text": w.text, "start_s": w.start_s, "stop_s": w.stop_s}
                       for w in transcript],
    }


def synthesize_jsonl(jsonl_path: str, out_dir: str, config_path: Optional[str] = None,
                     engine=None, device="cuda") -> list:
    """Synthesis of the reference's audio/tts.jsonl format: one JSON object a
    line with ``id``, ``turns`` (utterances, joined) and ``voices`` (the
    first one used, as ``?voice=``); ``<id>.wav`` a line in ``out_dir``.
    Returns the manifest.  A batched engine takes the lines at once, one
    slot each, with seed ``line + 1``; a single-session engine one after
    the other."""
    if engine is None:
        engine = build_tts_engine(config_path, device)
    os.makedirs(out_dir, exist_ok=True)
    sig = inspect.signature(engine.synthesize).parameters

    def item_kwargs(item):
        voice = (item.get("voices") or [None])[0]
        kw = {}
        if voice:
            try:
                if "ca_kv" in sig:
                    kw["ca_kv"] = engine.voice_kv(voice)
                elif "voice_ca" in sig:
                    kw["voice_ca"] = engine.voice_kv(voice)
            except FileNotFoundError:
                pass  # the voice's files are not available locally: unconditioned
        return kw

    with open(jsonl_path) as f:
        items = [json.loads(ln) for ln in f if ln.strip()]
    manifest = []

    def emit(item, pcm, transcript):
        out_path = os.path.join(out_dir, f"{item.get('id', len(manifest))}.wav")
        write_wav(out_path, pcm, SAMPLE_RATE)
        manifest.append({"id": item.get("id"), "out": out_path,
                         "duration_s": round(len(pcm) / float(SAMPLE_RATE), 3),
                         "words": len(transcript)})

    if hasattr(engine, "open_session") and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor

        started = not engine.running
        if started:
            engine.start()
        try:
            def run(i):
                item = items[i]
                return engine.synthesize(" ".join(item.get("turns", [])), seed=i + 1,
                                         **item_kwargs(item))

            with ThreadPoolExecutor(max_workers=min(engine.batch_size, len(items))) as ex:
                for i, (pcm, transcript) in enumerate(ex.map(run, range(len(items)))):
                    emit(items[i], pcm, transcript)
        finally:
            if started:
                engine.stop()
                if engine.thread is not None:
                    engine.thread.join()  # its last tick ends before the call returns
    else:
        for item in items:
            pcm, transcript = engine.synthesize(" ".join(item.get("turns", [])),
                                                **item_kwargs(item))
            emit(item, pcm, transcript)
    return manifest
