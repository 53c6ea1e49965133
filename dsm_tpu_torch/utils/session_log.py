"""Per-session token logging for offline replay and debugging (counterpart of
``dsm_tpu/utils/session_log.py``).

Reference: the servers dump text and audio token streams as safetensors
(moshi-server/src/asr.rs:126-175 token logging, batched_asr.rs Logger
:133-214 periodic flush, tts.rs:116-167, moshi-backend stream_both.rs:612-672,
which also writes a JSON transcript sidecar).  The files are the JAX
package's: ``<instance>-<session>.safetensors`` with ``text_tokens (T,)`` and
``audio_tokens (T, K)`` int32, and ``<instance>-<session>.json`` with
``{"meta", "transcript"}``.  They are written and read through
``utils/checkpoint.py``'s safetensors writer and reader, so no safetensors
package is needed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from .checkpoint import load_safetensors, save_safetensors


class SessionLogger:
    """Accumulates per-session token steps; writes them every
    ``flush_every_steps`` steps and when the session closes."""

    def __init__(self, log_dir: str, instance_name: str = "dsm-tpu",
                 flush_every_steps: int = 500):
        self.log_dir = log_dir
        self.instance = instance_name
        self.flush_every = flush_every_steps
        self._lock = threading.Lock()
        self._sessions: Dict[str, dict] = {}
        os.makedirs(log_dir, exist_ok=True)

    def open_session(self, session_id: str, meta: Optional[dict] = None) -> None:
        with self._lock:
            self._sessions[session_id] = {"text": [], "audio": [], "meta": meta or {},
                                          "started": time.time(), "steps_since_flush": 0,
                                          "transcript": []}

    def log_step(self, session_id: str, text_token: int, audio_tokens) -> None:
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                return
            s["text"].append(int(text_token))
            s["audio"].append(np.asarray(audio_tokens, np.int32))
            s["steps_since_flush"] += 1
            flush = s["steps_since_flush"] >= self.flush_every
        if flush:
            self.flush(session_id)

    def log_word(self, session_id: str, text: str, start_s: float,
                 stop_s: Optional[float]) -> None:
        with self._lock:
            s = self._sessions.get(session_id)
            if s is not None:
                s["transcript"].append({"text": text, "start_s": start_s, "stop_s": stop_s})

    def flush(self, session_id: str) -> Optional[str]:
        """Write everything logged so far -> the ``.safetensors`` path, or
        None for an unknown or empty session."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None or not s["text"]:
                return None
            text = np.asarray(s["text"], np.int32)
            audio = np.stack(s["audio"]) if s["audio"] else np.zeros((0, 0), np.int32)
            transcript = list(s["transcript"])
            meta = dict(s["meta"])
            s["steps_since_flush"] = 0
        path = os.path.join(self.log_dir, f"{self.instance}-{session_id}")
        save_safetensors(path + ".safetensors", {"text_tokens": text, "audio_tokens": audio})
        with open(path + ".json", "w") as f:
            json.dump({"meta": meta, "transcript": transcript}, f)
        return path + ".safetensors"

    def close_session(self, session_id: str) -> Optional[str]:
        path = self.flush(session_id)
        with self._lock:
            self._sessions.pop(session_id, None)
        return path


def load_session(path: str):
    """A written session for replay -> ``(text (T,), audio (T, K), meta)``,
    arrays of their own (the file is not kept open)."""
    t = load_safetensors(path)
    text, audio = np.array(t["text_tokens"]), np.array(t["audio_tokens"])
    del t
    meta = {}
    sidecar = path.replace(".safetensors", ".json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    return text, audio, meta
