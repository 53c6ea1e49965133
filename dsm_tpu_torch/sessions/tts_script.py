"""The TTS word-feed constraint machine on the device (counterpart of
``dsm_tpu/sessions/tts_script.py``).

The host driver (``server/tts_batched.TtsSlot``) picks each frame's text
constraint from its word queue and the last sampled token, so every frame
would need the sampled token back on the host before the next one could
start.  Here the script lives on the device as a ring of word-piece tokens
tagged with the index of their word, and the constraint is arithmetic over
per-slot pointers, so ``fuse_ticks`` frames run in one dispatch
(``server/tts_batched.py``).  The host keeps its ``TtsSlot`` as a mirror that
replays the fetched text tokens through the same rules for word events and
flow control; both see the same uploaded script and the same tokens.

Machine state (per slot, batch-leading tensors):

* ``toks`` / ``word_of`` ``(B, CAP)``: the script ring, token id and the
  index of its word (-1 where unwritten);
* ``ptr``: absolute index of the next unconsumed token (the host keeps
  ``n_toks - ptr <= CAP`` by holding uploads back);
* ``widx``: the current word (-1 before the first, the host's empty word);
* ``n_toks`` / ``n_words``: tokens and words uploaded;
* ``eos``: the input has ended; ``drained``: the final end-of-word was
  consumed, pads follow; ``past_last``: steps since drained (the session is
  over once it exceeds ``extra_steps + text_audio_delay_in_tokens``);
* ``active``: the slot is open and not over.

:func:`constraint_in_place` and :func:`advance_in_place` write the machine's
own buffers (``utils/state.copy_into``), so a captured CUDA graph replays
them, as ``sessions.tts.step_in_place`` does for the model state.
:func:`apply_ops` applies a table of queued host updates with a fixed number
of launches, whatever the number of ops, and gives the sequential result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.state import copy_into
from . import tts as TTS

WORD_CHUNK = 16  # tokens of one upload op; longer words go in chunks

OP_NOP, OP_INIT, OP_DEACT, OP_EOS, OP_WORD = 0, 1, 2, 3, 4

# Columns of an op table row (:func:`apply_ops`): kind, slot, count, word
# index, start, then the WORD_CHUNK tokens.
OP_COLS = 5 + WORD_CHUNK


@dataclasses.dataclass(frozen=True)
class ScriptConsts:
    """Token ids and the completion bound, from the TTS config."""

    pad: int
    eop: int
    done_bound: int  # extra_steps + text_audio_delay_in_tokens

    @classmethod
    def from_cfg(cls, cfg: TTS.TtsConfig) -> "ScriptConsts":
        return cls(pad=cfg.text_pad_token, eop=cfg.text_eop_token,
                   done_bound=cfg.extra_steps + cfg.text_audio_delay_in_tokens)


def init(batch: int, cap: int, device=None) -> dict:
    # WORD_CHUNK consecutive ring indices must be distinct mod cap, or one
    # upload op would write a cell twice.
    if cap < WORD_CHUNK:
        raise ValueError(f"script cap {cap} < WORD_CHUNK {WORD_CHUNK}")

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "toks": full((batch, cap), 0),
        "word_of": full((batch, cap), -1),
        "ptr": full((batch,), 0),
        "widx": full((batch,), -1),
        "n_toks": full((batch,), 0),
        "n_words": full((batch,), 0),
        "eos": full((batch,), False, torch.bool),
        "drained": full((batch,), False, torch.bool),
        "past_last": full((batch,), 0),
        "active": full((batch,), False, torch.bool),
    }


def _row(m: dict, slot: int, **values) -> dict:
    out = {k: v.clone() for k, v in m.items()}
    for key, value in values.items():
        out[key][slot] = value
    return out


def reset_row(m: dict, slot: int) -> dict:
    """One slot re-initialised for a new session."""
    return _row(m, slot, toks=0, word_of=-1, ptr=0, widx=-1, n_toks=0, n_words=0,
                eos=False, drained=False, past_last=0, active=True)


def deactivate_row(m: dict, slot: int) -> dict:
    return _row(m, slot, active=False)


def set_eos_row(m: dict, slot: int) -> dict:
    return _row(m, slot, eos=True)


def write_word_chunk(m: dict, slot: int, toks, count: int, word_id: int,
                     start: int) -> dict:
    """``count`` tokens of word ``word_id`` at absolute position ``start``
    (ring-wrapped); ``toks``: ``WORD_CHUNK`` tokens, the first ``count``
    valid.  The counters take the host's values after the write."""
    cap = m["toks"].shape[1]
    toks = torch.as_tensor(toks, dtype=torch.int32)
    out = {k: v.clone() for k, v in m.items()}
    idx = [(start + i) % cap for i in range(count)]
    out["toks"][slot, idx] = toks[:count].to(out["toks"].device)
    out["word_of"][slot, idx] = word_id
    out["n_toks"][slot] = start + count
    out["n_words"][slot] = word_id + 1
    return out


def op_table(ops) -> np.ndarray:
    """Host ops ``[(kind, slot, toks, count, word_id, start)]`` -> the int32
    table ``(N, OP_COLS)`` that :func:`apply_ops` reads."""
    table = np.zeros((len(ops), OP_COLS), np.int32)
    for i, (kind, slot, toks, count, wid, start) in enumerate(ops):
        table[i, :5] = (kind, slot, count, wid, start)
        if toks is not None:
            table[i, 5:] = toks
    return table


def apply_ops(m: dict, table: torch.Tensor) -> None:
    """Apply the ops of ``table (N, OP_COLS)`` (rows of :func:`op_table`,
    OP_NOP rows ignored) to ``m`` in place, with the result of applying them
    one by one in row order.

    Per slot, its last OP_INIT wins over every op before it; after it, a
    field takes the value of the last op that writes it: ``active`` from the
    last OP_INIT / OP_DEACT, ``eos`` from an OP_EOS after the last OP_INIT,
    ``n_toks`` / ``n_words`` from the last OP_WORD, each ring cell from the
    last OP_WORD lane that writes it.  The last writer is a scatter-amax of
    the op's row index, which no order of the scatter changes."""
    n, b, cap = table.shape[0], m["toks"].shape[0], m["toks"].shape[1]
    if n == 0:
        return
    dev = table.device
    kind, slot = table[:, 0], table[:, 1].long()
    count, wid, start = table[:, 2], table[:, 3], table[:, 4].long()
    toks = table[:, 5:]
    row = torch.arange(n, device=dev)

    def last(sel: torch.Tensor) -> torch.Tensor:
        """Per slot, the last row with ``sel`` on that slot, else -1."""
        out = torch.full((b,), -1, dtype=torch.int64, device=dev)
        return out.scatter_reduce(0, slot, torch.where(sel, row, -1), "amax")

    last_init = last(kind == OP_INIT)
    inited = last_init >= 0
    last_act = last((kind == OP_INIT) | (kind == OP_DEACT))
    last_eos = last(kind == OP_EOS)
    is_word = kind == OP_WORD
    last_word = last(is_word)
    word = last_word.clamp(min=0)
    worded = last_word > last_init

    new = {
        "ptr": torch.where(inited, 0, m["ptr"]),
        "widx": torch.where(inited, -1, m["widx"]),
        "drained": m["drained"] & ~inited,
        "past_last": torch.where(inited, 0, m["past_last"]),
        "active": torch.where(last_act >= 0, kind[last_act.clamp(min=0)] == OP_INIT,
                              m["active"]),
        "eos": torch.where(last_eos > last_init, True, m["eos"] & ~inited),
        "n_toks": torch.where(worded, (start[word] + count[word].long()).to(torch.int32),
                              torch.where(inited, 0, m["n_toks"])),
        "n_words": torch.where(worded, wid[word] + 1, torch.where(inited, 0, m["n_words"])),
    }
    # Ring cells: the last live lane that writes each, keyed row * WORD_CHUNK
    # + lane; lanes of ops before their slot's last OP_INIT are dead.
    lane = torch.arange(WORD_CHUNK, device=dev)
    live = (is_word & (row > last_init[slot]))[:, None] & (lane[None, :] < count[:, None])
    cell = slot[:, None] * cap + (start[:, None] + lane[None, :]) % cap
    key = torch.where(live, row[:, None] * WORD_CHUNK + lane[None, :], -1)
    writer = torch.full((b * cap,), -1, dtype=torch.int64, device=dev)
    writer = writer.scatter_reduce(0, cell.reshape(-1), key.reshape(-1), "amax")
    written = writer >= 0
    w = writer.clamp(min=0)
    cleared = inited[:, None].expand(b, cap).reshape(-1)
    for name, value, blank in (("toks", toks.reshape(-1)[w], 0),
                               ("word_of", wid[w // WORD_CHUNK], -1)):
        old = m[name].reshape(-1)
        new[name] = torch.where(written, value, torch.where(cleared, blank, old)).view(b, cap)
    copy_into({k: m[k] for k in new}, new)


def constraint(cc: ScriptConsts, m: dict):
    """-> ``(mode, token, step_mask, m')``: :meth:`TtsSlot.next_constraint`
    over the batch.  Drained slots force pad and count toward the end,
    in-word slots force the next word piece, the others leave pad or
    end-of-word to the model."""
    cap = m["toks"].shape[1]
    drained = m["drained"]
    past = m["past_last"] + drained.to(torch.int32)
    done = drained & (past > cc.done_bound)
    active = m["active"] & ~done
    phys = (m["ptr"] % cap)[:, None].long()
    cur_word = m["word_of"].gather(1, phys)[:, 0]
    cur_tok = m["toks"].gather(1, phys)[:, 0]
    in_word = ~drained & (m["widx"] >= 0) & (m["ptr"] < m["n_toks"]) & (cur_word == m["widx"])
    mode = torch.where(drained, TTS.ALLOW_PAD,
                       torch.where(in_word, TTS.ALLOW_TEXT, TTS.ALLOW_PAD_OR_EPAD))
    tok = torch.where(in_word, cur_tok, 0)
    return mode.to(torch.int32), tok.to(torch.int32), active, dict(m, past_last=past,
                                                                   active=active)


def advance(cc: ScriptConsts, m: dict, text_token: torch.Tensor, stepped: torch.Tensor):
    """Consume the frame's ``text_token`` (:meth:`TtsSlot.on_text_token`) ->
    ``(m', patch)``: an end-of-word enters the next word, drains the session
    after its input ended, or leaves it starved; any other non-pad token
    consumes one script position.  ``patch``: the slots whose final
    end-of-word becomes a pad in the text history."""
    is_eop = (text_token == cc.eop) & stepped & ~m["drained"]
    is_txt = (text_token != cc.eop) & (text_token != cc.pad) & stepped
    words_remain = (m["widx"] + 1) < m["n_words"]
    adv_word = is_eop & words_remain
    drain_now = is_eop & ~words_remain & m["eos"]
    return dict(m, widx=torch.where(adv_word, m["widx"] + 1, m["widx"]),
                ptr=torch.where(is_txt, m["ptr"] + 1, m["ptr"]),
                drained=m["drained"] | drain_now), drain_now


def constraint_in_place(cc: ScriptConsts, m: dict):
    """:func:`constraint` with ``past_last`` and ``active`` written back
    into ``m``'s own buffers -> ``(mode, token, step_mask)``."""
    mode, tok, active, new = constraint(cc, m)
    copy_into(m, new)
    return mode, tok, m["active"]


def advance_in_place(cc: ScriptConsts, m: dict, text_token: torch.Tensor,
                     stepped: torch.Tensor) -> torch.Tensor:
    """:func:`advance` written back into ``m``'s own buffers -> ``patch``."""
    new, patch = advance(cc, m, text_token, stepped)
    copy_into(m, new)
    return patch
