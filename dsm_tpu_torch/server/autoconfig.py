"""Batch sizing from the device's memory (counterpart of
``dsm_tpu/server/autoconfig.py``).

The per-slot cost is estimated from the KV-cache geometry and the weights
from the model's widths, as the JAX package estimates them; the configured
batch size is clamped to what fits the card's memory less a reserve.  The
JAX package reads the reserve from the environment; here it is an argument.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

log = logging.getLogger("dsm.torch.autoconfig")

DEFAULT_RESERVED_MB = 1024.0
SAFETY_MULT = 1.25  # activations and fragmentation headroom


def device_memory_bytes(device) -> Optional[int]:
    """The card's total memory, or None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def per_slot_bytes(lm_cfg, cache_bytes_per_el: int = 2) -> int:
    """KV-cache cost of one batch slot: K and V of every LM layer over the
    context, plus the Mimi codec transformers' caches."""
    t = lm_cfg.transformer
    lm_kv = 2 * t.num_layers * t.num_heads * t.context * t.hd * cache_bytes_per_el
    # Mimi codec transformer: 8 layers, 8 heads, context 250 (+1), Dh 64, f32.
    mimi_kv = 2 * 8 * 8 * 251 * 64 * 4 * 2  # encoder and decoder
    return int((lm_kv + mimi_kv) * SAFETY_MULT)


def model_bytes(lm_cfg, bytes_per_el: int = 2) -> int:
    """The weights: 4 attention and 3 feed-forward matrices a layer, plus the
    embedding tables."""
    t = lm_cfg.transformer
    core = t.num_layers * (4 * t.d_model * t.num_heads * t.hd
                           + 3 * t.d_model * t.dim_feedforward)
    embeddings = (
        lm_cfg.text_in_vocab_size + lm_cfg.text_out_vocab_size
        + lm_cfg.audio_codebooks * lm_cfg.audio_vocab_size
    ) * t.d_model
    return (core + embeddings) * bytes_per_el


def auto_batch_size(requested: int, lm_cfg, total_bytes: Optional[int],
                    reserved_mb: float = DEFAULT_RESERVED_MB) -> int:
    """``requested`` clamped to the slots that fit ``total_bytes`` of device
    memory less the reserve and the weights; ``total_bytes`` None (the CPU):
    ``requested`` as it is."""
    if total_bytes is None:
        return requested
    slot = per_slot_bytes(lm_cfg)
    budget = total_bytes - reserved_mb * 2**20 - model_bytes(lm_cfg)
    if budget <= 0:
        log.warning("device memory exhausted by weights; batch clamped to 1")
        return 1
    fit = max(int(budget // slot), 1)
    if fit < requested:
        log.warning("clamping batch_size %d -> %d (device memory %.1f GiB, %.0f MiB/slot)",
                    requested, fit, total_bytes / 2**30, slot / 2**20)
        return fit
    return requested
