"""Token sampling (counterpart of ``dsm_tpu/ops/sampling.py``), greedy only.

The STT configs decode at temperature 0.  Seeded sampling at temperature
> 0 needs a torch copy of JAX's threefry bits for token parity and is not
ported yet (ROADMAP.md); asking for it raises.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0


def sample(cfg: SamplingConfig, logits: torch.Tensor) -> torch.Tensor:
    """Token ids ``(...,) int32`` from ``logits (..., V)``: the first
    maximum, as ``jnp.argmax``."""
    if cfg.temperature > 0.0:
        raise NotImplementedError(
            "sampling at temperature > 0 is not ported yet; see ROADMAP.md")
    return torch.argmax(logits, dim=-1).to(torch.int32)
