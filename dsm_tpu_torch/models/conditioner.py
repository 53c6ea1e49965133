"""Condition providers (counterpart of ``dsm_tpu/models/conditioner.py``).

Both conditioner families give an additive ``(1, D)`` bias on the LM input
embedding:

* :class:`LutConfig`: a discrete attribute (the TTS ``description``
  quality) -> an embedding -> ``output_proj``;
* :class:`ContinuousAttributeConfig`: a scalar (the STT delay conditioning)
  -> sinusoidal features -> ``output_proj``.

:meth:`ConditionProvider.load_params` adopts the provider's weights from an
LM checkpoint's ``condition_provider.conditioners.*`` keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LutConfig:
    n_bins: int
    dim: int
    possible_values: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ContinuousAttributeConfig:
    dim: int
    scale_factor: float
    max_period: float


ConditionerConfig = Union[LutConfig, ContinuousAttributeConfig]


def _normal(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def lut_init(cfg: LutConfig, output_dim: int, gen: torch.Generator,
             dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, distributed as the JAX init."""
    return {
        "embed": (_normal(gen, cfg.n_bins + 1, cfg.dim) * 0.02).to(dtype),
        "output_proj": (_normal(gen, output_dim, cfg.dim) / math.sqrt(cfg.dim)).to(dtype),
        "learnt_padding": (_normal(gen, 1, output_dim) * 0.02).to(dtype),
    }


def lut_condition(cfg: LutConfig, params: dict, value: str) -> torch.Tensor:
    """An attribute value -> ``(1, D)`` additive condition."""
    try:
        idx = cfg.possible_values.index(value)
    except ValueError:
        raise KeyError(f"unknown value for lut conditioner {value!r}") from None
    emb = params["embed"][idx]
    return (emb @ params["output_proj"].T)[None, :]


def continuous_init(cfg: ContinuousAttributeConfig, output_dim: int, gen: torch.Generator,
                    dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, distributed as the JAX init."""
    return {
        "output_proj": (_normal(gen, output_dim, cfg.dim) / math.sqrt(cfg.dim)).to(dtype),
        "learnt_padding": (_normal(gen, 1, output_dim) * 0.02).to(dtype),
    }


def continuous_condition(cfg: ContinuousAttributeConfig, params: dict,
                         value: float) -> torch.Tensor:
    """``concat(cos, sin)`` of ``scale_factor * value / max_period ** (i /
    (dim/2 - 1))`` -> ``output_proj`` -> ``(1, D)``."""
    dev = params["output_proj"].device
    half = cfg.dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.max_period, dtype=torch.float32, device=dev),
                               idx / (half - 1))
    freqs = np.float32(value * cfg.scale_factor) * inv_freq
    feat = torch.cat([torch.cos(freqs), torch.sin(freqs)])[None, :]
    return feat.to(params["output_proj"].dtype) @ params["output_proj"].T


class ConditionProvider:
    """Conditioners by name."""

    def __init__(self, output_dim: int, configs: Dict[str, ConditionerConfig],
                 gen: torch.Generator):
        self.configs = configs
        self.params: Dict[str, dict] = {}
        for name, cfg in sorted(configs.items()):
            init = lut_init if isinstance(cfg, LutConfig) else continuous_init
            self.params[name] = init(cfg, output_dim, gen)

    def condition_lut(self, name: str, value: str) -> torch.Tensor:
        cfg = self.configs[name]
        if not isinstance(cfg, LutConfig):
            raise TypeError(f"conditioner {name} is not a Lut")
        return lut_condition(cfg, self.params[name], value)

    def condition_cont(self, name: str, value: float) -> torch.Tensor:
        cfg = self.configs[name]
        if not isinstance(cfg, ContinuousAttributeConfig):
            raise TypeError(f"conditioner {name} is not continuous")
        return continuous_condition(cfg, self.params[name], value)

    def learnt_padding(self, name: str) -> torch.Tensor:
        return self.params[name]["learnt_padding"]

    def load_params(self, tensors: Mapping,
                    prefix: str = "condition_provider.conditioners") -> int:
        """Overwrite the provider's weights from a checkpoint's tensors
        (``<prefix>.<name>.{embed.weight, output_proj.weight,
        learnt_padding}``), each kept in the checkpoint's dtype (bf16 where
        the file stores BF16), as the JAX provider keeps it, on the device of
        the weight it replaces.  Returns the number of tensors adopted."""
        stored = getattr(tensors, "dtype", None)
        n = 0
        for name, params in self.params.items():
            for ours, theirs in (("embed", f"{prefix}.{name}.embed.weight"),
                                 ("output_proj", f"{prefix}.{name}.output_proj.weight"),
                                 ("learnt_padding", f"{prefix}.{name}.learnt_padding")):
                if theirs in tensors and ours in params:
                    t = torch.from_numpy(np.array(tensors[theirs]))
                    if stored is not None and stored(theirs) == "BF16":
                        t = t.to(torch.bfloat16)
                    if ours == "learnt_padding":
                        t = t.reshape(1, -1)
                    params[ours] = t.to(params[ours].device)
                    n += 1
        return n


def configs_from_toml(raw: Dict[str, dict]) -> Dict[str, ConditionerConfig]:
    """Parse a ``[modules.x.model.conditioners]`` table (tag ``type``)."""
    out: Dict[str, ConditionerConfig] = {}
    for name, c in raw.items():
        typ = c.get("type")
        if typ == "Lut":
            out[name] = LutConfig(n_bins=c["n_bins"], dim=c["dim"],
                                  possible_values=tuple(c["possible_values"]))
        elif typ == "ContinuousAttribute":
            out[name] = ContinuousAttributeConfig(dim=c["dim"], scale_factor=c["scale_factor"],
                                                  max_period=c["max_period"])
        else:
            raise ValueError(f"unknown conditioner type {typ!r}")
    return out
