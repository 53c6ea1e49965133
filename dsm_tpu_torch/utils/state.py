"""The write-back of a step's new state into the buffers of the old one.

The steps (``sessions.asr.step``, ``sessions.tts.step``,
``models.mimi.decode_step``) return new state trees; their fixed-buffer forms
write each new tensor back into the old tree's own tensor, so that the state
keeps its buffers from step to step (the counterpart of the JAX engines'
buffer donation) and a captured CUDA graph can replay the step on them.
"""

from __future__ import annotations

import torch


def copy_into(dst, src) -> None:
    """Write each tensor of the state tree ``src`` into the tensor at the
    same place of ``dst``, in place; a tensor of ``src`` that is ``dst``'s
    own (a ring the step wrote in place) is left as it is."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"state trees differ: {sorted(dst)} / {sorted(src)}")
        for key in dst:
            copy_into(dst[key], src[key])
    elif isinstance(dst, list):
        for a, b in zip(dst, src, strict=True):
            copy_into(a, b)
    elif isinstance(dst, torch.Tensor):
        if src is dst:
            return
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"state tensor {tuple(src.shape)} {src.dtype} does not fit "
                             f"its buffer {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    else:
        raise TypeError(f"state leaf of type {type(dst).__name__}")
