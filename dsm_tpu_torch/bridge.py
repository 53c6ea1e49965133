"""Carry a JAX param or state tree, given as numpy arrays, into torch.

The JAX package keeps a transformer's layers stacked on a leading axis
(``vmap`` over ``transformer.init``); the port keeps a list of per-layer
dicts.  :func:`from_numpy_tree` splits that axis under every key ending in
``transformer``.  Weight-only int8 ``{"q", "s"}`` leaves stay dicts; 0-d
arrays (the ring tick ``pos``) become Python ints or floats.

numpy has no bf16 of its own: JAX hands bf16 arrays over with the
``bfloat16`` dtype of ``ml_dtypes``, which goes through ``view(np.uint16)``
into ``torch.bfloat16`` with its bits unchanged.  Callers convert their JAX
tree with ``jax.tree_util.tree_map(np.asarray, tree)`` first; this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array -> a tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device) if device is not None else t


def split_layers(stacked, n: int) -> list:
    """A tree whose leaves carry a leading layer axis -> ``n`` layer trees."""

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return [take(stacked, i) for i in range(n)]


def _leading(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return len(node)


def from_numpy_tree(tree, device=None):
    """Convert a numpy tree (dicts, lists, arrays) to the port's layout."""

    def conv(name, node):
        if isinstance(node, dict):
            if name.endswith("transformer"):
                node = split_layers(node, _leading(node))
                return [conv("", layer) for layer in node]
            return {k: conv(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(name, v) for v in node]
        a = np.asarray(node)
        if a.ndim == 0:
            return a.item()
        return to_tensor(a, device)

    return conv("", tree)
