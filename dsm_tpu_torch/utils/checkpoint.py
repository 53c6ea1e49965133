"""Checkpoints in the reference layout -> the port's param trees
(counterpart of ``dsm_tpu/utils/checkpoint.py``).

The reference key layouts (the VarBuilder paths of moshi-core):

* Mimi: ``encoder.model.{i}.conv.conv.{weight | weight_g + weight_v, bias}``,
  ``decoder.model.{i}.convtr.convtr...``, ``{en,de}coder_transformer.
  transformer.layers.{l}.{self_attn.in_proj_weight, self_attn.out_proj.weight,
  norm1.{alpha,bias}, norm2..., linear1.weight, linear2.weight,
  layer_scale_1.scale, ...}``, ``downsample.conv.conv.conv.weight``,
  ``upsample.convtr.convtr.convtr.weight``, ``quantizer.rvq_{first,rest}.
  {input_proj,output_proj}.weight`` and ``.vq.layers.{q}._codebook.
  {embedding_sum,cluster_usage}``.
* LM: ``text_emb.weight``, ``emb.{k}.weight``, ``out_norm.alpha``,
  ``text_linear.weight``, ``transformer.layers.{l}...``,
  ``extra_heads.{i}.weight`` and the DepFormer, per slice or shared with the
  root through the reference's fallback chains.

Weight-norm convs are re-materialised at load (``g * v / ||v||``).  The
trees come out in the port's layout, the one :func:`bridge.from_numpy_tree`
makes of the JAX loaders' output: a transformer is a list of per-layer dicts
(the DepFormer's a list of per-slice lists), each leaf a tensor of the
requested dtype on the requested device, converted as soon as it is read so
that the checkpoint is not held twice in host memory.

``.safetensors`` files are read and written here, without the safetensors
package: an 8-byte little-endian header length, a JSON header of dtypes,
shapes and byte offsets, then the raw bytes, which are read through
``np.memmap``.  ``.gguf`` files go through :mod:`.gguf`.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Dict, List, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}
_TORCH_ST = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_NP_ST = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
          "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8", "uint64": "U64",
          "uint32": "U32", "uint16": "U16", "uint8": "U8", "bool": "BOOL"}


class SafetensorsFile(Mapping):
    """A ``.safetensors`` file as a read-only mapping name -> numpy array.

    The tensor bytes are mapped (``np.memmap``), not read: an array is a view
    into the map, made when its name is looked up; BF16 is widened to f32
    then (exactly), into a new array of its own."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        self.path = path
        self.metadata = header.pop("__metadata__", None)
        self._info = header
        body = os.path.getsize(path) - 8 - n
        self._map = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n, shape=(body,))
                     if body else np.zeros(0, np.uint8))

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._info[name]
        start, end = info["data_offsets"]
        raw = self._map[start:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return raw.view(np.dtype(_ST_DTYPES[info["dtype"]])).reshape(shape)

    def __iter__(self):
        return iter(self._info)

    def __len__(self) -> int:
        return len(self._info)

    def dtype(self, name: str) -> str:
        """The stored dtype of ``name`` (``"BF16"``, ``"F32"``, ...)."""
        return self._info[name]["dtype"]


def load_safetensors(path: str) -> SafetensorsFile:
    return SafetensorsFile(path)


def _st_bytes(value, dtype: Optional[torch.dtype]):
    """One tensor -> (safetensors dtype, shape, contiguous numpy array of its
    bytes).  ``dtype`` converts floating tensors first (round to nearest
    even, as ``Tensor.to``); bf16 is written as its 16 bits."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        t = t.cpu().contiguous()
        tag = _TORCH_ST[t.dtype]
        arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        return tag, tuple(t.shape), arr
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
        return "BF16", a.shape, np.ascontiguousarray(a)
    if dtype is not None and a.dtype.kind == "f":
        return _st_bytes(torch.from_numpy(np.ascontiguousarray(a)), dtype)
    a = np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"), copy=False)
    return _NP_ST[a.dtype.name], a.shape, a


def _st_meta(value, dtype: Optional[torch.dtype]):
    """(safetensors dtype, shape, bytes) of what :func:`_st_bytes` makes of
    ``value``, without converting it."""
    if isinstance(value, torch.Tensor):
        dt = dtype if dtype is not None and value.is_floating_point() else value.dtype
        shape = tuple(value.shape)
    else:
        a = value if isinstance(value, np.ndarray) else np.asarray(value)
        shape = a.shape
        if a.dtype.name == "bfloat16":
            dt = torch.bfloat16
        elif dtype is not None and a.dtype.kind == "f":
            dt = dtype
        else:
            return _NP_ST[a.dtype.name], shape, a.nbytes
    return _TORCH_ST[dt], shape, int(np.prod(shape, dtype=np.int64)) * dt.itemsize


def save_safetensors(path: str, tensors: Mapping, dtype: Optional[torch.dtype] = None,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors) as ``.safetensors``,
    F32 and BF16 bit for bit; ``dtype`` (e.g. ``torch.bfloat16``) converts
    the floating tensors first.  Each tensor is converted as it is written,
    so at most one host copy is held at a time."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in tensors:
        tag, shape, nbytes = _st_meta(tensors[name], dtype)
        header[name] = {"dtype": tag, "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in tensors:
            _, _, arr = _st_bytes(tensors[name], dtype)
            f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def load_tensors(path: str):
    """A reference checkpoint by extension: ``.gguf`` through the GGUF reader
    (Q8_0 dequantised), anything else as mapped safetensors."""
    if str(path).endswith(".gguf"):
        from . import gguf

        return gguf.read_gguf(path)[1]
    return load_safetensors(path)


# ---------------------------------------------------------------------------
# Native checkpoints: the port's trees keyed by their paths
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def save_native(path: str, tree) -> None:
    """A param tree's tensors, keyed by their paths (``['transformer'][0]
    ['in_proj_w']``), as ``.safetensors``; other leaves are not saved."""
    save_safetensors(path, {k: v for k, v in _flatten(tree) if isinstance(v, torch.Tensor)})


def load_native(path: str, like_tree):
    """A native checkpoint back into the structure of ``like_tree``, each
    tensor in the dtype and on the device of its counterpart there."""
    flat = load_safetensors(path)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}[{k!r}]") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}[{i}]") for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor):
            return node
        if prefix not in flat:
            raise KeyError(f"native checkpoint missing {prefix}")
        t = torch.from_numpy(np.array(flat[prefix]))
        if flat.dtype(prefix) == "BF16":
            t = t.to(torch.bfloat16)
        return t.to(device=node.device, dtype=node.dtype)

    return walk(like_tree, "")


# ---------------------------------------------------------------------------
# Key resolution
# ---------------------------------------------------------------------------


class KeyResolver:
    """Candidate keys -> f32 arrays (from numpy arrays or CPU tensors),
    recording what is missing (the first candidate of each miss)."""

    def __init__(self, tensors: Mapping):
        self.t = tensors
        self.missing: List[str] = []

    def has(self, key: str) -> bool:
        return key in self.t

    def get(self, *candidates: str, shape=None) -> Optional[np.ndarray]:
        for k in candidates:
            if k in self.t:
                v = self.t[k]
                v = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
                if shape is not None and tuple(v.shape) != tuple(shape):
                    raise ValueError(f"{k}: shape {v.shape} != expected {tuple(shape)}")
                return v
        self.missing.append(candidates[0])
        return None

    def conv_weight(self, prefix: str, shape=None) -> Optional[np.ndarray]:
        """A plain or weight-norm conv weight: ``g * v / ||v||`` over the
        input and kernel axes."""
        if f"{prefix}.weight" in self.t:
            return self.get(f"{prefix}.weight", shape=shape)
        if f"{prefix}.weight_v" in self.t:
            g = self.get(f"{prefix}.weight_g")
            v = self.get(f"{prefix}.weight_v", shape=shape)
            norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
            return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
        self.missing.append(f"{prefix}.weight")
        return None


class _Leaf:
    """numpy f32 -> a tensor of ``dtype`` on ``device``; None stays None."""

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.device = device

    def __call__(self, a):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(device=self.device, dtype=self.dtype)


def _stack(vals):
    return None if any(v is None for v in vals) else np.stack(vals)


def _maybe(dst: dict, key: str, val) -> None:
    if val is not None:
        dst[key] = val


def _norm_params(r: KeyResolver, prefix: str, kind: str, d: int) -> dict:
    alpha = r.get(f"{prefix}.alpha", f"{prefix}.weight")
    if alpha is not None:
        alpha = alpha.reshape(d)
    if kind == "rms_norm":
        return {"alpha": alpha}
    return {"alpha": alpha, "bias": r.get(f"{prefix}.bias")}


def transformer_layers_params(r: KeyResolver, prefix: str, cfg, n_layers: Optional[int] = None,
                              leaf=None) -> list:
    """The layers of ``{prefix}.layers.{l}`` as a list of per-layer dicts; a
    key missing from any layer is left out of every layer (and recorded as
    missing).  ``leaf`` converts each array (default: kept as numpy)."""
    leaf = leaf or (lambda a: a)
    n_layers = n_layers or cfg.num_layers
    d = cfg.d_model
    layers = [dict() for _ in range(n_layers)]
    paths: Dict[str, list] = {}

    def push(l: int, path: str, val) -> None:
        paths.setdefault(path, [None] * n_layers)[l] = val

    for l in range(n_layers):
        p = f"{prefix}.layers.{l}"
        push(l, "in_proj_w", r.get(f"{p}.self_attn.in_proj_weight",
                                   f"{p}.self_attn.in_proj.weight"))
        push(l, "out_proj_w", r.get(f"{p}.self_attn.out_proj.weight"))
        for nm in ("norm1", "norm2"):
            for k2, v2 in _norm_params(r, f"{p}.{nm}", cfg.norm, d).items():
                push(l, f"{nm}/{k2}", v2)
        if cfg.gating:
            gp = f"{p}.gating"
            push(l, "mlp/linear_in", r.get(f"{gp}.linear_in.weight",
                                           f"{gp}.0.linear_in.weight"))
            push(l, "mlp/linear_out", r.get(f"{gp}.linear_out.weight",
                                            f"{gp}.0.linear_out.weight"))
        else:
            push(l, "mlp/linear1", r.get(f"{p}.linear1.weight"))
            push(l, "mlp/linear2", r.get(f"{p}.linear2.weight"))
        if cfg.layer_scale is not None:
            push(l, "layer_scale_1", r.get(f"{p}.layer_scale_1.scale"))
            push(l, "layer_scale_2", r.get(f"{p}.layer_scale_2.scale"))
        if cfg.cross_attention:
            cp = f"{p}.cross_attention"
            push(l, "ca_q_w", r.get(f"{cp}.in_proj_weight_q"))
            push(l, "ca_kv_w", r.get(f"{cp}.in_proj_weight_kv"))
            push(l, "ca_out_w", r.get(f"{cp}.out_proj.weight"))
            for k2, v2 in _norm_params(r, f"{p}.norm_cross", cfg.ca_norm or cfg.norm,
                                       d).items():
                push(l, f"norm_cross/{k2}", v2)

    for path, vals in paths.items():
        if any(v is None for v in vals):
            continue
        parts = path.split("/")
        for layer, val in zip(layers, vals):
            cur = layer
            for part in parts[:-1]:
                cur = cur.setdefault(part, {})
            cur[parts[-1]] = leaf(val)
    return layers


# ---------------------------------------------------------------------------
# Mimi
# ---------------------------------------------------------------------------


def _seanet_enc_indices(cfg):
    """Sequential module indices of the encoder (the reference's layer walk,
    which skips the activation slots of the original torch Sequential)."""
    idx = 1
    stages = []
    for _ratio in reversed(cfg.ratios):
        res = []
        for _j in range(cfg.n_residual_layers):
            res.append(idx)
            idx += 1
        stages.append((res, idx + 1))
        idx += 2
    return 0, stages, idx + 1


def _seanet_dec_indices(cfg):
    """The decoder's walk: the upsample first, then the residual blocks."""
    idx = 1
    stages = []
    for _ratio in cfg.ratios:
        up = idx + 1
        idx += 2
        res = []
        for _j in range(cfg.n_residual_layers):
            res.append(idx)
            idx += 1
        stages.append((up, res))
    return 0, stages, idx + 1


def _conv_p(r: KeyResolver, prefix: str, leaf) -> dict:
    out = {}
    _maybe(out, "w", leaf(r.conv_weight(f"{prefix}.conv.conv")))
    _maybe(out, "b", leaf(r.get(f"{prefix}.conv.conv.bias")))
    return out


def _convtr_p(r: KeyResolver, prefix: str, leaf) -> dict:
    out = {}
    _maybe(out, "w", leaf(r.conv_weight(f"{prefix}.convtr.convtr")))
    _maybe(out, "b", leaf(r.get(f"{prefix}.convtr.convtr.bias")))
    return out


def _resblock_p(r: KeyResolver, prefix: str, leaf) -> dict:
    return {"b1": _conv_p(r, f"{prefix}.block.1", leaf),
            "b2": _conv_p(r, f"{prefix}.block.3", leaf)}


def _rvq_p(r: KeyResolver, prefix: str, n_q: int, leaf) -> dict:
    embeds = []
    for q in range(n_q):
        cb = f"{prefix}.vq.layers.{q}._codebook"
        es = r.get(f"{cb}.embedding_sum", f"{cb}.embed_sum")
        usage = r.get(f"{cb}.cluster_usage", f"{cb}.cluster_size")
        # embedding = embedding_sum / max(cluster_usage, eps)
        embeds.append(None if es is None or usage is None
                      else es / np.maximum(usage, 1e-5)[:, None])
    out = {}
    if all(e is not None for e in embeds):
        out["embed"] = leaf(np.stack(embeds))
    ip = r.get(f"{prefix}.input_proj.weight")
    op = r.get(f"{prefix}.output_proj.weight")
    # 1x1 conv weights are stored (out, in, 1).
    if ip is not None:
        out["input_proj"] = leaf(ip[:, :, 0] if ip.ndim == 3 else ip)
    if op is not None:
        out["output_proj"] = leaf(op[:, :, 0] if op.ndim == 3 else op)
    return out


def build_mimi_params(cfg, tensors: Mapping, dtype=torch.float32, device=None) -> dict:
    """The codec's params from a reference-layout tensor mapping; missing
    keys raise ``KeyError`` naming the first few."""
    r = KeyResolver(tensors)
    leaf = _Leaf(dtype, device)
    sn = cfg.seanet
    init_i, enc_stages, final_i = _seanet_enc_indices(sn)
    encoder = {
        "init": _conv_p(r, f"encoder.model.{init_i}", leaf),
        "layers": [{"res": [_resblock_p(r, f"encoder.model.{ri}", leaf) for ri in res],
                    "down": _conv_p(r, f"encoder.model.{di}", leaf)}
                   for res, di in enc_stages],
        "final": _conv_p(r, f"encoder.model.{final_i}", leaf),
    }
    init_i, dec_stages, final_i = _seanet_dec_indices(sn)
    decoder = {
        "init": _conv_p(r, f"decoder.model.{init_i}", leaf),
        "layers": [{"up": _convtr_p(r, f"decoder.model.{ui}", leaf),
                    "res": [_resblock_p(r, f"decoder.model.{ri}", leaf) for ri in res]}
                   for ui, res in dec_stages],
        "final": _conv_p(r, f"decoder.model.{final_i}", leaf),
    }
    params = {
        "encoder": encoder,
        "decoder": decoder,
        "encoder_transformer": transformer_layers_params(
            r, "encoder_transformer.transformer", cfg.transformer, leaf=leaf),
        "decoder_transformer": transformer_layers_params(
            r, "decoder_transformer.transformer", cfg.transformer, leaf=leaf),
        "downsample": {"w": leaf(r.conv_weight("downsample.conv.conv.conv"))},
        "upsample": {"w": leaf(r.conv_weight("upsample.convtr.convtr.convtr"))},
        "quantizer": {
            "rvq_first": _rvq_p(r, "quantizer.rvq_first", 1, leaf),
            "rvq_rest": _rvq_p(r, "quantizer.rvq_rest", cfg.n_q - 1, leaf),
        },
    }
    if r.missing:
        raise KeyError(f"mimi checkpoint missing {len(r.missing)} keys, "
                       f"e.g. {r.missing[:8]}")
    return params


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def build_lm_params(cfg, tensors: Mapping, dtype=torch.bfloat16, device=None) -> dict:
    """The LM's params from a reference-layout tensor mapping, every leaf in
    ``dtype`` on ``device``; missing keys raise ``KeyError`` naming the first
    few."""
    r = KeyResolver(tensors)
    leaf = _Leaf(dtype, device)
    d = cfg.d_model
    out_norm = _norm_params(r, "out_norm", cfg.transformer.norm, d)
    params = {
        "text_emb": leaf(r.get("text_emb.weight", shape=(cfg.text_in_vocab_size, d))),
        "audio_embs": leaf(_stack([r.get(f"emb.{k}.weight", shape=(cfg.audio_vocab_size, d))
                                   for k in range(cfg.audio_codebooks)])),
        "transformer": transformer_layers_params(r, "transformer", cfg.transformer,
                                                 leaf=leaf),
        "out_norm": {k: leaf(v) for k, v in out_norm.items()},
        "text_linear": leaf(r.get("text_linear.weight", shape=(cfg.text_out_vocab_size, d))),
    }
    if cfg.extra_heads is not None:
        n, hd = cfg.extra_heads
        params["extra_heads"] = leaf(_stack(
            [r.get(f"extra_heads.{i}.weight", shape=(hd, d)) for i in range(n)]))
    if cfg.depformer is not None:
        params["depformer"] = _depformer_params(r, cfg, leaf)
    if r.missing:
        raise KeyError(f"lm checkpoint missing {len(r.missing)} keys, "
                       f"e.g. {r.missing[:8]}")
    return params


def _depformer_params(r: KeyResolver, cfg, leaf) -> dict:
    """The DepFormer with the reference's fallback chains: per-slice weights
    where present, else root-level shared tensors (``depformer_in`` may hold
    fewer entries than slices; a transformer shared by every slice takes the
    gating weights of index ``slice * 11 // slices``)."""
    dep = cfg.depformer
    dcfg = dep.transformer
    s = dep.num_slices
    d_dep = dcfg.d_model
    shared_tf = r.has("depformer.layers.0.norm1.alpha")

    slices = []
    for i in range(s):
        if not shared_tf:
            slices.append(transformer_layers_params(
                r, f"depformer.slices.{i}.transformer", dcfg, leaf=leaf))
            continue
        layers = transformer_layers_params(r, "depformer", dcfg, leaf=leaf)
        gidx = (i * 11) // s
        gates = []
        for l in range(dcfg.num_layers):
            a = r.get(f"depformer.layers.{l}.gating.{gidx}.linear_in.weight")
            b = r.get(f"depformer.layers.{l}.gating.{gidx}.linear_out.weight")
            if a is None or b is None:
                gates = None
                break
            gates.append((a, b))
        if gates is not None:
            for layer, (a, b) in zip(layers, gates):
                layer["mlp"] = {"linear_in": leaf(a), "linear_out": leaf(b)}
        slices.append(layers)

    n_in = 11 if r.has("depformer_in.0.weight") else s
    out = {
        "transformer": slices,
        "linear_in": leaf(_stack([
            r.get(f"depformer.slices.{i}.linear_in.weight",
                  f"depformer_in.{(i * n_in) // s}.weight", shape=(d_dep, cfg.d_model))
            for i in range(s)])),
        "linear_out": leaf(_stack([
            r.get(f"depformer.slices.{i}.linear_out.weight", f"linears.{i}.weight",
                  shape=(cfg.audio_vocab_size - 1, d_dep))
            for i in range(s)])),
    }
    emb_dim = dep.low_rank_embeddings or d_dep
    out["text_emb"] = leaf(r.get("depformer.slices.0.emb.weight", "depformer_text_emb.weight",
                                 shape=(cfg.text_in_vocab_size, emb_dim)))
    out["audio_embs"] = leaf(_stack([
        r.get(f"depformer.slices.{i + 1}.emb.weight", f"depformer_emb.{i}.weight",
              shape=(cfg.audio_vocab_size, emb_dim))
        for i in range(s - 1)]))
    if dep.low_rank_embeddings is not None:
        out["low_rank"] = leaf(_stack([
            r.get(f"depformer.slices.{i}.emb.low_rank.weight",
                  "depformer_text_emb.low_rank.weight" if i == 0
                  else f"depformer_emb.{i - 1}.low_rank.weight",
                  shape=(d_dep, dep.low_rank_embeddings))
            for i in range(s)]))
    return out


# ---------------------------------------------------------------------------
# Export to the reference layout: the inverse of the loaders
# ---------------------------------------------------------------------------


def _host(t) -> torch.Tensor:
    if isinstance(t, dict):
        raise TypeError("an int8 weight ({'q', 's'}) has no reference layout; export the "
                        "dense tree")
    return t.detach().cpu()


def _layers_to_reference(out: dict, prefix: str, tcfg, layers: list) -> None:
    d = tcfg.d_model
    for l, lp in enumerate(layers):
        p = f"{prefix}.layers.{l}"
        out[f"{p}.self_attn.in_proj_weight"] = _host(lp["in_proj_w"])
        out[f"{p}.self_attn.out_proj.weight"] = _host(lp["out_proj_w"])
        for nm in ("norm1", "norm2"):
            out[f"{p}.{nm}.alpha"] = _host(lp[nm]["alpha"]).reshape(1, 1, d)
            if "bias" in lp[nm]:
                out[f"{p}.{nm}.bias"] = _host(lp[nm]["bias"])
        if "linear_in" in lp["mlp"]:
            out[f"{p}.gating.linear_in.weight"] = _host(lp["mlp"]["linear_in"])
            out[f"{p}.gating.linear_out.weight"] = _host(lp["mlp"]["linear_out"])
        else:
            out[f"{p}.linear1.weight"] = _host(lp["mlp"]["linear1"])
            out[f"{p}.linear2.weight"] = _host(lp["mlp"]["linear2"])
        if "layer_scale_1" in lp:
            out[f"{p}.layer_scale_1.scale"] = _host(lp["layer_scale_1"])
            out[f"{p}.layer_scale_2.scale"] = _host(lp["layer_scale_2"])
        if "ca_q_w" in lp:
            cp = f"{p}.cross_attention"
            out[f"{cp}.in_proj_weight_q"] = _host(lp["ca_q_w"])
            out[f"{cp}.in_proj_weight_kv"] = _host(lp["ca_kv_w"])
            out[f"{cp}.out_proj.weight"] = _host(lp["ca_out_w"])
            out[f"{p}.norm_cross.alpha"] = _host(lp["norm_cross"]["alpha"]).reshape(1, 1, d)
            if "bias" in lp["norm_cross"]:
                out[f"{p}.norm_cross.bias"] = _host(lp["norm_cross"]["bias"])


def lm_params_to_reference(cfg, params: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`build_lm_params`: the reference key layout, each
    tensor on the CPU in its own dtype (the dense tree only)."""
    out: Dict[str, torch.Tensor] = {}
    d = cfg.d_model
    out["text_emb.weight"] = _host(params["text_emb"])
    for k in range(cfg.audio_codebooks):
        out[f"emb.{k}.weight"] = _host(params["audio_embs"][k])
    out["out_norm.alpha"] = _host(params["out_norm"]["alpha"]).reshape(1, 1, d)
    if "bias" in params["out_norm"]:
        out["out_norm.bias"] = _host(params["out_norm"]["bias"])
    out["text_linear.weight"] = _host(params["text_linear"])
    if "extra_heads" in params:
        for i in range(params["extra_heads"].shape[0]):
            out[f"extra_heads.{i}.weight"] = _host(params["extra_heads"][i])
    _layers_to_reference(out, "transformer", cfg.transformer, params["transformer"])
    if cfg.depformer is not None:
        dp = params["depformer"]
        for i in range(cfg.depformer.num_slices):
            _layers_to_reference(out, f"depformer.slices.{i}.transformer",
                                 cfg.depformer.transformer, dp["transformer"][i])
            out[f"depformer.slices.{i}.linear_in.weight"] = _host(dp["linear_in"][i])
            out[f"depformer.slices.{i}.linear_out.weight"] = _host(dp["linear_out"][i])
            out[f"depformer.slices.{i}.emb.weight"] = _host(
                dp["text_emb"] if i == 0 else dp["audio_embs"][i - 1])
            if "low_rank" in dp:
                out[f"depformer.slices.{i}.emb.low_rank.weight"] = _host(dp["low_rank"][i])
    return out


def mimi_params_to_reference(cfg, params: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`build_mimi_params`: the reference key layout, each
    tensor on the CPU in its own dtype; the codebooks with a cluster usage of
    one, so that they come back bit for bit."""
    out: Dict[str, torch.Tensor] = {}

    def conv(prefix, p, kind="conv"):
        out[f"{prefix}.{kind}.{kind}.weight"] = _host(p["w"])
        if "b" in p:
            out[f"{prefix}.{kind}.{kind}.bias"] = _host(p["b"])

    def resblock(prefix, p):
        conv(f"{prefix}.block.1", p["b1"])
        conv(f"{prefix}.block.3", p["b2"])

    sn = cfg.seanet
    init_i, enc_stages, final_i = _seanet_enc_indices(sn)
    enc = params["encoder"]
    conv(f"encoder.model.{init_i}", enc["init"])
    for (res_is, down_i), stage in zip(enc_stages, enc["layers"]):
        for ri, rp in zip(res_is, stage["res"]):
            resblock(f"encoder.model.{ri}", rp)
        conv(f"encoder.model.{down_i}", stage["down"])
    conv(f"encoder.model.{final_i}", enc["final"])

    init_i, dec_stages, final_i = _seanet_dec_indices(sn)
    dec = params["decoder"]
    conv(f"decoder.model.{init_i}", dec["init"])
    for (up_i, res_is), stage in zip(dec_stages, dec["layers"]):
        conv(f"decoder.model.{up_i}", stage["up"], kind="convtr")
        for ri, rp in zip(res_is, stage["res"]):
            resblock(f"decoder.model.{ri}", rp)
    conv(f"decoder.model.{final_i}", dec["final"])

    _layers_to_reference(out, "encoder_transformer.transformer", cfg.transformer,
                         params["encoder_transformer"])
    _layers_to_reference(out, "decoder_transformer.transformer", cfg.transformer,
                         params["decoder_transformer"])
    out["downsample.conv.conv.conv.weight"] = _host(params["downsample"]["w"])
    out["upsample.convtr.convtr.convtr.weight"] = _host(params["upsample"]["w"])

    def rvq(prefix, p, n_q):
        embed = _host(p["embed"])
        for q in range(n_q):
            cb = f"{prefix}.vq.layers.{q}._codebook"
            out[f"{cb}.embedding_sum"] = embed[q]
            out[f"{cb}.cluster_usage"] = torch.ones(embed.shape[1], dtype=embed.dtype)
        out[f"{prefix}.input_proj.weight"] = _host(p["input_proj"])[:, :, None]
        out[f"{prefix}.output_proj.weight"] = _host(p["output_proj"])[:, :, None]

    rvq("quantizer.rvq_first", params["quantizer"]["rvq_first"], 1)
    rvq("quantizer.rvq_rest", params["quantizer"]["rvq_rest"], cfg.n_q - 1)
    return out

