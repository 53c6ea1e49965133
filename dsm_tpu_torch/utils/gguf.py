"""GGUF container reader and writer, host numpy (counterpart of
``dsm_tpu/utils/gguf.py``, a copy: the port imports nothing of the JAX
package).

Released q8 checkpoints of the reference use GGUF with the tensor names of
the safetensors layout.  :func:`read_gguf` parses the container so that
they load into the port's trees: quantised tensors are dequantised to f32
at load (the serving profile re-quantises weight-only int8 per output
channel afterwards, ``ops/transformer.quantize_weights``), or returned raw.

GGUF v2/v3 (little-endian); tensor types F32, F16, F64, BF16,
I8/I16/I32/I64 and Q8_0.  The writer takes F32, F16, BF16 and Q8_0.

Format: https://github.com/ggerganov/ggml/blob/master/docs/gguf.md
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

# ggml tensor types (subset)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_I8 = 16
GGML_I16 = 17
GGML_I32 = 18
GGML_I64 = 27
GGML_F64 = 28
GGML_BF16 = 30

_Q8_0_BLOCK = 32  # elements per q8_0 block (2-byte f16 scale + 32 int8)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            raise ValueError("truncated GGUF file")
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def string(self) -> str:
        n = self.u64()
        return self.take(n).decode("utf-8")

    def value(self, vtype: int):
        if vtype == _T_U8:
            return self.take(1)[0]
        if vtype == _T_I8:
            return struct.unpack("<b", self.take(1))[0]
        if vtype == _T_U16:
            return struct.unpack("<H", self.take(2))[0]
        if vtype == _T_I16:
            return struct.unpack("<h", self.take(2))[0]
        if vtype == _T_U32:
            return self.u32()
        if vtype == _T_I32:
            return struct.unpack("<i", self.take(4))[0]
        if vtype == _T_F32:
            return struct.unpack("<f", self.take(4))[0]
        if vtype == _T_BOOL:
            return bool(self.take(1)[0])
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            et = self.u32()
            n = self.u64()
            return [self.value(et) for _ in range(n)]
        if vtype == _T_U64:
            return self.u64()
        if vtype == _T_I64:
            return struct.unpack("<q", self.take(8))[0]
        if vtype == _T_F64:
            return struct.unpack("<d", self.take(8))[0]
        raise ValueError(f"unknown GGUF metadata type {vtype}")


def _dequant_q8_0(raw: bytes, n_elems: int) -> np.ndarray:
    blocks = n_elems // _Q8_0_BLOCK
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(blocks, 2 + _Q8_0_BLOCK)
    scales = rec[:, :2].copy().view(np.float16).astype(np.float32)  # (blocks, 1)
    qs = rec[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * scales).reshape(-1)


def _q8_0_raw(raw: bytes, n_elems: int) -> Tuple[np.ndarray, np.ndarray]:
    blocks = n_elems // _Q8_0_BLOCK
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(blocks, 2 + _Q8_0_BLOCK)
    scales = rec[:, :2].copy().view(np.float16).reshape(blocks)
    qs = rec[:, 2:].copy().view(np.int8).reshape(blocks, _Q8_0_BLOCK)
    return qs, scales


_PLAIN = {
    GGML_F32: (np.dtype("<f4"), 4),
    GGML_F16: (np.dtype("<f2"), 2),
    GGML_F64: (np.dtype("<f8"), 8),
    GGML_I8: (np.dtype("<i1"), 1),
    GGML_I16: (np.dtype("<i2"), 2),
    GGML_I32: (np.dtype("<i4"), 4),
    GGML_I64: (np.dtype("<i8"), 8),
}


def _tensor_nbytes(ggml_type: int, n_elems: int) -> int:
    if ggml_type in _PLAIN:
        return n_elems * _PLAIN[ggml_type][1]
    if ggml_type == GGML_BF16:
        return n_elems * 2
    if ggml_type == GGML_Q8_0:
        if n_elems % _Q8_0_BLOCK:
            raise ValueError("q8_0 tensor size not a multiple of 32")
        return (n_elems // _Q8_0_BLOCK) * (2 + _Q8_0_BLOCK)
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


def read_gguf(
    path: str, *, raw_quant: bool = False
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Parse a GGUF file -> (metadata, tensors).

    Tensors are numpy arrays in logical (row-major) shape — GGUF stores dims
    innermost-first, reversed here like candle does.  Quantized (q8_0)
    tensors dequantise to f32; with ``raw_quant=True`` they are returned as
    ``{"q": int8 (..., 32-blocked flat), "s": f16 block scales, "shape": ...}``.
    """
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.take(4) != GGUF_MAGIC:
        raise ValueError("not a GGUF file")
    version = r.u32()
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.u64()
    n_kv = r.u64()
    meta: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.u32()
        meta[key] = r.value(vtype)
    infos = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.u32()
        dims = [r.u64() for _ in range(n_dims)]
        ggml_type = r.u32()
        offset = r.u64()
        infos.append((name, dims, ggml_type, offset))
    alignment = int(meta.get("general.alignment", 32))
    base = (r.off + alignment - 1) // alignment * alignment

    tensors: Dict[str, Any] = {}
    for name, dims, ggml_type, offset in infos:
        shape = tuple(reversed(dims))  # ne[0] is innermost
        n_elems = 1
        for d in shape:
            n_elems *= int(d)
        nbytes = _tensor_nbytes(ggml_type, n_elems)
        blob = data[base + offset : base + offset + nbytes]
        if len(blob) != nbytes:
            raise ValueError(f"truncated tensor data for {name}")
        if ggml_type in _PLAIN:
            arr = np.frombuffer(blob, dtype=_PLAIN[ggml_type][0]).reshape(shape)
            tensors[name] = arr.astype(np.float32) if ggml_type == GGML_F16 else arr.copy()
        elif ggml_type == GGML_BF16:
            u = np.frombuffer(blob, dtype="<u2").astype(np.uint32) << 16
            tensors[name] = u.view(np.float32).reshape(shape).copy()
        elif ggml_type == GGML_Q8_0:
            if raw_quant:
                q, s = _q8_0_raw(blob, n_elems)
                tensors[name] = {"q": q, "s": s, "shape": shape}
            else:
                tensors[name] = _dequant_q8_0(blob, n_elems).reshape(shape)
        else:
            raise ValueError(f"unsupported ggml tensor type {ggml_type} for {name}")
    return meta, tensors


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _quantize_q8_0(arr: np.ndarray) -> bytes:
    flat = arr.astype(np.float32).reshape(-1)
    if flat.size % _Q8_0_BLOCK:
        raise ValueError("q8_0 needs a multiple of 32 elements")
    blocks = flat.reshape(-1, _Q8_0_BLOCK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = (amax / 127.0).astype(np.float16)
    s = scales.astype(np.float32)
    s[s == 0] = 1.0
    qs = np.clip(np.round(blocks / s[:, None]), -127, 127).astype(np.int8)
    out = np.empty((blocks.shape[0], 2 + _Q8_0_BLOCK), np.uint8)
    out[:, :2] = scales.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = qs.view(np.uint8)
    return out.tobytes()


def _write_string(parts, s: str):
    b = s.encode("utf-8")
    parts.append(struct.pack("<Q", len(b)))
    parts.append(b)


def _write_value(parts, v):
    if isinstance(v, bool):
        parts.append(struct.pack("<I", _T_BOOL))
        parts.append(struct.pack("<?", v))
    elif isinstance(v, int):
        parts.append(struct.pack("<I", _T_U64 if v >= 0 else _T_I64))
        parts.append(struct.pack("<Q" if v >= 0 else "<q", v))
    elif isinstance(v, float):
        parts.append(struct.pack("<I", _T_F32))
        parts.append(struct.pack("<f", v))
    elif isinstance(v, str):
        parts.append(struct.pack("<I", _T_STRING))
        _write_string(parts, v)
    else:
        raise ValueError(f"unsupported metadata value {v!r}")


def write_gguf(
    path: str,
    tensors: Dict[str, np.ndarray],
    metadata: Optional[Dict[str, Any]] = None,
    *,
    quantize: bool = False,
    alignment: int = 32,
) -> None:
    """Write a GGUF v3 file.  ``quantize`` stores eligible ≥2-D float
    tensors as q8_0 (innermost dim a multiple of 32); everything else is
    f32/f16/bf16 passthrough by dtype."""
    metadata = dict(metadata or {})
    metadata.setdefault("general.alignment", alignment)

    infos = []
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if (
            quantize
            and arr.ndim >= 2
            and arr.dtype.kind == "f"
            and arr.shape[-1] % _Q8_0_BLOCK == 0
        ):
            blob = _quantize_q8_0(arr)
            ggml_type = GGML_Q8_0
        elif arr.dtype == np.float16:
            blob = arr.astype("<f2").tobytes()
            ggml_type = GGML_F16
        elif str(arr.dtype) == "bfloat16":
            u = arr.view(np.uint16) if arr.dtype.itemsize == 2 else None
            blob = np.asarray(u, dtype="<u2").tobytes()
            ggml_type = GGML_BF16
        elif arr.dtype.kind == "i":
            arr32 = arr.astype("<i4")
            blob = arr32.tobytes()
            ggml_type = GGML_I32
        else:
            blob = arr.astype("<f4").tobytes()
            ggml_type = GGML_F32
        infos.append((name, list(reversed(arr.shape)), ggml_type, offset))
        blobs.append(blob)
        offset += len(blob)
        pad = (-len(blob)) % alignment
        if pad:
            blobs.append(b"\0" * pad)
            offset += pad

    parts = [GGUF_MAGIC, struct.pack("<I", 3)]
    parts.append(struct.pack("<Q", len(infos)))
    parts.append(struct.pack("<Q", len(metadata)))
    for k, v in metadata.items():
        _write_string(parts, k)
        _write_value(parts, v)
    for name, dims, ggml_type, off in infos:
        _write_string(parts, name)
        parts.append(struct.pack("<I", len(dims)))
        for d in dims:
            parts.append(struct.pack("<Q", d))
        parts.append(struct.pack("<I", ggml_type))
        parts.append(struct.pack("<Q", off))
    header = b"".join(parts)
    pad = (-len(header)) % alignment
    with open(path, "wb") as f:
        f.write(header)
        f.write(b"\0" * pad)
        for blob in blobs:
            f.write(blob)
