"""In-place KV ring commits (counterpart of ``dsm_tpu/ops/ring_kernels.py``).

Eight wrappers over six kernels, CUDA C++ in ``csrc/ring_attn.cu``:

``ring_commit`` replaces ``dsm_tpu/ops/ring_kernels.py:_ring_commit``: it
writes T new K/V rows ``(B, H, T, Dh)`` into the bf16 or f32 rings
``(B, H, C, Dh)`` at row ``w``.  On the serving path it appends the Mimi
codec transformer's 2 rows per step, ``(64, 8, 2, 64)`` into
``(64, 8, 256, 64)`` bf16 at B=64: 2 x 131 KB copied.
``scale_commit`` replaces ``_scale_commit``: it writes T fresh per-row KV
scales ``(B, H, T)`` f32 into the scale rings ``(B, H, C)``; at stt-1b B=64
that is 2 x 4 KB, once per LM layer.
``ring_commit_q`` replaces ``_ring_commit_q``, the commit of the split ring
pipeline: the fresh int8 K and V rows ``(B, H, T, Dh)`` and their f32 scales
``(B, H, T)`` go into the two int8 rings and the two scale rings in one
launch; at s2s-2b B=24 that is 2 x 61 KB of rows and 2 x 1.9 KB of scales,
once per LM layer.  The packed-int4 rings (uint8, rows of ``Dh/2`` bytes)
take the same launch: the kernel copies bytes and is given the row width
in bytes.  :func:`ring_commit` with the scale rings goes there.

``rope_commit`` serves TPU kernel 3 on the step's path, with the rotary
embedding folded in (``dsm_rope_commit``): it takes the step's q, k and v
``(B, H, T, Dh)`` where they lie (strided views of the QKV product), rotates
q and k as ``attention.apply_rope`` does, writes the rotated k and the
unchanged v into the bf16 or f32 rings at row ``w`` and returns the rotated
q and k, in one launch where the eager step took 20 (two rope chains of 9
operations, V made contiguous, the copy).  ``rope_qk`` is the same kernel
without rings: the rope before the int8 and packed-int4 commits below, one
launch for 18.  ``ring_commit`` stays the literal counterpart of
``_ring_commit`` on rows rotated already.

``quantize_commit`` and ``quantize_scale_commit`` serve TPU kernels 4 and 1
on the step's path, one kernel (``dsm_quantize_commit``) with the fresh rows'
quantisation folded in: they take the fresh bf16 K and V rows ``(B, H, 1,
Dh)`` where they lie (V is a strided view of the QKV product), quantise each
row as ``attention.quantize_kv_rows`` (or ``quantize_kv_rows_packed4`` for a
uint8 ring) and write the int8 or packed rows into the rings
(``quantize_commit``, the split pipeline) or return them (``quantize_scale_commit``,
the fused pipeline, whose attention commits the rows itself), the scales into
the scale rings, in one launch where the eager chain before the copy took
some 19 (27 at int4).  ``ring_commit_q`` and ``scale_commit`` stay the literal
counterparts of ``_ring_commit_q`` and ``_scale_commit`` on rows quantised
already.

What bounds them on the H100: a few hundred KB moved at most, so each is
bound by its launch and the latency of one round of stores, not by
bandwidth.  The design does nothing clever about it: one thread per
element copied, offsets computed from ``w`` and the shape, K and V in one
launch (``blockIdx.y``), no synchronisation.  The TPU kernel streamed the
aligned row block through VMEM to avoid partial-tile DMAs; a GPU store of
one element needs no such block, so none of the TPU kernels' tiling
conditions (batch blocks, row blocks, 128-slot scale blocks) is kept: any
B, H, C and T that meet the contract below are served.

The position: every wrapper takes the step's shared tick ``pos``, a 0-d
int32 tensor on the rings' device (``attention.global_ring_plan``'s
``"pos"``), never a host int, and each kernel reads it from device memory
and writes rows ``w = pos % C`` on: the counterpart of the Pallas kernels'
scalar-prefetched ``w``.  So nothing is read back to the host and a step of
launches can be captured in a CUDA graph and replayed at every tick.
Contract, as in the JAX package: ``C % T == 0`` and ``pos % T == 0`` (so a
fixed-cadence append never wraps).  The first is checked on every device;
the second where the position lies on the CPU (reading it there is no
sync), and by construction on the card (the step advances ``pos`` by T from
0).  The rings are updated in place, where the JAX package aliases its
outputs to its inputs.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, counting the launch in its ``launches`` attribute.

Training (``train.depformer_loss``) differentiates through the DepFormer's
f32 rings.  ``ring_commit`` is an ``autograd.Function`` there (only where
grad mode is on and a ring or a row requires a gradient; the serving paths
never are): the rings are written in place and marked dirty, and its
backward is ``ring_commit_backward`` (``dsm_ring_commit_backward``): the
rings' gradient copied with rows ``w .. w+T-1`` zeroed, those rows copied
out as the new rows' gradient, one launch for K and V.  No Pallas kernel
stands for it: it is the transpose of ``_ring_commit`` that JAX's autodiff
derives (``dsm_tpu/ops/transformer.py:552``).  Every other wrapper here has
no backward and raises under autograd (``attention.no_backward``).
"""

from __future__ import annotations


import torch

from . import _build
from . import attention as attn


def _check_rows(pos, t: int, c: int) -> None:
    """The commit contract for ``t`` rows into a ring of ``c`` at position
    ``pos`` (an int, or a tensor read only where it lies on the CPU)."""
    if t < 1 or c % t:
        raise ValueError(f"ring commit needs C % T == 0, got T={t} C={c}")
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "cpu":
            return
        pos = int(pos)  # no sync: the tensor is on the CPU
    if pos < 0 or pos % t:
        raise ValueError(f"ring commit needs pos % T == 0 and pos >= 0, got pos={pos} T={t}")


def _check_pos(name: str, pos, t: int, c: int, device: torch.device) -> None:
    """A wrapper's position (``attention.check_tick``) under the commit
    contract (:func:`_check_rows`)."""
    attn.check_tick(name, pos, device)
    _check_rows(pos, t, c)


def _check_cuda(name: str, tensors: dict) -> None:
    for label, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {label} is on {x.device}, not CUDA")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


# ---------------------------------------------------------------------------
# ring_commit
# ---------------------------------------------------------------------------


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


class _RingCommit(torch.autograd.Function):
    """The bf16/f32 ring commit under autograd: the rings are written in
    place (``mark_dirty``), and the backward splits each ring's gradient in
    two: rows ``w .. w+T-1`` are the new rows' gradient, and the same rows
    are zero in the gradient of the ring before the commit (they were
    overwritten).  ``plain``: the plain commit and :func:`ring_commit_backward_plain`
    (any device), else the two kernels."""

    @staticmethod
    def forward(ctx, k_cache, v_cache, k_new, v_new, pos, plain):
        if plain:
            attn.ring_write_global(k_cache, v_cache, k_new, v_new, pos)
        else:
            _ring_commit_launch(k_cache, v_cache, k_new, v_new, pos)
        ctx.mark_dirty(k_cache, v_cache)
        ctx.pos, ctx.t, ctx.plain = pos, k_new.shape[2], plain
        return k_cache, v_cache

    @staticmethod
    def backward(ctx, grad_k, grad_v):
        fn = ring_commit_backward_plain if ctx.plain else ring_commit_backward
        gk_old, gv_old, gk_new, gv_new = fn(grad_k, grad_v, ctx.pos, ctx.t)
        return gk_old, gv_old, gk_new, gv_new, None, None


def ring_commit_plain(k_cache, v_cache, k_new, v_new, pos, ks_cache=None,
                      vs_cache=None, ks_new=None, vs_new=None) -> None:
    """Plain PyTorch version of :func:`ring_commit` (any device), with or
    without the scale rings; ``pos`` a 0-d tensor or an int.  Under
    autograd (grad mode on and a tensor that requires a gradient) the bf16/f32
    commit goes through the autograd Function with the plain backward."""
    if ks_cache is not None:
        ring_commit_q_plain(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new,
                            ks_new, vs_new, pos)
        return
    _check_rows(pos, k_new.shape[2], k_cache.shape[2])
    if _needs_grad(k_cache, v_cache, k_new, v_new):
        _RingCommit.apply(k_cache, v_cache, k_new.to(k_cache.dtype),
                          v_new.to(v_cache.dtype), pos, True)
        return
    attn.ring_write_global(k_cache, v_cache, k_new, v_new, pos)


def _ring_commit_launch(k_cache, v_cache, k_new, v_new, pos) -> None:
    b, h, t, dh = k_new.shape
    c = k_cache.shape[2]
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(k_cache.dtype).contiguous()
    _check_cuda("ring_commit", {"k_cache": k_cache, "v_cache": v_cache,
                                "k_new": k_new, "v_new": v_new})
    err = _build.launch(_build.lib().dsm_ring_commit, k_cache.device,
        k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), k_cache.element_size(), b, h, t, c, dh, pos.data_ptr(),
    )
    _build.check(err, "ring_commit")
    ring_commit.launches += 1


def ring_commit(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor,
                ks_cache=None, vs_cache=None, ks_new=None, vs_new=None) -> None:
    """Write ``k_new/v_new (B, H, T, Dh)`` into the rings ``(B, H, C, Dh)``
    at rows ``pos % C`` on, in place.  With the scale rings ``ks_cache/vs_cache (B, H,
    C)`` and the fresh scales ``ks_new/vs_new (B, H, T)`` all four rings are
    written by one launch of :func:`ring_commit_q`.

    Under autograd (grad mode on and a ring or a row that requires a
    gradient: the DepFormer's rings in ``train.depformer_loss``) the bf16/f32
    commit is differentiable: the same launch, and :func:`ring_commit_backward`
    in the backward pass.  Otherwise nothing of autograd is touched."""
    if ks_cache is not None:
        ring_commit_q(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new,
                      ks_new, vs_new, pos)
        return
    b, h, t, dh = k_new.shape
    c = k_cache.shape[2]
    _check_pos("ring_commit", pos, t, c, k_cache.device)
    if k_cache.device.type == "cpu":
        ring_commit_plain(k_cache, v_cache, k_new, v_new, pos)
        return
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ring_commit takes bf16 or f32 rings, got {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("ring_commit: K and V rings differ in dtype or shape")
    if k_cache.shape != (b, h, c, dh) or v_new.shape != k_new.shape:
        raise ValueError(
            f"ring_commit: rows {tuple(k_new.shape)} do not fit ring "
            f"{tuple(k_cache.shape)}"
        )
    if _needs_grad(k_cache, v_cache, k_new, v_new):
        _RingCommit.apply(k_cache, v_cache, k_new.to(k_cache.dtype),
                          v_new.to(v_cache.dtype), pos, False)
        return
    _ring_commit_launch(k_cache, v_cache, k_new, v_new, pos)


ring_commit.launches = 0


def ring_commit_backward_plain(grad_k, grad_v, pos, t: int):
    """Plain PyTorch version of :func:`ring_commit_backward` (any device;
    ``pos`` a 0-d tensor or an int)."""
    rows = attn.ring_rows(pos, grad_k.shape[2], t, grad_k.device)
    return (grad_k.index_fill(2, rows, 0), grad_v.index_fill(2, rows, 0),
            grad_k.index_select(2, rows), grad_v.index_select(2, rows))


def ring_commit_backward(grad_k: torch.Tensor, grad_v: torch.Tensor, pos: torch.Tensor,
                         t: int):
    """The transpose of :func:`ring_commit`: the gradients ``(B, H, C, Dh)``
    of the K and V rings after a commit of ``t`` rows at ``w = pos % C`` ->
    ``(gk_old, gv_old, gk_new, gv_new)``: the rings' gradients before the
    commit (rows ``w .. w+t-1`` zero) and the new rows' ``(B, H, t, Dh)``
    (those rows), in one launch of ``dsm_ring_commit_backward``; the
    incoming gradients are read, not written.  CPU tensors take the plain
    version."""
    b, h, c, dh = grad_k.shape
    _check_rows(pos, t, c)
    if grad_k.device.type == "cpu":
        return ring_commit_backward_plain(grad_k, grad_v, pos, t)
    attn.check_tick("ring_commit_backward", pos, grad_k.device)
    if grad_k.dtype not in (torch.bfloat16, torch.float32) or grad_v.dtype != grad_k.dtype:
        raise ValueError(f"ring_commit_backward takes bf16 or f32 gradients, got "
                         f"{grad_k.dtype} / {grad_v.dtype}")
    if grad_v.shape != grad_k.shape:
        raise ValueError("ring_commit_backward: K and V gradients differ in shape")
    grad_k, grad_v = grad_k.contiguous(), grad_v.contiguous()
    outs = (torch.empty_like(grad_k), torch.empty_like(grad_v),
            grad_k.new_empty((b, h, t, dh)), grad_v.new_empty((b, h, t, dh)))
    _check_cuda("ring_commit_backward", {"grad_k": grad_k, "grad_v": grad_v})
    err = _build.launch(_build.lib().dsm_ring_commit_backward, grad_k.device,
        grad_k.data_ptr(), grad_v.data_ptr(), *(x.data_ptr() for x in outs),
        grad_k.element_size(), b, h, t, c, dh, pos.data_ptr(),
    )
    _build.check(err, "ring_commit_backward")
    ring_commit_backward.launches += 1
    return outs


ring_commit_backward.launches = 0


# ---------------------------------------------------------------------------
# ring_commit_q
# ---------------------------------------------------------------------------


def ring_commit_q_plain(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new,
                        ks_new, vs_new, pos) -> None:
    """Plain PyTorch version of :func:`ring_commit_q` (any device): four
    index copies at rows ``pos % C`` on (``pos`` a 0-d tensor or an int)."""
    t = k_new.shape[2]
    _check_rows(pos, t, k_cache.shape[2])
    rows = attn.ring_rows(pos, k_cache.shape[2], t, k_cache.device)
    k_cache.index_copy_(2, rows, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, rows, v_new.to(v_cache.dtype))
    ks_cache.index_copy_(2, rows, ks_new.to(ks_cache.dtype))
    vs_cache.index_copy_(2, rows, vs_new.to(vs_cache.dtype))


def ring_commit_q(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new, ks_new,
                  vs_new, pos: torch.Tensor) -> None:
    """Write the quantised rows ``k_new/v_new (B, H, T, Dh)`` int8 into the
    int8 rings ``(B, H, C, Dh)`` and their scales ``ks_new/vs_new (B, H,
    T)`` into the f32 scale rings ``(B, H, C)``, all at rows ``pos % C`` on,
    in place,
    in one launch.  Packed-int4 rows and rings are uint8 with ``Dh/2`` bytes
    a row in place of ``Dh``."""
    attn.no_backward("ring_commit_q", k_new, v_new, ks_new, vs_new)
    b, h, t, row_bytes = k_new.shape
    c = k_cache.shape[2]
    _check_pos("ring_commit_q", pos, t, c, k_cache.device)
    if k_cache.device.type == "cpu":
        ring_commit_q_plain(k_cache, v_cache, ks_cache, vs_cache, k_new, v_new,
                            ks_new, vs_new, pos)
        return
    if k_cache.dtype not in (torch.int8, torch.uint8) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"ring_commit_q takes int8 or packed uint8 rings, got "
                         f"{k_cache.dtype} / {v_cache.dtype}")
    if k_new.dtype != k_cache.dtype or v_new.dtype != k_cache.dtype:
        raise ValueError(f"ring_commit_q: rows are {k_new.dtype} / {v_new.dtype}, "
                         f"rings {k_cache.dtype}")
    if ks_cache.dtype != torch.float32 or vs_cache.dtype != torch.float32:
        raise ValueError("ring_commit_q takes f32 scale rings")
    if (k_cache.shape != (b, h, c, row_bytes) or v_cache.shape != k_cache.shape
            or v_new.shape != k_new.shape or ks_cache.shape != (b, h, c)
            or vs_cache.shape != ks_cache.shape or ks_new.shape != (b, h, t)
            or vs_new.shape != ks_new.shape):
        raise ValueError(
            f"ring_commit_q: rows {tuple(k_new.shape)} / scales "
            f"{tuple(ks_new.shape)} do not fit rings {tuple(k_cache.shape)} / "
            f"{tuple(ks_cache.shape)}"
        )
    if row_bytes % 4:
        raise ValueError(f"ring_commit_q kernel takes rows of a multiple of 4 bytes, "
                         f"got {row_bytes}")
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    ks_new = ks_new.float().contiguous()
    vs_new = vs_new.float().contiguous()
    tensors = {"k_cache": k_cache, "v_cache": v_cache, "ks_cache": ks_cache,
               "vs_cache": vs_cache, "k_new": k_new, "v_new": v_new,
               "ks_new": ks_new, "vs_new": vs_new}
    _check_cuda("ring_commit_q", tensors)
    for label, x in tensors.items():
        if x.data_ptr() % 4:
            raise ValueError(f"ring_commit_q: {label} is not 4-byte aligned")
    err = _build.launch(_build.lib().dsm_ring_commit_q, k_cache.device,
        k_cache.data_ptr(), v_cache.data_ptr(), ks_cache.data_ptr(),
        vs_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        ks_new.data_ptr(), vs_new.data_ptr(), b, h, t, c, row_bytes, pos.data_ptr(),
    )
    _build.check(err, "ring_commit_q")
    ring_commit_q.launches += 1


ring_commit_q.launches = 0


# ---------------------------------------------------------------------------
# scale_commit
# ---------------------------------------------------------------------------


def scale_commit_plain(ks_cache, vs_cache, ks_new, vs_new, pos) -> None:
    """Plain PyTorch version of :func:`scale_commit` (any device; ``pos`` a
    0-d tensor or an int)."""
    t = ks_new.shape[2]
    _check_rows(pos, t, ks_cache.shape[2])
    rows = attn.ring_rows(pos, ks_cache.shape[2], t, ks_cache.device)
    ks_cache.index_copy_(2, rows, ks_new.to(ks_cache.dtype))
    vs_cache.index_copy_(2, rows, vs_new.to(vs_cache.dtype))


def scale_commit(ks_cache: torch.Tensor, vs_cache: torch.Tensor,
                 ks_new: torch.Tensor, vs_new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write the fresh per-row scales ``(B, H, T)`` into the f32 scale
    rings ``(B, H, C)`` at rows ``pos % C`` on, in place."""
    attn.no_backward("scale_commit", ks_cache, vs_cache, ks_new, vs_new)
    b, h, t = ks_new.shape
    c = ks_cache.shape[2]
    _check_pos("scale_commit", pos, t, c, ks_cache.device)
    if ks_cache.device.type == "cpu":
        scale_commit_plain(ks_cache, vs_cache, ks_new, vs_new, pos)
        return
    if ks_cache.dtype != torch.float32 or vs_cache.dtype != torch.float32:
        raise ValueError("scale_commit takes f32 scale rings")
    if (ks_cache.shape != (b, h, c) or vs_cache.shape != ks_cache.shape
            or vs_new.shape != ks_new.shape):
        raise ValueError(
            f"scale_commit: rows {tuple(ks_new.shape)} do not fit ring "
            f"{tuple(ks_cache.shape)}"
        )
    ks_new = ks_new.float().contiguous()
    vs_new = vs_new.float().contiguous()
    _check_cuda("scale_commit", {"ks_cache": ks_cache, "vs_cache": vs_cache,
                                 "ks_new": ks_new, "vs_new": vs_new})
    err = _build.launch(_build.lib().dsm_scale_commit, ks_cache.device,
        ks_cache.data_ptr(), vs_cache.data_ptr(), ks_new.data_ptr(),
        vs_new.data_ptr(), b, h, t, c, pos.data_ptr(),
    )
    _build.check(err, "scale_commit")
    scale_commit.launches += 1


scale_commit.launches = 0


# ---------------------------------------------------------------------------
# quantize_commit and quantize_scale_commit: the fresh rows quantised in the
# commit
# ---------------------------------------------------------------------------


def quantize_commit_plain(k, v, k_cache, v_cache, ks_cache, vs_cache, pos) -> None:
    """Plain PyTorch version of :func:`quantize_commit` (any device):
    ``quantize_kv_rows`` (``quantize_kv_rows_packed4`` for uint8 rings), then
    :func:`ring_commit_q_plain`."""
    if k_cache.dtype == torch.uint8:
        kq, vq, ks, vs = attn.quantize_kv_rows_packed4(k, v)
    else:
        kq, vq, ks, vs = attn.quantize_kv_rows(k, v)
    ring_commit_q_plain(k_cache, v_cache, ks_cache, vs_cache, kq, vq, ks, vs, pos)


def quantize_scale_commit_plain(k, v, ks_cache, vs_cache, pos):
    """Plain PyTorch version of :func:`quantize_scale_commit` (any device):
    ``quantize_kv_rows``, then :func:`scale_commit_plain`; returns ``kq, vq``."""
    kq, vq, ks, vs = attn.quantize_kv_rows(k, v)
    scale_commit_plain(ks_cache, vs_cache, ks, vs, pos)
    return kq, vq


def _quantize_launch(name, k, v, kq_ptr, vq_ptr, q_pane, q_row, ks_cache, vs_cache, pos,
                     packed4):
    """Check the fresh rows and the scale rings for ``dsm_quantize_commit`` and
    launch it: the rows ``(B, H, 1, Dh)`` bf16 on the card (the step's
    dtype there), the last dim contiguous and each row on 16 bytes (through
    any (b, h) strides), Dh a multiple of 8 (16 packed) up to 256; f32 scale
    rings ``(B, H, C)``.  Pane (b, h)'s row goes to ``kq_ptr + (b*H + h) *
    q_pane + w * q_row`` bytes, ``w = pos % C`` read by the kernel."""
    b, h, t, dh = k.shape
    c = ks_cache.shape[2]
    if t != 1 or v.shape != k.shape:
        raise ValueError(f"{name} takes fresh rows (B, H, 1, Dh), got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if k.dtype != torch.bfloat16 or v.dtype != k.dtype:
        raise ValueError(f"{name} kernel takes bf16 rows, got {k.dtype} / {v.dtype}")
    if dh % (16 if packed4 else 8) or not 8 <= dh <= 256:
        raise ValueError(f"{name} kernel takes Dh a multiple of {16 if packed4 else 8} "
                         f"up to 256, got {dh}")
    if ks_cache.dtype != torch.float32 or vs_cache.dtype != torch.float32:
        raise ValueError(f"{name} takes f32 scale rings")
    if ks_cache.shape != (b, h, c) or vs_cache.shape != ks_cache.shape:
        raise ValueError(f"{name}: rows {tuple(k.shape)} do not fit scale rings "
                         f"{tuple(ks_cache.shape)}")
    _check_cuda(name, {"ks_cache": ks_cache, "vs_cache": vs_cache})
    for label, x in (("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name}: {label} is on {x.device}, not CUDA")
        if x.stride(3) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: the rows of {label} are not contiguous on 16 bytes "
                             f"(strides {x.stride()})")
    err = _build.launch(_build.lib().dsm_quantize_commit, k.device,
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        kq_ptr, vq_ptr, q_pane, q_row, ks_cache.data_ptr(), vs_cache.data_ptr(),
        b, h, c, dh, int(packed4), pos.data_ptr(),
    )
    _build.check(err, name)


def quantize_commit(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, ks_cache: torch.Tensor, vs_cache: torch.Tensor,
                    pos: torch.Tensor) -> None:
    """Quantise the fresh rows ``k, v (B, H, 1, Dh)`` per row and write them
    into the int8 rings ``(B, H, C, Dh)`` (nibble-packed into the uint8
    rings ``(B, H, C, Dh/2)``) and their scales into the f32 scale rings
    ``(B, H, C)``, all at row ``pos % C``, in place, in one launch: the split
    pipeline's ``quantize_kv_rows(_packed4)`` + :func:`ring_commit_q`."""
    attn.no_backward("quantize_commit", k, v)
    b, h, t, dh = k.shape
    c = k_cache.shape[2]
    _check_pos("quantize_commit", pos, t, c, k_cache.device)
    if k_cache.device.type == "cpu":
        quantize_commit_plain(k, v, k_cache, v_cache, ks_cache, vs_cache, pos)
        return
    if k_cache.dtype not in (torch.int8, torch.uint8) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"quantize_commit takes int8 or packed uint8 rings, got "
                         f"{k_cache.dtype} / {v_cache.dtype}")
    packed4 = k_cache.dtype == torch.uint8
    row_bytes = dh // 2 if packed4 else dh
    if k_cache.shape != (b, h, c, row_bytes) or v_cache.shape != k_cache.shape:
        raise ValueError(f"quantize_commit: rows {tuple(k.shape)} do not fit ring "
                         f"{tuple(k_cache.shape)}")
    _check_cuda("quantize_commit", {"k_cache": k_cache, "v_cache": v_cache})
    _quantize_launch("quantize_commit", k, v, k_cache.data_ptr(), v_cache.data_ptr(),
                     c * row_bytes, row_bytes, ks_cache, vs_cache, pos, packed4)
    quantize_commit.launches += 1


quantize_commit.launches = 0


def quantize_scale_commit(k: torch.Tensor, v: torch.Tensor, ks_cache: torch.Tensor,
                          vs_cache: torch.Tensor, pos: torch.Tensor):
    """Quantise the fresh rows ``k, v (B, H, 1, Dh)`` per row to int8, write
    their scales into the f32 scale rings ``(B, H, C)`` at row ``pos % C``,
    in place, and return ``kq, vq (B, H, 1, Dh)`` int8, contiguous, in one
    launch: the fused pipeline's ``quantize_kv_rows`` + :func:`scale_commit`
    (``decode_attend_commit`` commits the int8 rows)."""
    attn.no_backward("quantize_scale_commit", k, v)
    b, h, t, dh = k.shape
    _check_pos("quantize_scale_commit", pos, t, ks_cache.shape[2], ks_cache.device)
    if ks_cache.device.type == "cpu":
        return quantize_scale_commit_plain(k, v, ks_cache, vs_cache, pos)
    kq = torch.empty((b, h, t, dh), dtype=torch.int8, device=k.device)
    vq = torch.empty_like(kq)
    _quantize_launch("quantize_scale_commit", k, v, kq.data_ptr(), vq.data_ptr(), dh, 0,
                     ks_cache, vs_cache, pos, False)
    quantize_scale_commit.launches += 1
    return kq, vq


quantize_scale_commit.launches = 0


# ---------------------------------------------------------------------------
# rope_commit and rope_qk: the rotary embedding folded into the bf16 commit
# ---------------------------------------------------------------------------


def rope_qk_plain(q, k, cos, sin):
    """Plain PyTorch version of :func:`rope_qk` (any device):
    ``attention.apply_rope`` on q and on k."""
    return attn.apply_rope(q, cos, sin), attn.apply_rope(k, cos, sin)


def rope_commit_plain(q, k, v, k_cache, v_cache, cos, sin, pos):
    """Plain PyTorch version of :func:`rope_commit` (any device):
    :func:`rope_qk_plain`, then :func:`ring_commit_plain` of the rotated k
    and of v; returns the rotated ``q, k``."""
    q, k = rope_qk_plain(q, k, cos, sin)
    ring_commit_plain(k_cache, v_cache, k, v, pos)
    return q, k


def _all_on_cpu(name: str, tensors: dict) -> bool:
    """True where every tensor lies on the CPU (the plain version), False
    where every one lies on the first one's CUDA device (the kernel); raises
    for any other mix."""
    if all(x.device.type == "cpu" for x in tensors.values()):
        return True
    dev = next(iter(tensors.values())).device
    for label, x in tensors.items():
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name}: {label} is on {x.device}, not the CUDA device {dev}")
    return False


def _rope_launch(name, q, k, v, k_cache, v_cache, cos, sin, pos):
    """Check the rows, cos/sin and the rings for ``dsm_rope_commit`` and
    launch it -> the rotated ``q, k (B, H, T, Dh)``, contiguous.  The rows are
    bf16 or f32 with contiguous pairs (the last dim of stride 1, any (b, h,
    t) strides: views of the QKV product), Dh even; cos and sin ``(B or 1, T,
    Dh/2)`` f32; the rings, if given, bf16 or f32 ``(B, H, C, Dh)``."""
    b, h, t, dh = q.shape
    rows = {"q": q, "k": k} if v is None else {"q": q, "k": k, "v": v}
    for label, x in rows.items():
        if x.shape != q.shape:
            raise ValueError(f"{name}: {label} is {tuple(x.shape)}, q {tuple(q.shape)}")
        if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != q.dtype:
            raise ValueError(f"{name} takes bf16 or f32 rows of one dtype, got {x.dtype} "
                             f"for {label}, {q.dtype} for q")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the last dim of {label} is not contiguous "
                             f"(strides {x.stride()})")
    if dh % 2:
        raise ValueError(f"{name} takes an even Dh, got {dh}")
    for label, x in (("cos", cos), ("sin", sin)):
        if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] not in (1, b) \
                or tuple(x.shape[1:]) != (t, dh // 2):
            raise ValueError(f"{name}: {label} must be f32 (B or 1, T, Dh/2), got "
                             f"{x.dtype} {tuple(x.shape)} for rows {tuple(q.shape)}")
    cos, sin = cos.contiguous(), sin.contiguous()
    c = 0
    if k_cache is not None:
        c = k_cache.shape[2]
        _check_pos(name, pos, t, c, k_cache.device)
        if k_cache.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} takes bf16 or f32 rings, got {k_cache.dtype}")
        if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
            raise ValueError(f"{name}: K and V rings differ in dtype or shape")
        if k_cache.shape != (b, h, c, dh):
            raise ValueError(f"{name}: rows {tuple(q.shape)} do not fit ring "
                             f"{tuple(k_cache.shape)}")
        for label, x in (("k_cache", k_cache), ("v_cache", v_cache)):
            if not x.is_contiguous():
                raise ValueError(f"{name}: {label} is not contiguous")
    q_out = torch.empty((b, h, t, dh), dtype=q.dtype, device=q.device)
    k_out = torch.empty_like(q_out)
    strides = [s for x in (q, k, v if v is not None else k) for s in x.stride()[:3]]
    err = _build.launch(_build.lib().dsm_rope_commit, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr() if v is not None else None, *strides,
        cos.data_ptr(), sin.data_ptr(), 0 if cos.shape[0] == 1 else t * (dh // 2),
        q_out.data_ptr(), k_out.data_ptr(),
        k_cache.data_ptr() if k_cache is not None else None,
        v_cache.data_ptr() if v_cache is not None else None,
        b, h, t, dh, c, pos.data_ptr() if pos is not None else None, q.element_size(),
        k_cache.element_size() if k_cache is not None else 2,
    )
    _build.check(err, name)
    return q_out, k_out


def rope_commit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                pos: torch.Tensor):
    """Rotate ``q, k (B, H, T, Dh)`` by the rotary embedding ``cos, sin (B
    or 1, T, Dh/2)`` (as ``attention.apply_rope``), write the rotated k and
    the unchanged ``v`` into the bf16 or f32 rings ``(B, H, C, Dh)`` at rows
    ``w .. w+T-1``, ``w = pos % C``, in place, and return the rotated ``q,
    k``, contiguous in q's dtype, in one launch: the step's ``apply_rope`` x2 +
    :func:`ring_commit`.  q, k and v are read through their strides."""
    tensors = {"q": q, "k": k, "v": v, "k_cache": k_cache, "v_cache": v_cache,
               "cos": cos, "sin": sin}
    attn.no_backward("rope_commit", *tensors.values())
    if _all_on_cpu("rope_commit", tensors):
        _check_pos("rope_commit", pos, q.shape[2], k_cache.shape[2], k_cache.device)
        return rope_commit_plain(q, k, v, k_cache, v_cache, cos, sin, pos)
    out = _rope_launch("rope_commit", q, k, v, k_cache, v_cache, cos, sin, pos)
    rope_commit.launches += 1
    return out


rope_commit.launches = 0


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate ``q, k (B, H, T, Dh)`` by the rotary embedding ``cos, sin (B
    or 1, T, Dh/2)`` and return them contiguous in q's dtype, in one launch
    of :func:`rope_commit`'s kernel without rings: the step's ``apply_rope``
    x2 before the int8 and packed-int4 commits."""
    attn.no_backward("rope_qk", q, k, cos, sin)
    if _all_on_cpu("rope_qk", {"q": q, "k": k, "cos": cos, "sin": sin}):
        return rope_qk_plain(q, k, cos, sin)
    out = _rope_launch("rope_qk", q, k, None, None, None, cos, sin, None)
    rope_qk.launches += 1
    return out


rope_qk.launches = 0
