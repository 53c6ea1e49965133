// Hopper (sm_90a) kernels of the KV rings: the commits.
//
// Three copy kernels, each the counterpart of one Pallas TPU kernel:
//   dsm_ring_commit    <- dsm_tpu/ops/ring_kernels.py:_ring_commit
//   dsm_ring_commit_q  <- dsm_tpu/ops/ring_kernels.py:_ring_commit_q
//   dsm_scale_commit   <- dsm_tpu/ops/ring_kernels.py:_scale_commit
// the transpose of the first, for training (no Pallas kernel: JAX's autodiff
// derives it from dsm_tpu/ops/transformer.py:552's commit):
//   dsm_ring_commit_backward
// and the two kernels that serve them on the step's path, the eager work in
// front of each commit folded in:
//   dsm_quantize_commit <- _ring_commit_q (the rows into the rings) and
//                          _scale_commit (the rows returned), with
//                          dsm_tpu/ops/attention.py:quantize_kv_rows(_packed4)
//                          before them, which XLA fuses on the TPU
//   dsm_rope_commit     <- _ring_commit, with
//                          dsm_tpu/ops/attention.py:apply_rope on q and k
//                          before it (without rings: the rope alone, before
//                          dsm_quantize_commit on the int8 and int4 rings)
// The fused pipeline's attention, which commits its int8 row itself, is in
// decode_attn.cu (dsm_decode_attend_commit).
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py).  Each
// entry point launches on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Rings are updated in place.
//
// The write row: each entry point takes a device pointer to the step's
// shared tick pos (an int32 0-d tensor, non-negative), and each kernel
// reads it and writes rows w = pos % C on, as the Pallas kernels read their
// scalar-prefetched w from device memory.  No launch depends on a value on
// the host that changes from step to step, so a step's launches can be
// captured in a CUDA graph once and replayed.  The read is one dependent
// load at a thread's start, served from L2 after the first block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads per block of every kernel here

// ---------------------------------------------------------------------------
// Ring commit: copy T new rows (B, H, T, Dh) into rings (B, H, C, Dh) at row
// w.  One thread per element; blockIdx.y picks K (0) or V (1).  Elem is a
// same-width unsigned integer: the copy is bit for bit.
// ---------------------------------------------------------------------------
template <typename Elem>
__global__ void ring_commit_kernel(Elem* __restrict__ k_cache,
                                   Elem* __restrict__ v_cache,
                                   const Elem* __restrict__ k_new,
                                   const Elem* __restrict__ v_new,
                                   int64_t n, int t, int c, int dh,
                                   const int* __restrict__ pos) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = *pos % c;
  const int d = (int)(i % dh);
  const int64_t row = i / dh;
  const int ti = (int)(row % t);
  const int64_t bh = row / t;
  const int64_t dst = (bh * c + w + ti) * dh + d;
  if (blockIdx.y == 0) {
    k_cache[dst] = k_new[i];
  } else {
    v_cache[dst] = v_new[i];
  }
}

// ---------------------------------------------------------------------------
// Scale commit: copy T fresh per-row scales (B, H, T) into the scale rings
// (B, H, C) at row w.  One thread per element; blockIdx.y picks K or V.
// ---------------------------------------------------------------------------
__global__ void scale_commit_kernel(float* __restrict__ ks_cache,
                                    float* __restrict__ vs_cache,
                                    const float* __restrict__ ks_new,
                                    const float* __restrict__ vs_new,
                                    int64_t n, int t, int c, const int* __restrict__ pos) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = *pos % c;
  const int ti = (int)(i % t);
  const int64_t bh = i / t;
  const int64_t dst = bh * c + w + ti;
  if (blockIdx.y == 0) {
    ks_cache[dst] = ks_new[i];
  } else {
    vs_cache[dst] = vs_new[i];
  }
}

// ---------------------------------------------------------------------------
// Quantised ring commit: T new int8 rows (B, H, T, Dh) of K and of V into the
// int8 rings (B, H, C, Dh), and their T per-row f32 scales (B, H, T) into
// the scale rings (B, H, C), all at row w, in one launch.  blockIdx.y picks
// the K rows (0), the V rows (1) or both scale rings (2).  The int8 rows move
// as 32-bit words (Dh is a multiple of 4 and the rings are word-aligned), the
// copy is bit for bit; nibble-packed int4 rows (uint8, Dh / 2 bytes) are the
// same copy at half the row width.  A few tens of KB at most: bound by the launch, not
// by bandwidth.  The TPU kernel streams the aligned row block through VMEM
// and selects the T rows, because Mosaic cannot write a partial tile; a GPU
// store of one word needs no such block.
// ---------------------------------------------------------------------------
__global__ void ring_commit_q_kernel(uint32_t* __restrict__ k_cache,
                                     uint32_t* __restrict__ v_cache,
                                     float* __restrict__ ks_cache,
                                     float* __restrict__ vs_cache,
                                     const uint32_t* __restrict__ k_new,
                                     const uint32_t* __restrict__ v_new,
                                     const float* __restrict__ ks_new,
                                     const float* __restrict__ vs_new,
                                     int64_t n_words, int64_t n_scales, int t,
                                     int c, int dw, const int* __restrict__ pos) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int w = *pos % c;
  if (blockIdx.y == 2) {
    if (i >= n_scales) return;
    const int ti = (int)(i % t);
    const int64_t dst = (i / t) * c + w + ti;
    ks_cache[dst] = ks_new[i];
    vs_cache[dst] = vs_new[i];
    return;
  }
  if (i >= n_words) return;
  const int d = (int)(i % dw);  // dw = Dh / 4 words per row
  const int64_t row = i / dw;
  const int ti = (int)(row % t);
  const int64_t dst = ((row / t) * c + w + ti) * dw + d;
  if (blockIdx.y == 0) {
    k_cache[dst] = k_new[i];
  } else {
    v_cache[dst] = v_new[i];
  }
}

// ---------------------------------------------------------------------------
// Quantise and commit: the fresh bf16 K and V rows (B, H, 1, Dh), read
// where they lie through their (b, h) strides (V is a strided view of
// the QKV product), each quantised per row as
// dsm_tpu/ops/attention.py:quantize_kv_rows(_packed4) under jax.jit:
//   scale = max(amax, 1e-8) * fl(1/qmax)   qmax = 127 (int8) or 7 (int4)
//   q     = clamp(rint(x / scale), -qmax, qmax)
// in f32: XLA folds the division by the constant qmax into a product with
// its f32 reciprocal (__fmul_rn), the division by the scale stays an IEEE
// division (__fdiv_rn), rounded half to even (rintf), no fast math: bit for
// bit the jitted JAX function's and the plain version's.  A row
// holding a NaN keeps it: amax and scale NaN (torch.clamp and jnp.maximum
// keep a NaN where fmaxf would drop it), every value 0, as a NaN converts.
// The int8 row, or the nibble-packed row of attention.pack4 (byte d holds
// dims d and d + Dh/2, excess-8), goes to `kq/vq + (b*H + h) * q_pane +
// w * q_row`: the ring row w (q_pane = C row widths, q_row = one) or the
// returned rows (q_pane = one row width, q_row = 0); both scales go into the
// scale rings at row w.
// One launch for K and V.
//
// What bounds it on the H100: nothing the card can stream.  The stt-1b rows
// are 512 KB of bf16 in and some 270 KB out, a tenth of a microsecond at
// 3.35 TB/s, where a launch costs some 2 us whatever it does.  On the TPU
// XLA fuses the eager quantisation into the producers around the Pallas
// commit; here it was some 19 launches a layer (27 at int4) before one copy
// launch.  So the design removes launches and device passes and nothing
// else: Dh/8 lanes a row (a segment of a power of two lanes, 16 at Dh=128,
// 8 at Dh=64), each with one 16-byte load of 8 bf16 values, the
// row's amax by __shfl_xor_sync within the segment, the values quantised in
// registers, one 8-byte store of int8 a lane; for a packed row the lanes of
// the first half exchange 4 nibbles by one shuffle with their partners Dh/2
// dims on, and each lane stores one 32-bit word of whole bytes.  One lane
// stores the scale.  No shared memory, no synchronisation beyond the warp.
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 128;  // threads per block of the quantise-and-commit kernel
// fl(1/127) and fl(1/7): the f32 reciprocals XLA multiplies by where the
// jitted step divides by 127.0 or 7.0; attention.mul_recip's too.
constexpr float kRecip127 = 0x1.020408p-7f;
constexpr float kRecip7 = 0x1.24924ap-3f;

struct QuantCommitArgs {
  const uint16_t* k;      // fresh bf16 rows, (B, H, 1, Dh), the last dim contiguous
  const uint16_t* v;
  long long k_sb, k_sh;   // (b, h) strides of k, in elements
  long long v_sb, v_sh;
  uint8_t* kq;            // int8 or packed row of pane (b, h) at kq + bh * q_pane + w * q_row
  uint8_t* vq;
  long long q_pane;       // bytes
  long long q_row;        // bytes
  float* ks;              // scale rings (B, H, C)
  float* vs;
  const int* pos;         // the shared tick; w = pos % c
  long long rows;         // B * H
  int h, c;
  int lanes;              // Dh / 8 lanes hold a row
  int seg_log2;           // log2 of the segment: lanes rounded up to a power of two
};

// max that keeps a NaN from either side (fmaxf returns the other operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void load8(const uint16_t* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);  // 8 bf16
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kQuantThreads)
quantize_commit_kernel(const QuantCommitArgs a) {
  const int seg = 1 << a.seg_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (seg - 1);  // lane within the row's segment
  // Row index over K rows then V rows; a segment's lanes share it, so whole
  // segments leave together and the shuffles below name live lanes only.
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> a.seg_log2;
  if (row >= 2 * a.rows) return;
  const bool is_v = row >= a.rows;
  const long long bh = is_v ? row - a.rows : row;
  const long long b = bh / a.h;
  const long long hh = bh - b * a.h;
  const unsigned mask = seg == 32 ? 0xffffffffu : ((1u << seg) - 1u) << (lane & ~(seg - 1));
  const bool live = sub < a.lanes;  // lanes past Dh/8 in a segment hold nothing
  const int w = *a.pos % a.c;

  float x[8];
  float m = 0.f;
  if (live) {
    const uint16_t* src = (is_v ? a.v : a.k) + b * (is_v ? a.v_sb : a.k_sb) +
                          hh * (is_v ? a.v_sh : a.k_sh) + sub * 8;
    load8(src, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) m = nan_max(m, fabsf(x[i]));
  }
  for (int off = seg >> 1; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(mask, m, off));
  const float qmax = kPacked ? 7.f : 127.f;
  const float scale = m != m ? m : __fmul_rn(fmaxf(m, 1e-8f), kPacked ? kRecip7 : kRecip127);

  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float r = rintf(__fdiv_rn(live ? x[i] : 0.f, scale));
    q[i] = r != r ? 0 : (int)fminf(fmaxf(r, -qmax), qmax);
  }
  uint8_t* dst = (is_v ? a.vq : a.kq) + bh * a.q_pane + w * a.q_row;
  if (kPacked) {
    // Nibbles q + 8, one a byte: dims 0-3 of the lane in `lo`, 4-7 in `hi`.
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= (uint32_t)(q[i] + 8) << (8 * i);
      hi |= (uint32_t)(q[i + 4] + 8) << (8 * i);
    }
    // Lane l < half holds dims 8l.. and lane l + half the dims Dh/2 on: the
    // first forms bytes 8l..8l+3 (its lo under the partner's lo), the
    // second bytes 8l+4..8l+7 (the first's hi under its own hi).
    const int half = a.lanes >> 1;
    const bool first = sub < half;
    const int base = lane & ~(seg - 1);
    const uint32_t other =
        __shfl_sync(mask, first ? hi : lo, base + (first ? sub + half : sub - half));
    if (live) {
      const uint32_t word = first ? lo | (other << 4) : other | (hi << 4);
      reinterpret_cast<uint32_t*>(dst)[first ? 2 * sub : 2 * (sub - half) + 1] = word;
    }
  } else if (live) {
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w0 |= (uint32_t)(q[i] & 0xff) << (8 * i);
      w1 |= (uint32_t)(q[i + 4] & 0xff) << (8 * i);
    }
    reinterpret_cast<uint2*>(dst)[sub] = make_uint2(w0, w1);
  }
  if (sub == 0) (is_v ? a.vs : a.ks)[bh * a.c + w] = scale;
}

// ---------------------------------------------------------------------------
// Rope and commit: the rotary embedding of q and k (B, H, T, Dh), read where
// they lie through their (b, h, t) strides (views of the QKV product), as
// dsm_tpu/ops/attention.py:apply_rope computes it under jax.jit, which
// contracts each pair's rotation into one fused multiply-add:
//   o1 = fma(x1, c, -(x2 * s))     o2 = fma(x1, s, x2 * c)
// (__fmul_rn / __fmaf_rn: nvcc's own contraction cannot move a rounding),
// cast back to x's type (__float2bfloat16_rn for bf16).  The rotated q and
// k go to contiguous outputs (B, H, T, Dh); with rings, the rotated k and
// the unchanged v also go into the K/V rings (B, H, C, Dh) at rows w ..
// w+T-1, w = pos % C, converted to the rings' type as the plain version's
// assignment converts them.  cos and sin are (B or 1, T, Dh/2) f32: cs_b is their batch
// stride, 0 where one row serves every b.
//
// What bounds it on the H100: its launch.  The Mimi layer's q, k and v
// (64, 8, 2, 64) bf16 are 393 KB in; the rotated q and k and the two ring
// rows 524 KB out: a quarter of a microsecond at 3.35 TB/s, where a launch
// costs some 2 us.  On the TPU XLA fuses the rope
// into the producers around the Pallas commit; here it was 16 launches (two
// of apply_rope's eight-operation chains) and a copy of V before the commit's
// one.  So the design removes launches and nothing else: one thread a
// rotary pair, blockIdx.y picks q (0), k (1) or v (2), no shared memory, no
// synchronisation.
// ---------------------------------------------------------------------------
struct RopeCommitArgs {
  const void* src[3];    // q, k, v: (B, H, T, Dh) in x's type, pairs contiguous
  long long sb[3], sh[3], st[3];  // their (b, h, t) strides, in elements
  const float* cos;      // (B or 1, T, Dh/2)
  const float* sin;
  long long cs_b;        // batch stride of cos / sin in elements
  void* out[2];          // rotated q, k: (B, H, T, Dh) contiguous, x's type
  void* ring[2];         // K, V rings (B, H, C, Dh) in the rings' type, or null
  const int* pos;        // the shared tick (with rings); w = pos % c
  long long pairs;       // B * H * T * Dh / 2
  int h, t, half, c;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// x's type into the rings' type, as a PyTorch .to() converts it.
template <typename R, typename X>
__device__ __forceinline__ R convert(X x) {
  if constexpr (std::is_same<R, X>::value) {
    return x;
  } else {
    return from_float<R>(to_float(x));
  }
}

template <typename X, typename R>
__global__ void __launch_bounds__(kThreads) rope_commit_kernel(const RopeCommitArgs a) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.pairs) return;
  const int which = blockIdx.y;  // 0 q, 1 k, 2 v
  const int p = (int)(i % a.half);
  const long long row = i / a.half;  // (b, h, t) in row-major order
  const int ti = (int)(row % a.t);
  const long long bh = row / a.t;
  const long long b = bh / a.h;
  const long long hh = bh - b * a.h;
  // Selects by which without indexing the parameter arrays at run time,
  // which would copy the arguments to local memory.
  const void* base = which == 0 ? a.src[0] : which == 1 ? a.src[1] : a.src[2];
  const long long sb = which == 0 ? a.sb[0] : which == 1 ? a.sb[1] : a.sb[2];
  const long long sh = which == 0 ? a.sh[0] : which == 1 ? a.sh[1] : a.sh[2];
  const long long st = which == 0 ? a.st[0] : which == 1 ? a.st[1] : a.st[2];
  const X* src = (const X*)base + b * sb + hh * sh + ti * st + 2 * p;
  const X x1 = src[0], x2 = src[1];
  const int w = a.ring[0] != nullptr ? *a.pos % a.c : 0;
  const long long dst = (bh * a.c + w + ti) * (2LL * a.half) + 2 * p;
  if (which == 2) {
    R* v_ring = (R*)a.ring[1];
    v_ring[dst] = convert<R>(x1);
    v_ring[dst + 1] = convert<R>(x2);
    return;
  }
  const long long cs = b * a.cs_b + (long long)ti * a.half + p;
  const float c = a.cos[cs], s = a.sin[cs];
  const float f1 = to_float(x1), f2 = to_float(x2);
  const X o1 = from_float<X>(__fmaf_rn(f1, c, -__fmul_rn(f2, s)));
  const X o2 = from_float<X>(__fmaf_rn(f1, s, __fmul_rn(f2, c)));
  X* out = (X*)(which == 0 ? a.out[0] : a.out[1]) + row * (2LL * a.half) + 2 * p;
  out[0] = o1;
  out[1] = o2;
  if (which == 1 && a.ring[0] != nullptr) {
    R* k_ring = (R*)a.ring[0];
    k_ring[dst] = convert<R>(o1);
    k_ring[dst + 1] = convert<R>(o2);
  }
}

template <typename X>
void launch_rope_commit(const RopeCommitArgs& a, int r_bytes, dim3 grid, cudaStream_t s) {
  if (r_bytes == 2) {
    rope_commit_kernel<X, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    rope_commit_kernel<X, float><<<grid, kThreads, 0, s>>>(a);
  }
}

// ---------------------------------------------------------------------------
// Ring commit backward: the gradients g (B, H, C, Dh) of the rings after a
// commit of T rows at w -> the rings' gradients before it (rows w .. w+T-1
// zero: the commit overwrote them) and the new rows' (B, H, T, Dh) (those
// rows).  The incoming gradients are only read: autograd may hand the same
// tensor to another consumer.  One thread per 16-byte unit of a ring row (Unit
// = uint4, or narrower where the row is not a multiple of 16 bytes);
// blockIdx.y picks K (0) or V (1).  Bytes are copied, so the split is bit for
// bit.  C % T == 0 and w % T == 0, so the rows never wrap.
// ---------------------------------------------------------------------------
template <typename Unit>
__global__ void ring_commit_backward_kernel(const Unit* __restrict__ gk,
                                            const Unit* __restrict__ gv,
                                            Unit* __restrict__ gk_old,
                                            Unit* __restrict__ gv_old,
                                            Unit* __restrict__ gk_new,
                                            Unit* __restrict__ gv_new,
                                            int64_t n, int t, int c, int row_units,
                                            const int* __restrict__ pos) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = *pos % c;
  const int u = (int)(i % row_units);
  const int64_t row = i / row_units;
  const int r = (int)(row % c) - w;
  const int64_t bh = row / c;
  const bool is_k = blockIdx.y == 0;
  const Unit g = is_k ? gk[i] : gv[i];
  Unit* old = is_k ? gk_old : gv_old;
  if (r >= 0 && r < t) {
    (is_k ? gk_new : gv_new)[(bh * t + r) * row_units + u] = g;
    old[i] = Unit{};  // all bits zero: +0.0
  } else {
    old[i] = g;
  }
}

inline unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename Unit>
void launch_ring_commit_backward(const void* gk, const void* gv, void* gk_old, void* gv_old,
                                 void* gk_new, void* gv_new, int64_t rows,
                                 int64_t row_bytes, int t, int c, const int* pos,
                                 cudaStream_t s) {
  const int row_units = (int)(row_bytes / (int64_t)sizeof(Unit));
  const int64_t n = rows * row_units;
  const dim3 grid(grid_for(n), 2);
  ring_commit_backward_kernel<Unit><<<grid, kThreads, 0, s>>>(
      (const Unit*)gk, (const Unit*)gv, (Unit*)gk_old, (Unit*)gv_old, (Unit*)gk_new,
      (Unit*)gv_new, n, t, c, row_units, pos);
}

}  // namespace

extern "C" {

const char* dsm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// elem_bytes: 2 (bf16) or 4 (f32); pos: the device int32 tick, rows
// pos % c on.  Returns a cudaError_t.
int dsm_ring_commit(void* k_cache, void* v_cache, const void* k_new,
                    const void* v_new, int elem_bytes, long long b, int h,
                    int t, int c, int dh, const int* pos, void* stream) {
  const int64_t n = (int64_t)b * h * t * dh;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n), 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    ring_commit_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        (uint16_t*)k_cache, (uint16_t*)v_cache, (const uint16_t*)k_new,
        (const uint16_t*)v_new, n, t, c, dh, pos);
  } else if (elem_bytes == 4) {
    ring_commit_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        (uint32_t*)k_cache, (uint32_t*)v_cache, (const uint32_t*)k_new,
        (const uint32_t*)v_new, n, t, c, dh, pos);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward of dsm_ring_commit: gk, gv (b, h, c, dh) read; gk_old,
// gv_old (b, h, c, dh) and gk_new, gv_new (b, h, t, dh) written, all
// contiguous; elem_bytes 2 (bf16) or 4 (f32); rows pos % c on.  Returns a
// cudaError_t.
int dsm_ring_commit_backward(const void* gk, const void* gv, void* gk_old, void* gv_old,
                             void* gk_new, void* gv_new, int elem_bytes, long long b,
                             int h, int t, int c, int dh, const int* pos, void* stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const int64_t row_bytes = (int64_t)dh * elem_bytes;
  const int64_t rows = (int64_t)b * h * c;
  if (rows == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)gk | (uintptr_t)gv | (uintptr_t)gk_old |
                          (uintptr_t)gv_old | (uintptr_t)gk_new | (uintptr_t)gv_new;
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    launch_ring_commit_backward<uint4>(gk, gv, gk_old, gv_old, gk_new, gv_new, rows,
                                       row_bytes, t, c, pos, s);
  } else if (row_bytes % 4 == 0 && align % 4 == 0) {
    launch_ring_commit_backward<uint32_t>(gk, gv, gk_old, gv_old, gk_new, gv_new, rows,
                                          row_bytes, t, c, pos, s);
  } else {
    launch_ring_commit_backward<uint16_t>(gk, gv, gk_old, gv_old, gk_new, gv_new, rows,
                                          row_bytes, t, c, pos, s);
  }
  return (int)cudaGetLastError();
}

// int8 (or packed-int4 uint8) rings and rows, f32 scale rings and rows; dh
// is the row width in bytes (Dh, or Dh / 2 packed), a multiple of 4.
int dsm_ring_commit_q(void* k_cache, void* v_cache, void* ks_cache,
                      void* vs_cache, const void* k_new, const void* v_new,
                      const void* ks_new, const void* vs_new, long long b,
                      int h, int t, int c, int dh, const int* pos, void* stream) {
  if (dh % 4) return (int)cudaErrorInvalidValue;
  const int64_t n_scales = (int64_t)b * h * t;
  const int64_t n_words = n_scales * (dh / 4);
  if (n_scales == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n_words > n_scales ? n_words : n_scales), 3);
  ring_commit_q_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)k_cache, (uint32_t*)v_cache, (float*)ks_cache,
      (float*)vs_cache, (const uint32_t*)k_new, (const uint32_t*)v_new,
      (const float*)ks_new, (const float*)vs_new, n_words, n_scales, t, c,
      dh / 4, pos);
  return (int)cudaGetLastError();
}

int dsm_scale_commit(void* ks_cache, void* vs_cache, const void* ks_new,
                     const void* vs_new, long long b, int h, int t, int c,
                     const int* pos, void* stream) {
  const int64_t n = (int64_t)b * h * t;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n), 2);
  scale_commit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)ks_cache, (float*)vs_cache, (const float*)ks_new,
      (const float*)vs_new, n, t, c, pos);
  return (int)cudaGetLastError();
}

// The fresh bf16 rows k, v (B, H, 1, Dh), their (b, h) strides in elements
// (the rows 16-byte aligned); the int8 (packed4 0) or packed-int4 (packed4
// 1) rows go to kq/vq + (b*H + h) * q_pane + w * q_row bytes, the scales into
// ks/vs (B, H, C) at row w, w = pos % c.  Dh a multiple of 8 (of 16 packed)
// from 8 to 256.  Returns a cudaError_t.
int dsm_quantize_commit(const void* k, const void* v, long long k_sb, long long k_sh,
                        long long v_sb, long long v_sh, void* kq, void* vq,
                        long long q_pane, long long q_row, void* ks, void* vs, long long b,
                        int h, int c, int dh, int packed4, const int* pos, void* stream) {
  if (dh % (packed4 ? 16 : 8) || dh < 8 || dh > 256) return (int)cudaErrorInvalidValue;
  QuantCommitArgs a;
  a.k = (const uint16_t*)k; a.v = (const uint16_t*)v;
  a.k_sb = k_sb; a.k_sh = k_sh; a.v_sb = v_sb; a.v_sh = v_sh;
  a.kq = (uint8_t*)kq; a.vq = (uint8_t*)vq; a.q_pane = q_pane; a.q_row = q_row;
  a.ks = (float*)ks; a.vs = (float*)vs; a.pos = pos;
  a.rows = b * h; a.h = h; a.c = c;
  a.lanes = dh / 8;
  a.seg_log2 = 0;
  while ((1 << a.seg_log2) < a.lanes) ++a.seg_log2;
  if (a.rows == 0) return (int)cudaSuccess;
  const int64_t threads = 2 * a.rows << a.seg_log2;
  const unsigned grid = (unsigned)((threads + kQuantThreads - 1) / kQuantThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed4) {
    quantize_commit_kernel<true><<<grid, kQuantThreads, 0, s>>>(a);
  } else {
    quantize_commit_kernel<false><<<grid, kQuantThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// q, k, v (B, H, T, Dh) with their (b, h, t) strides in elements (pairs
// contiguous), x_bytes 2 (bf16) or 4 (f32); cos, sin (B or 1, T, Dh/2) f32
// with batch stride cs_b; the rotated q, k into q_out, k_out (B, H, T, Dh)
// contiguous; with k_cache and v_cache not null, the rotated k and v into
// the rings (B, H, C, Dh) of r_bytes 2 (bf16) or 4 (f32) at rows w ..
// w+T-1, w = pos % c (pos the device int32 tick; unread without rings).
// Returns a cudaError_t.
int dsm_rope_commit(const void* q, const void* k, const void* v, long long q_sb,
                    long long q_sh, long long q_st, long long k_sb, long long k_sh,
                    long long k_st, long long v_sb, long long v_sh, long long v_st,
                    const void* cos, const void* sin, long long cs_b, void* q_out,
                    void* k_out, void* k_cache, void* v_cache, long long b, int h, int t,
                    int dh, int c, const int* pos, int x_bytes, int r_bytes, void* stream) {
  if (dh % 2 || (x_bytes != 2 && x_bytes != 4) || (r_bytes != 2 && r_bytes != 4) ||
      (k_cache == nullptr) != (v_cache == nullptr) || (k_cache != nullptr && pos == nullptr))
    return (int)cudaErrorInvalidValue;
  RopeCommitArgs a;
  a.src[0] = q; a.src[1] = k; a.src[2] = v;
  a.sb[0] = q_sb; a.sh[0] = q_sh; a.st[0] = q_st;
  a.sb[1] = k_sb; a.sh[1] = k_sh; a.st[1] = k_st;
  a.sb[2] = v_sb; a.sh[2] = v_sh; a.st[2] = v_st;
  a.cos = (const float*)cos; a.sin = (const float*)sin; a.cs_b = cs_b;
  a.out[0] = q_out; a.out[1] = k_out;
  a.ring[0] = k_cache; a.ring[1] = v_cache;
  a.pos = pos;
  a.half = dh / 2; a.h = h; a.t = t; a.c = c;
  a.pairs = b * h * t * a.half;
  if (a.pairs == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(a.pairs), k_cache != nullptr ? 3 : 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bytes == 2) {
    launch_rope_commit<__nv_bfloat16>(a, r_bytes, grid, s);
  } else {
    launch_rope_commit<float>(a, r_bytes, grid, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
