// Hopper (sm_90a) kernel of the split ring pipeline's decode attention.
//
//   dsm_decode_attend  <- dsm_tpu/ops/decode_attn.py:_decode_attend_q_flash
//     with packed4 = 1  <- dsm_tpu/ops/decode_attn.py:_decode_attend_q4_4d
//                          and :_decode_attend_q4 (the head-major layout)
//
// T=1 decode attention of bf16 queries over the COMMITTED int8 K/V ring with
// per-row f32 scales (ring_commit_q has already written this step's row at
// w; it is masked from the ring read here), with this step's fresh bf16 K/V
// row joining the softmax exactly:
//
//   row j holds the key at k_pos = pos - ((w - j) mod C); it is attended iff
//   k_pos >= 0, pos - k_pos < window, j != w and valid[b, j].
//   s_j   = (q . K_j) * (ks_j * scale)            f32, attended rows only
//   s_new = (q . k_new) * scale                   f32, the fresh bf16 row
//   per span i of the ring:  m_i = max_j s_j,  e_j = exp(s_j - m_i),
//     l_i = sum_j e_j,  acc_i = sum_j bf16(e_j * vs_j) V_j
//   m = max(max_i m_i, s_new),  e_new = exp(s_new - m),  c_i = exp(m_i - m)
//   out = (sum_i c_i acc_i + e_new v_new) / (sum_i c_i l_i + e_new)  -> bf16
//
// What bounds it on the H100: bytes.  At the s2s-2b serving shape (B=24,
// H=20, C=3072, Dh=128) a full ring is 2 x 24 x 20 x 3072 x 128 B = 377 MB
// of int8 plus 11.8 MB of scales per call, about 116 us at 3.35 TB/s, 24
// times a tick.  Two multiply-adds per byte: no tensor cores, a query of one
// row against C rows is a matrix-vector product.
//
// What the design does about it.  The TPU kernel walks the ring in chunks on
// a sequential grid axis and carries (m, l, acc) in scratch memory; here the
// chunks are blocks that run in parallel: grid (B*H * n_split), each block
// reduces its span of ring rows to one partial (acc[Dh], m, l) in f32, and a
// second small kernel folds the partials and the fresh row in a fixed order
// (no atomics: repeated runs are bit-identical).  A lane loads 16 bytes of a
// row, so a 128-byte row takes 8 lanes and a warp reads 4 rows per step (8
// rows at Dh=64) with a 3-step (2-step) shuffle each, against the 5-step
// shuffle per row of the one-block kernel in ring_attn.cu.  Rows the mask
// excludes are never read, and a span without an attended row exits with
// m = -inf, l = 0 after reading nothing, so a ring that is not yet full is
// not read past pos and exp(-1e9 - -1e9) = 1 cannot arise.  n_split = 1 is
// the whole ring in one block per (b, h).
//
// Operands keep their (B, H, C, Dh) layout and are addressed through (b, h)
// strides, so a head-major (B*H, C, Dh) ring is the same kernel with other
// strides; the Dh values of a row and the C scales of one (b, h) are
// contiguous, rows 16-byte aligned.
//
// Packed-int4 rings (packed4 = 1): a ring row is Dh/2 bytes, byte d holding
// dims d (low nibble) and d + Dh/2 (high nibble), each stored excess-8
// (dsm_tpu/ops/attention.py:pack4).  The body is the same; only the load
// differs.  A lane's 16-byte load now holds 32 values of one row: 16
// neighbouring dims of the first half of the feature dim in the low nibbles
// and the 16 dims Dh/2 further on in the high nibbles, so the lane keeps
// those 32 entries of q (and 32 output sums) and a row takes Dh/32 lanes: a
// warp reads 8 rows per step at Dh=128 and 16 at Dh=64.  The values are
// (nibble - 8) as f32: the products with bf16 q and the bf16-rounded probs
// are the Pallas kernels' bf16 x bf16 -> f32 dots.  A never-written row is all
// zero bytes, which unpack to -8: it is masked by the bitmap and never read.
// What bounds it: half the int8 ring's bytes for the same count of values, so
// the operations per value weigh twice as much: the unpack is a shift, one
// logic operation and one f32 subtraction a value (unpack_load, attn_common.cuh).
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): the
// entry point launches both kernels on the caller's stream, does not
// synchronise, allocates nothing (the caller passes the partials' scratch)
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using namespace dsm_attn;

constexpr int kDaThreads = kAttnThreads;
constexpr int kDaWarps = kAttnWarps;

// The feature dim of value e of the lane that holds bytes [16 sub, 16 sub + 16)
// of a row.
template <int DH, bool P4>
__device__ __forceinline__ int da_dim(int sub, int e) {
  if constexpr (P4) return (e < 16 ? 0 : DH / 2 - 16) + sub * 16 + e;
  return sub * 16 + e;
}

// One block per (b, h, span).  Strides are in elements (bytes for the
// rings): k/v (b, h) -> base + b*kv_sb + h*kv_sh, then row j at j*RB with RB
// the row's bytes (DH, or DH/2 packed); scales (b, h) -> base +
// b*s_sb + h*s_sh, then row j at j.  q is contiguous (B*H, DH); part is
// (B*H, n_split, DH + 2): acc[DH], then m, then l.
// The int8 load path is held to 40 registers, six blocks a multiprocessor: the
// kernel waits on memory, and with five blocks (48 registers) it measured 13 to
// 24 % slower.  The packed load path keeps 32 values and 32 sums a lane: four.
template <int DH, bool P4>
__global__ void __launch_bounds__(kDaThreads, P4 ? 4 : 6) decode_attend_partial_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const uint8_t* __restrict__ valid,
    float* __restrict__ part, int h, int c, int n_split, int span,
    long long kv_sb, long long kv_sh, long long s_sb, long long s_sh,
    long long pos, int w, int window, float scale) {
  constexpr int RB = P4 ? DH / 2 : DH;  // bytes of a ring row
  constexpr int LPR = RB / 16;          // lanes per ring row
  constexpr int RPW = 32 / LPR;         // ring rows per warp and step
  constexpr int VPL = P4 ? 32 : 16;     // values a lane holds of its row
  extern __shared__ float smem[];
  float* probs = smem;        // span floats: scores, then bf16-rounded probs
  float* red = smem + span;   // kDaWarps * DH floats: per-warp partial outputs
  __shared__ float warp_red[kDaWarps];

  const int bh = blockIdx.x / n_split;
  const int sp = blockIdx.x - bh * n_split;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPR;   // which 16 values of the row
  const int rsub = lane / LPR;  // which row of the warp's step
  const int s0 = sp * span;
  const int s1 = min(c, s0 + span);

  const int8_t* kc = k_cache + b * kv_sb + hh * kv_sh;
  const int8_t* vc = v_cache + b * kv_sb + hh * kv_sh;
  const float* ks = k_scale + b * s_sb + hh * s_sh;
  const float* vs = v_scale + b * s_sb + hh * s_sh;
  const uint8_t* va = valid + (int64_t)b * c;
  float* out = part + ((int64_t)bh * n_split + sp) * (DH + 2);

  float qf[VPL];
#pragma unroll
  for (int e = 0; e < VPL; ++e)
    qf[e] = __bfloat162float(q[(int64_t)bh * DH + da_dim<DH, P4>(sub, e)]);

  // Phase 1: scores of the span's attended rows; masked rows are not read.
  float local_max = -INFINITY;
  for (int j0 = s0 + warp * RPW; j0 < s1; j0 += kDaWarps * RPW) {
    const int j = j0 + rsub;
    const bool ok = j < s1 && ring_row_attended(j, w, c, pos, window, va);
    float acc = 0.f;
    if (ok) {
      float kv[VPL];
      unpack_load<P4>(*reinterpret_cast<const int4*>(kc + (int64_t)j * RB + sub * 16), kv);
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc += qf[e] * kv[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float s = ok ? acc * (ks[j] * scale) : -INFINITY;
    if (sub == 0 && j < s1) probs[j - s0] = s;
    local_max = fmaxf(local_max, s);
  }
  const float m = block_max(local_max, warp_red);
  if (m == -INFINITY) {  // no attended row in this span (uniform over the block)
    if (tid < DH) out[tid] = 0.f;
    if (tid == 0) {
      out[DH] = -INFINITY;
      out[DH + 1] = 0.f;
    }
    return;
  }

  // Phase 2: exp, denominator, bf16-rounded probs (in place).
  const int n = s1 - s0;
  float local_sum = 0.f;
  for (int i = tid; i < n; i += kDaThreads) {
    const float s = probs[i];
    float p = 0.f;
    if (s != -INFINITY) {
      const float e = expf(s - m);
      local_sum += e;
      p = __bfloat162float(__float2bfloat16(e * vs[s0 + i]));
    }
    probs[i] = p;
  }
  const float denom = block_sum(local_sum, warp_red);  // the probs are all written

  // Phase 3: probs times V; rows whose prob is 0 add nothing and are not read.
  float acc[VPL];
#pragma unroll
  for (int e = 0; e < VPL; ++e) acc[e] = 0.f;
  for (int j0 = s0 + warp * RPW; j0 < s1; j0 += kDaWarps * RPW) {
    const int j = j0 + rsub;
    if (j >= s1) continue;
    const float p = probs[j - s0];
    if (p == 0.f) continue;
    float vv[VPL];
    unpack_load<P4>(*reinterpret_cast<const int4*>(vc + (int64_t)j * RB + sub * 16), vv);
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[e] += p * vv[e];
  }
  // Fold the warp's RPW row groups (lanes with the same sub).
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (rsub == 0) {
#pragma unroll
    for (int e = 0; e < VPL; ++e) red[warp * DH + da_dim<DH, P4>(sub, e)] = acc[e];
  }
  __syncthreads();

  // Phase 4: sum the warps' partials; write the span's (acc, m, l).
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kDaWarps; ++i) o += red[i * DH + tid];
    out[tid] = o;
  }
  if (tid == 0) {
    out[DH] = m;
    out[DH + 1] = denom;
  }
}

// One block of DH threads per (b, h): fold the spans' partials and the fresh
// bf16 row, in span order.  q, k_new, v_new, out are contiguous (B*H, DH).
template <int DH>
__global__ void __launch_bounds__(DH) decode_attend_combine_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int n_split, float scale) {
  constexpr int EPL = DH / 32;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = (int64_t)bh * DH;

  // Every warp sums the same products in the same order.
  float a = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    a += __bfloat162float(q[row + lane * EPL + e]) *
         __bfloat162float(k_new[row + lane * EPL + e]);
  }
  const float s_new = warp_sum(a) * scale;

  const float* p = part + (int64_t)bh * n_split * (DH + 2);
  float m = s_new;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, p[i * (DH + 2) + DH]);
  const float e_new = expf(s_new - m);
  float denom = e_new;
  float o = e_new * __bfloat162float(v_new[row + tid]);
  for (int i = 0; i < n_split; ++i) {
    const float pm = p[i * (DH + 2) + DH];
    if (pm == -INFINITY) continue;  // a span with no attended row
    const float corr = expf(pm - m);
    denom += p[i * (DH + 2) + DH + 1] * corr;
    o += p[i * (DH + 2) + tid] * corr;
  }
  out[row + tid] = __float2bfloat16(o / denom);
}

}  // namespace

extern "C" {

// Dynamic shared memory the partial kernel needs for spans of `span` rows.
long long dsm_decode_attend_split_smem_bytes(int span, int dh) {
  return (long long)(span + kDaWarps * dh) * (long long)sizeof(float);
}

// part: f32 scratch of b * h * n_split * (dh + 2) values.  packed4: the
// rings are nibble-packed int4 rows of dh / 2 bytes (else int8 rows of dh).
// Returns a cudaError_t.
int dsm_decode_attend(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale, const void* k_new,
                      const void* v_new, const void* valid, void* part, void* out,
                      long long b, int h, int c, int dh, int packed4, int n_split,
                      long long kv_sb, long long kv_sh, long long s_sb,
                      long long s_sh, long long pos, int w, int window,
                      float scale, void* stream) {
  const long long bh = b * h;
  if (bh == 0) return (int)cudaSuccess;
  if (n_split < 1 || c < 1 || w < 0 || w >= c) return (int)cudaErrorInvalidValue;
  const int span = (c + n_split - 1) / n_split;
  const size_t smem = (size_t)dsm_decode_attend_split_smem_bytes(span, dh);
  cudaStream_t s = (cudaStream_t)stream;
#define DSM_DA_LAUNCH(DH, P4)                                                    \
  decode_attend_partial_kernel<DH, P4><<<(unsigned)(bh * n_split), kDaThreads, smem, s>>>( \
      (const __nv_bfloat16*)q, (const int8_t*)k_cache, (const int8_t*)v_cache,   \
      (const float*)k_scale, (const float*)v_scale, (const uint8_t*)valid,       \
      (float*)part, h, c, n_split, span, kv_sb, kv_sh, s_sb, s_sh, pos, w,       \
      window, scale);                                                            \
  decode_attend_combine_kernel<DH><<<(unsigned)bh, DH, 0, s>>>(                  \
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,                      \
      (const __nv_bfloat16*)v_new, (const float*)part, (__nv_bfloat16*)out,      \
      n_split, scale)
  if (dh == 128 && packed4) {
    DSM_DA_LAUNCH(128, true);
  } else if (dh == 64 && packed4) {
    DSM_DA_LAUNCH(64, true);
  } else if (dh == 128) {
    DSM_DA_LAUNCH(128, false);
  } else if (dh == 64) {
    DSM_DA_LAUNCH(64, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DSM_DA_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
