// Hopper (sm_90a) kernels of the streaming STT serving step.
//
// Three kernels, each the counterpart of one Pallas TPU kernel:
//   dsm_ring_commit           <- dsm_tpu/ops/ring_kernels.py:_ring_commit
//   dsm_scale_commit          <- dsm_tpu/ops/ring_kernels.py:_scale_commit
//   dsm_decode_attend_commit  <- dsm_tpu/ops/decode_attn.py:_decode_attend_commit_q_4d
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py).  Each
// entry point launches on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Rings are updated in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;  // the JAX package's NEG_INF mask value
constexpr int kThreads = 256;     // threads per block of every kernel here
constexpr int kWarps = kThreads / 32;

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
                                   int64_t n, int t, int c, int dh, int w) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
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
                                    int64_t n, int t, int c, int w) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ti = (int)(i % t);
  const int64_t bh = i / t;
  const int64_t dst = bh * c + w + ti;
  if (blockIdx.y == 0) {
    ks_cache[dst] = ks_new[i];
  } else {
    vs_cache[dst] = vs_new[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// EPL int8 values at p (EPL = 2 or 4, aligned to EPL bytes) as floats.
template <int EPL>
__device__ __forceinline__ void load_i8(const int8_t* p, float* out) {
  if constexpr (EPL == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    out[0] = (float)v.x; out[1] = (float)v.y; out[2] = (float)v.z; out[3] = (float)v.w;
  } else {
    const char2 v = *reinterpret_cast<const char2*>(p);
    out[0] = (float)v.x; out[1] = (float)v.y;
  }
}

// ---------------------------------------------------------------------------
// Decode attention over the PRE-commit int8 ring, then commit of the fresh
// quantised row into ring row w.  One block of kThreads per (b, h).
//
//   row j of the ring holds the key at k_pos = pos - ((w - j) mod C); it is
//   attended iff k_pos >= 0, pos - k_pos < window, j != w and valid[b, j].
//   s_j   = (q . K_j) * (ks_j * scale)         (f32; masked rows -1e9)
//   s_new = (q . k_new) * scale                (f32, the fresh bf16 row)
//   m = max(max_j s_j, s_new); e = exp(s - m); denom = sum_j e_j + e_new
//   p_j = bf16(e_j * vs_j)                     (as the TPU kernel rounds)
//   out = (sum_j p_j V_j + e_new v_new) / denom   -> bf16
//
// Phase 1: warps take ring rows in turn; each lane holds DH/32 lanes of q in
// registers and reads DH/32 int8 of the row (one 128-byte load per warp and
// row at DH=128), the warp sums by shuffles.  Masked rows are not read.
// Scores live in shared memory (C floats).  Phase 2: exp and the bf16 probs
// in place, block sums.  Phase 3: warps take rows again and accumulate
// p_j * V_j into DH/32 registers per lane, skipping rows whose p_j is 0
// (adding 0 changes nothing).  Phase 4: the warps' partial outputs are summed
// through shared memory.  Phase 5: after the block's last ring read, row w
// gets the fresh int8 K/V row.  No other block touches this (b, h) slice and
// row w is masked from the read, so the in-place write is safe.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads) decode_attend_commit_kernel(
    const __nv_bfloat16* __restrict__ q,      // (B, H, DH)
    int8_t* __restrict__ k_cache,             // (B, H, C, DH)
    int8_t* __restrict__ v_cache,             // (B, H, C, DH)
    const float* __restrict__ k_scale,        // (B, H, C)
    const float* __restrict__ v_scale,        // (B, H, C)
    const int8_t* __restrict__ kq_new,        // (B, H, DH)
    const int8_t* __restrict__ vq_new,        // (B, H, DH)
    const __nv_bfloat16* __restrict__ k_new,  // (B, H, DH)
    const __nv_bfloat16* __restrict__ v_new,  // (B, H, DH)
    const uint8_t* __restrict__ valid,        // (B, C) bool
    __nv_bfloat16* __restrict__ out,          // (B, H, DH)
    int h, int c, long long pos, int w, int window, float scale) {
  constexpr int EPL = DH / 32;
  extern __shared__ float smem[];
  float* scores = smem;    // c floats: scores, then bf16-rounded probs
  float* red = smem + c;   // kWarps * DH floats: per-warp partial outputs
  __shared__ float warp_red[kWarps];

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int8_t* kc = k_cache + (int64_t)bh * c * DH;
  const int8_t* vc = v_cache + (int64_t)bh * c * DH;
  const float* ks = k_scale + (int64_t)bh * c;
  const float* vs = v_scale + (int64_t)bh * c;
  const uint8_t* va = valid + (int64_t)b * c;

  float qf[EPL];
  float kn[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qf[e] = __bfloat162float(q[(int64_t)bh * DH + lane * EPL + e]);
    kn[e] = __bfloat162float(k_new[(int64_t)bh * DH + lane * EPL + e]);
  }
  float s_new = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) s_new += qf[e] * kn[e];
  s_new = warp_sum(s_new) * scale;

  // Phase 1: ring scores.
  float local_max = kNegInf;
  for (int j = warp; j < c; j += kWarps) {
    int dist = (w - j) % c;
    if (dist < 0) dist += c;
    const long long k_pos = pos - dist;
    const bool ok = k_pos >= 0 && pos - k_pos < window && j != w && va[j] != 0;
    float s = kNegInf;
    if (ok) {  // uniform across the warp
      float kv[EPL];
      load_i8<EPL>(kc + (int64_t)j * DH + lane * EPL, kv);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc += qf[e] * kv[e];
      s = warp_sum(acc) * (ks[j] * scale);
    }
    if (lane == 0) scores[j] = s;
    local_max = fmaxf(local_max, s);
  }
  if (lane == 0) warp_red[warp] = local_max;
  __syncthreads();
  float m = s_new;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) m = fmaxf(m, warp_red[i]);
  __syncthreads();  // warp_red is reused below

  // Phase 2: exp, denominator, bf16-rounded probs (in place).
  float local_sum = 0.f;
  for (int j = tid; j < c; j += kThreads) {
    const float e = expf(scores[j] - m);
    local_sum += e;
    scores[j] = __bfloat162float(__float2bfloat16(e * vs[j]));
  }
  local_sum = warp_sum(local_sum);
  if (lane == 0) warp_red[warp] = local_sum;
  __syncthreads();
  float denom = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) denom += warp_red[i];
  const float e_new = expf(s_new - m);
  denom += e_new;

  // Phase 3: probs times V.
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int j = warp; j < c; j += kWarps) {
    const float p = scores[j];
    if (p == 0.f) continue;  // masked or underflowed: contributes exactly 0
    float vv[EPL];
    load_i8<EPL>(vc + (int64_t)j * DH + lane * EPL, vv);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += p * vv[e];
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) red[warp * DH + lane * EPL + e] = acc[e];
  __syncthreads();  // every ring read of this block is done past this point

  // Phase 4: sum the warps' partials, add the fresh row, normalise.
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) o += red[i * DH + tid];
    o += e_new * __bfloat162float(v_new[(int64_t)bh * DH + tid]);
    out[(int64_t)bh * DH + tid] = __float2bfloat16(o / denom);
    // Phase 5: commit the fresh quantised row into ring row w.
    k_cache[((int64_t)bh * c + w) * DH + tid] = kq_new[(int64_t)bh * DH + tid];
    v_cache[((int64_t)bh * c + w) * DH + tid] = vq_new[(int64_t)bh * DH + tid];
  }
}

inline unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* dsm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// elem_bytes: 2 (bf16) or 4 (f32).  Returns a cudaError_t.
int dsm_ring_commit(void* k_cache, void* v_cache, const void* k_new,
                    const void* v_new, int elem_bytes, long long b, int h,
                    int t, int c, int dh, int w, void* stream) {
  const int64_t n = (int64_t)b * h * t * dh;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n), 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    ring_commit_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        (uint16_t*)k_cache, (uint16_t*)v_cache, (const uint16_t*)k_new,
        (const uint16_t*)v_new, n, t, c, dh, w);
  } else if (elem_bytes == 4) {
    ring_commit_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        (uint32_t*)k_cache, (uint32_t*)v_cache, (const uint32_t*)k_new,
        (const uint32_t*)v_new, n, t, c, dh, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dsm_scale_commit(void* ks_cache, void* vs_cache, const void* ks_new,
                     const void* vs_new, long long b, int h, int t, int c,
                     int w, void* stream) {
  const int64_t n = (int64_t)b * h * t;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n), 2);
  scale_commit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)ks_cache, (float*)vs_cache, (const float*)ks_new,
      (const float*)vs_new, n, t, c, w);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the attention kernel needs at ring length c.
long long dsm_decode_attend_smem_bytes(int c, int dh) {
  return (long long)(c + kWarps * dh) * (long long)sizeof(float);
}

int dsm_decode_attend_commit(const void* q, void* k_cache, void* v_cache,
                             const void* k_scale, const void* v_scale,
                             const void* kq_new, const void* vq_new,
                             const void* k_new, const void* v_new,
                             const void* valid, void* out, long long b, int h,
                             int c, int dh, long long pos, int w, int window,
                             float scale, void* stream) {
  const long long blocks = b * h;
  if (blocks == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)dsm_decode_attend_smem_bytes(c, dh);
  cudaStream_t s = (cudaStream_t)stream;
#define DSM_LAUNCH(DH)                                                        \
  decode_attend_commit_kernel<DH><<<(unsigned)blocks, kThreads, smem, s>>>(   \
      (const __nv_bfloat16*)q, (int8_t*)k_cache, (int8_t*)v_cache,            \
      (const float*)k_scale, (const float*)v_scale, (const int8_t*)kq_new,    \
      (const int8_t*)vq_new, (const __nv_bfloat16*)k_new,                     \
      (const __nv_bfloat16*)v_new, (const uint8_t*)valid,                     \
      (__nv_bfloat16*)out, h, c, pos, w, window, scale)
  if (dh == 128) {
    DSM_LAUNCH(128);
  } else if (dh == 64) {
    DSM_LAUNCH(64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DSM_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
