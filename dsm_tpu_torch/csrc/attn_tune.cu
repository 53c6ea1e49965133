// Hopper (sm_90a) kernel of the decode-attention tuning tool.
//
//   dsm_attn_tune  <- tools/attn_kernel_tune.py:build_4d.call
//
// The variants of the T=1 decode attention over the COMMITTED 4-D int8 ring
// (dsm_tpu/ops/decode_attn.py:_decode_attend_q_4d) that the tuning tool
// times against the shipped kernel:
//
//   bb   batch rows one block works through, one after the other, for its
//        head: grid (B / bb) * H.  Numerics identical for every bb.
//   i8s  q is quantised per (b, h) row (qs = max(max|q| * fl(1/127), 1e-8),
//        qq = clip(round(q / qs), +-127)) and the scores are s8 x s8 -> s32
//        products (__dp4a) times ks_j * (qs * scale): no int8 -> f32
//        conversion of K.
//   i8p  p_j = e_j * vs_j is quantised per row of scores (pa = max(max_j p_j
//        * fl(1/127), 1e-12), pq = clip(round(p / pa), +-127): a second pass over
//        the scores in shared memory) and the V dot is taken in s32 (integer
//        multiply-adds), times pa.
//
// One span per (b, h), in the Pallas body's order:
//
//   row j is attended iff k_pos = pos - ((w - j) mod C) >= 0,
//   pos - k_pos < window, j != w (w = pos mod C) and valid[b, j].
//   s_j = (q . K_j) * (ks_j * scale), s_new = (q . k_new) * scale
//   m = max(max_j s_j, s_new), e_j = exp(s_j - m), e_new = exp(s_new - m)
//   out = (sum_j bf16(e_j vs_j) V_j + e_new v_new) / (sum_j e_j + e_new)
//
// with the two int8-dot substitutions above.  The quantisation of i8p needs
// the maximum over the whole row of scores before any V product, which is
// why this kernel keeps one span per (b, h): a split ring would make the
// scale span-local, another function than the whole-ring TPU variant's.
//
// What bounds it on the H100: bytes, as decode_attend: the int8 K and V
// rings once, 2 x B x H x C x Dh.  What the variants probe: fewer, longer
// blocks (bb), and integer dots in place of the conversions that the
// matrix-vector products spend their instruction slots on (i8s, i8p).  A lane
// loads 16 bytes of a row; masked rows are not read.  The mask, the unpack of
// a load and the block reductions are decode_attn.cu's (attn_common.cuh).
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): the
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using namespace dsm_attn;

constexpr int kAtThreads = kAttnThreads;
constexpr int kAtWarps = kAttnWarps;
// fl(1/127), the f32 reciprocal that XLA multiplies by where the jitted tool
// divides by 127.0 (tools/attn_kernel_tune.py); the plain version's too.
constexpr float kRecip127 = 0x1.020408p-7f;

// q, k_new, v_new, out: contiguous (B, H, DH) bf16; rings contiguous
// (B, H, C, DH) int8; scales contiguous (B, H, C) f32; valid (B, C) bytes.
template <int DH, bool I8S, bool I8P>
__global__ void __launch_bounds__(kAtThreads) attn_tune_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const uint8_t* __restrict__ valid,
    __nv_bfloat16* __restrict__ out, int h, int c, int bb, long long pos, int w,
    int window, float scale) {
  constexpr int LPR = DH / 16;   // lanes per ring row
  constexpr int RPW = 32 / LPR;  // ring rows per warp and step
  extern __shared__ float smem[];
  float* probs = smem;                               // c scores, then probs
  int* probs_i = reinterpret_cast<int*>(smem);       // i8p: the quantised probs
  float* red = smem + c;                             // kAtWarps * DH partial outputs
  int* red_i = reinterpret_cast<int*>(smem + c);
  __shared__ float warp_red[kAtWarps];

  const int bg = blockIdx.x / h;
  const int hh = blockIdx.x - bg * h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPR;   // which 16 values of the row
  const int rsub = lane / LPR;  // which row of the warp's step

  for (int bi = 0; bi < bb; ++bi) {
    const int b = bg * bb + bi;
    const int64_t bh = (int64_t)b * h + hh;
    const int8_t* kc = k_cache + bh * c * DH;
    const int8_t* vc = v_cache + bh * c * DH;
    const float* ks = k_scale + bh * c;
    const float* vs = v_scale + bh * c;
    const uint8_t* va = valid + (int64_t)b * c;

    // The lane's 16 values of q; every group of LPR lanes holds the row.
    float qf[16];
    float part_new = 0.f, amax = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      qf[e] = __bfloat162float(q[bh * DH + sub * 16 + e]);
      part_new += qf[e] * __bfloat162float(k_new[bh * DH + sub * 16 + e]);
      amax = fmaxf(amax, fabsf(qf[e]));
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      part_new += __shfl_xor_sync(0xffffffffu, part_new, o);
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s_new = part_new * scale;
    int qi[4] = {0, 0, 0, 0};
    float qs = 1.f;
    if constexpr (I8S) {
      qs = fmaxf(__fmul_rn(amax, kRecip127), 1e-8f);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int v = (int)fminf(fmaxf(rintf(qf[e] / qs), -127.f), 127.f);
        qi[e >> 2] |= (v & 0xff) << (8 * (e & 3));
      }
    }

    // Phase 1: scores of the attended rows; masked rows are not read.
    float local_max = -INFINITY;
    for (int j0 = warp * RPW; j0 < c; j0 += kAtWarps * RPW) {
      const int j = j0 + rsub;
      const bool ok = j < c && ring_row_attended(j, w, c, pos, window, va);
      float s = -INFINITY;
      if constexpr (I8S) {
        int acc = 0;
        if (ok) {
          const int4 kv = *reinterpret_cast<const int4*>(kc + (int64_t)j * DH + sub * 16);
          acc = __dp4a(kv.x, qi[0], acc);
          acc = __dp4a(kv.y, qi[1], acc);
          acc = __dp4a(kv.z, qi[2], acc);
          acc = __dp4a(kv.w, qi[3], acc);
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (ok) s = (float)acc * (ks[j] * (qs * scale));
      } else {
        float acc = 0.f;
        if (ok) {
          float kv[16];
          unpack_load(
              *reinterpret_cast<const int4*>(kc + (int64_t)j * DH + sub * 16), kv);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (ok) s = acc * (ks[j] * scale);
      }
      if (sub == 0 && j < c) probs[j] = s;
      local_max = fmaxf(local_max, s);
    }
    const float m = fmaxf(block_max(local_max, warp_red), s_new);  // finite: s_new is

    // Phase 2: exp, denominator, and p = e * vs: rounded to bf16 in place,
    // or (i8p) kept in f32 for the row's maximum, then quantised in place.
    float local_sum = 0.f, local_pmax = 0.f;
    for (int i = tid; i < c; i += kAtThreads) {
      const float s = probs[i];
      float p = 0.f;
      if (s != -INFINITY) {
        const float e = expf(s - m);
        local_sum += e;
        p = e * vs[i];
      }
      if constexpr (I8P) {
        local_pmax = fmaxf(local_pmax, fabsf(p));
        probs[i] = p;
      } else {
        probs[i] = __bfloat162float(__float2bfloat16(p));
      }
    }
    const float e_new = expf(s_new - m);
    const float denom = block_sum(local_sum, warp_red) + e_new;
    float pa = 1.f;
    if constexpr (I8P) {
      pa = fmaxf(__fmul_rn(block_max(local_pmax, warp_red), kRecip127), 1e-12f);
      for (int i = tid; i < c; i += kAtThreads)
        probs_i[i] = (int)fminf(fmaxf(rintf(probs[i] / pa), -127.f), 127.f);
      __syncthreads();
    }

    // Phase 3: probs times V; rows whose prob is 0 add nothing and are not read.
    if constexpr (I8P) {
      int acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0;
      for (int j0 = warp * RPW; j0 < c; j0 += kAtWarps * RPW) {
        const int j = j0 + rsub;
        if (j >= c) continue;
        const int p = probs_i[j];
        if (p == 0) continue;
        const int4 vv = *reinterpret_cast<const int4*>(vc + (int64_t)j * DH + sub * 16);
        const unsigned wd[4] = {(unsigned)vv.x, (unsigned)vv.y, (unsigned)vv.z,
                                (unsigned)vv.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += p * word_byte(wd[e >> 2], e & 3);
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      }
      if (rsub == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) red_i[warp * DH + sub * 16 + e] = acc[e];
      }
    } else {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      for (int j0 = warp * RPW; j0 < c; j0 += kAtWarps * RPW) {
        const int j = j0 + rsub;
        if (j >= c) continue;
        const float p = probs[j];
        if (p == 0.f) continue;
        float vv[16];
        unpack_load(*reinterpret_cast<const int4*>(vc + (int64_t)j * DH + sub * 16), vv);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += p * vv[e];
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      }
      if (rsub == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) red[warp * DH + sub * 16 + e] = acc[e];
      }
    }
    __syncthreads();

    // Phase 4: sum the warps' partials, add the fresh row, normalise.
    if (tid < DH) {
      float o;
      if constexpr (I8P) {
        int oi = 0;
#pragma unroll
        for (int i = 0; i < kAtWarps; ++i) oi += red_i[i * DH + tid];
        o = (float)oi * pa;
      } else {
        o = 0.f;
#pragma unroll
        for (int i = 0; i < kAtWarps; ++i) o += red[i * DH + tid];
      }
      o += e_new * __bfloat162float(v_new[bh * DH + tid]);
      out[bh * DH + tid] = __float2bfloat16(o / denom);
    }
    __syncthreads();  // the next batch row reuses the shared memory
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at ring length c.
long long dsm_attn_tune_smem_bytes(int c, int dh) {
  return (long long)(c + kAtWarps * dh) * (long long)sizeof(float);
}

// b a multiple of bb.  Returns a cudaError_t.
int dsm_attn_tune(const void* q, const void* k_cache, const void* v_cache,
                  const void* k_scale, const void* v_scale, const void* k_new,
                  const void* v_new, const void* valid, void* out, long long b,
                  int h, int c, int dh, int bb, int i8s, int i8p, long long pos,
                  int window, float scale, void* stream) {
  if (b == 0 || h == 0) return (int)cudaSuccess;
  if (bb < 1 || b % bb || c < 1 || pos < 0) return (int)cudaErrorInvalidValue;
  const int w = (int)(pos % c);
  const size_t smem = (size_t)dsm_attn_tune_smem_bytes(c, dh);
  const unsigned blocks = (unsigned)((b / bb) * h);
  cudaStream_t s = (cudaStream_t)stream;
#define DSM_AT_LAUNCH(DH, I8S, I8P)                                              \
  attn_tune_kernel<DH, I8S, I8P><<<blocks, kAtThreads, smem, s>>>(               \
      (const __nv_bfloat16*)q, (const int8_t*)k_cache, (const int8_t*)v_cache,   \
      (const float*)k_scale, (const float*)v_scale, (const __nv_bfloat16*)k_new, \
      (const __nv_bfloat16*)v_new, (const uint8_t*)valid, (__nv_bfloat16*)out,   \
      h, c, bb, pos, w, window, scale)
#define DSM_AT_VARIANTS(DH)                                    \
  if (i8s && i8p) {                                            \
    DSM_AT_LAUNCH(DH, true, true);                             \
  } else if (i8s) {                                            \
    DSM_AT_LAUNCH(DH, true, false);                            \
  } else if (i8p) {                                            \
    DSM_AT_LAUNCH(DH, false, true);                            \
  } else {                                                     \
    DSM_AT_LAUNCH(DH, false, false);                           \
  }
  if (dh == 128) {
    DSM_AT_VARIANTS(128)
  } else if (dh == 64) {
    DSM_AT_VARIANTS(64)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DSM_AT_VARIANTS
#undef DSM_AT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
