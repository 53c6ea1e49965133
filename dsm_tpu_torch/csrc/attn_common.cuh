// Device helpers shared by the decode-attention kernels over a K/V ring
// (decode_attn.cu; attn_tune.cu: dsm_attn_tune): the ring mask, the unpack
// of a lane's 16-byte load of a ring row, the warp reductions, and the block
// reductions of attn_tune.cu's blocks of kAttnThreads threads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dsm_attn {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;

// Ring row j holds the key at k_pos = pos - ((w - j) mod C), w = pos mod C.
// It is attended iff k_pos >= 0, pos - k_pos < window, j != w (this step's
// committed row) and valid_row[j].  (w - j) mod C: C's % truncates, so C is
// added back.
__device__ __forceinline__ bool ring_row_attended(int j, int w, int c, long long pos,
                                                  int window, const uint8_t* valid_row) {
  int dist = w - j;
  if (dist < 0) dist += c;
  return dist != 0 && (long long)dist <= pos && dist < window && valid_row[j] != 0;
}

// Byte b (0..3) of a word as a signed int8 value.
__device__ __forceinline__ int word_byte(unsigned u, int b) {
  return (int)(u << (24 - 8 * b)) >> 24;
}

// The 16 int8 values of one 16-byte load as floats, in memory order.
__device__ __forceinline__ void unpack_load(const int4 v, float* out) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = (float)word_byte((unsigned)w[i], b);
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

// Maximum (sum) over the block's kAttnThreads values, the same in every
// thread; the warps' results are folded in warp order.  warp_red: kAttnWarps
// floats of shared memory, free again when the call returns.
__device__ __forceinline__ float block_max(float v, float* warp_red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) warp_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = warp_red[0];
#pragma unroll
  for (int i = 1; i < kAttnWarps; ++i) m = fmaxf(m, warp_red[i]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* warp_red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kAttnWarps; ++i) s += warp_red[i];
  __syncthreads();
  return s;
}

}  // namespace dsm_attn
