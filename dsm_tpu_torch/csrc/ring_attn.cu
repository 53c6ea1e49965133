// Hopper (sm_90a) kernels of the KV rings: the commits.
//
// Three kernels, each the counterpart of one Pallas TPU kernel:
//   dsm_ring_commit    <- dsm_tpu/ops/ring_kernels.py:_ring_commit
//   dsm_ring_commit_q  <- dsm_tpu/ops/ring_kernels.py:_ring_commit_q
//   dsm_scale_commit   <- dsm_tpu/ops/ring_kernels.py:_scale_commit
// The fused pipeline's attention, which commits its int8 row itself, is in
// decode_attn.cu (dsm_decode_attend_commit).
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py).  Each
// entry point launches on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Rings are updated in place.

#include <cuda_runtime.h>
#include <stdint.h>

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
                                     int c, int dw, int w) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
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

// int8 (or packed-int4 uint8) rings and rows, f32 scale rings and rows; dh
// is the row width in bytes (Dh, or Dh / 2 packed), a multiple of 4.
int dsm_ring_commit_q(void* k_cache, void* v_cache, void* ks_cache,
                      void* vs_cache, const void* k_new, const void* v_new,
                      const void* ks_new, const void* vs_new, long long b,
                      int h, int t, int c, int dh, int w, void* stream) {
  if (dh % 4) return (int)cudaErrorInvalidValue;
  const int64_t n_scales = (int64_t)b * h * t;
  const int64_t n_words = n_scales * (dh / 4);
  if (n_scales == 0) return (int)cudaSuccess;
  const dim3 grid(grid_for(n_words > n_scales ? n_words : n_scales), 3);
  ring_commit_q_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)k_cache, (uint32_t*)v_cache, (float*)ks_cache,
      (float*)vs_cache, (const uint32_t*)k_new, (const uint32_t*)v_new,
      (const float*)ks_new, (const float*)vs_new, n_words, n_scales, t, c,
      dh / 4, w);
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

}  // extern "C"
