// Hopper (sm_90a) kernel of the weight-only int8 (W8A16) matmul.
//
//   dsm_qmm  <- dsm_tpu/ops/qmm.py:_qmm
//
//   out[m, o] = bf16( (sum_k x[m, k] * float(wq[o, k])) * s[o] )
//
// x (M, I) bf16, wq (O, I) int8 with a row stride, s (O,) f32.  The int8
// weight becomes bf16 exactly, the products are accumulated in f32 over the
// whole of I, the sum is scaled in f32 and rounded once.
//
// What bounds it on the H100: bytes, if the tensor cores are used.  At the
// stt-2.6b serving shapes (M = 64) a call reads O*I bytes of weights (4 to
// 23 MB, 1.3 to 6.9 us at 3.35 TB/s) and does 128 FLOP per weight byte: at
// the byte bound that is 429 TFLOP/s, 43 % of the bf16 tensor-core peak and
// six times what the f32 pipes give.  So the products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 out) and the int8 -> bf16 step stays
// in registers: the weight is read once, as int8, and no bf16 copy of it ever
// exists in memory.
//
// What the design does about it.  A block of 8 warps owns 64 output channels
// and up to 64 rows of x.  The weights are the A operand (16 channels x 16 k),
// x the B operand (16 k x 8 rows), so a warp's accumulators are out^T.  Warps
// are 2 channel groups (32 channels = two A tiles) x 4 K groups: each K group
// takes its own 64 of every 256 staged k, so the block splits K four ways
// inside itself and sums the four partial tiles in shared memory in a fixed
// order.  Both operands are staged by cp.async, 256 k at a time (64 weight
// rows and up to 64 rows of x: 54 KB a stage), four stages deep (217 KB of
// dynamic shared memory at 64 rows): with one chunk in flight a step took as
// long as a round trip to memory, whatever the arithmetic cost.  A lane reads
// 16 consecutive int8 of a weight row (one 16-byte load); those 16 k feed 4
// MMAs, 4 k each.  The MMA's k order inside a tile is free as long as A and B
// agree, so B is read at the same 16 k (two 16-byte loads a lane).  Staged
// rows are padded (x by 16 bytes, weights by 64) so that the lanes of a
// 16-byte load hit distinct banks.  M is served in
// tiles of 8, 16, 32 or 64 rows (a template parameter), rows past M are zero
// filled, channels past O and k past I are guarded (I is a multiple of 16).
//
// O = 2048 gives 32 blocks for 132 SMs, so K is also split across blocks
// (grid.y = ksplit, chosen by the caller): each split writes an f32 partial
// (ksplit, M, O) and a second small kernel folds them in order, scales and
// rounds.  No atomics anywhere: repeated runs are bit-identical.  With
// ksplit = 1 the first kernel scales, rounds and writes the output itself.
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): the
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes the partials' scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQmThreads = 256;                   // 2 channel groups x 4 K groups
constexpr int kQmTileO = 64;                      // output channels per block
constexpr int kQmChunkK = 256;                    // k staged per step, 64 per K group
constexpr int kQmRowBytes = kQmChunkK * 2 + 16;   // one staged row of x, padded
constexpr int kQmWRowBytes = kQmChunkK + 64;      // one staged row of weights, padded
constexpr int kQmStages = 4;                      // chunks in flight or in use

__device__ __forceinline__ void qm_cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void qm_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void qm_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four int8 of one 32-bit word -> two bf16 pairs (bytes 0,1 and bytes 2,3),
// exactly: byte ^ 0x80 is the value + 128 as an unsigned byte, placed in the
// mantissa of 2^23 and freed of 2^23 + 128 by one f32 subtraction.
__device__ __forceinline__ void qm_cvt4(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<const unsigned*>(&a);
  hi = *reinterpret_cast<const unsigned*>(&b);
}

__device__ __forceinline__ void qm_mma(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (ceil(O / 64), ksplit, ceil(M / 64)); NT = x rows of the tile / 8.
// Split `blockIdx.y` takes chunks [y * chunks_per_split, (y + 1) *
// chunks_per_split) of the ceil(I / 256) chunks of K.  part is (ksplit, M, O)
// f32 and is written only when ksplit > 1; else out (M, O) bf16 is.
template <int NT>
__global__ void __launch_bounds__(kQmThreads) qmm_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ s, float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int m, int o, int i, long long ldw,
    int chunks_per_split, int ksplit) {
  constexpr int R = 8 * NT;
  constexpr int XBUF = R * kQmRowBytes;
  constexpr int BUF = XBUF + kQmTileO * kQmWRowBytes;  // one stage: x, then weights
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // MMA group: A row, B column
  const int t = lane & 3;    // thread in group: which 16 k of the warp's 64
  const int rg = warp & 1;   // channel group: 32 of the block's 64 channels
  const int kg = warp >> 1;  // K group: 64 of every 256 staged k
  const int o0 = blockIdx.x * kQmTileO;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 64;

  const int n_chunks = (i + kQmChunkK - 1) / kQmChunkK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  // One chunk of x (R rows x 256 k, rows past M and k past I zero filled) and
  // of the weights (64 channels x 256 k, the same guards) into stage `slot`.
  auto stage = [&](int c, int slot) {
    unsigned char* base = smem + slot * BUF;
    const int k0 = c * kQmChunkK;
    {
      const int seg = tid & 31;  // 16 bytes = 8 k of a row of x
#pragma unroll
      for (int it = 0; it < NT; ++it) {
        const int row = (tid >> 5) + 8 * it;
        const bool ok = (m0 + row < m) && (k0 + seg * 8 + 8 <= i);
        const __nv_bfloat16* src = ok ? x + (long long)(m0 + row) * i + k0 + seg * 8 : x;
        qm_cp_async16(base + row * kQmRowBytes + seg * 16, src, ok ? 16 : 0);
      }
    }
    {
      const int seg = tid & 15;  // 16 bytes = 16 k of a weight row
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int row = (tid >> 4) + 16 * it;
        const bool ok = (o0 + row < o) && (k0 + seg * 16 + 16 <= i);
        const int8_t* src = ok ? wq + (long long)(o0 + row) * ldw + k0 + seg * 16 : wq;
        qm_cp_async16(base + XBUF + row * kQmWRowBytes + seg * 16, src, ok ? 16 : 0);
      }
    }
  };

  // kQmStages - 1 chunks are on their way while one is computed.  A group is
  // committed every step, empty past the last chunk, so that "all but the
  // newest kQmStages - 2 groups" always means "this step's chunk has landed".
#pragma unroll
  for (int st = 0; st < kQmStages - 1; ++st) {
    if (c_begin + st < c_end) stage(c_begin + st, st);
    qm_cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int slot = (c - c_begin) % kQmStages;
    qm_cp_async_wait<kQmStages - 2>();
    __syncthreads();  // the chunk is visible to all; the stage computed last step is free
    if (c + kQmStages - 1 < c_end) {
      stage(c + kQmStages - 1, (c - c_begin + kQmStages - 1) % kQmStages);
    }
    qm_cp_async_commit();

    // The lane's 16 k of its four weight rows: g, g + 8 (A tile 0), g + 16,
    // g + 24 (tile 1).
    int4 wcur[4];
    const unsigned char* wb =
        smem + slot * BUF + XBUF + (rg * 32 + g) * kQmWRowBytes + kg * 64 + t * 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wcur[r] = *reinterpret_cast<const int4*>(wb + 8 * r * kQmWRowBytes);
    }

    // Two passes, each over 8 of the lane's 16 k (one 16-byte load of x a
    // row): a[tile][jj] holds the A registers of MMA j = 2 * half + jj (k
    // bytes 4j .. 4j+3): {row g: k 0,1}, {row g+8: k 0,1}, {row g: k 2,3},
    // {row g+8: k 2,3}.  The MMAs of a pass go round NG x 2 accumulators, so
    // that no MMA waits for the one before it.
    constexpr int NG = NT < 4 ? NT : 4;
    const unsigned char* xb = smem + slot * BUF + g * kQmRowBytes + kg * 128 + t * 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned a[2][2][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        const int4 lo = wcur[2 * tile], hi = wcur[2 * tile + 1];
        const unsigned lo0 = (unsigned)(half ? lo.z : lo.x), lo1 = (unsigned)(half ? lo.w : lo.y);
        const unsigned hi0 = (unsigned)(half ? hi.z : hi.x), hi1 = (unsigned)(half ? hi.w : hi.y);
        qm_cvt4(lo0, a[tile][0][0], a[tile][0][2]);
        qm_cvt4(hi0, a[tile][0][1], a[tile][0][3]);
        qm_cvt4(lo1, a[tile][1][0], a[tile][1][2]);
        qm_cvt4(hi1, a[tile][1][1], a[tile][1][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        uint4 b[NG];
#pragma unroll
        for (int nn = 0; nn < NG; ++nn) {
          b[nn] = *reinterpret_cast<const uint4*>(xb + (n0 + nn) * 8 * kQmRowBytes + half * 16);
        }
#pragma unroll
        for (int nn = 0; nn < NG; ++nn) {
#pragma unroll
          for (int tile = 0; tile < 2; ++tile) qm_mma(acc[tile][n0 + nn], a[tile][0], b[nn].x, b[nn].y);
        }
#pragma unroll
        for (int nn = 0; nn < NG; ++nn) {
#pragma unroll
          for (int tile = 0; tile < 2; ++tile) qm_mma(acc[tile][n0 + nn], a[tile][1], b[nn].z, b[nn].w);
        }
      }
    }
  }
  qm_cp_async_wait<0>();
  __syncthreads();  // every warp has read its last stage

  // The four K groups' tiles, summed in K-group order: red[kg][channel][row].
  float* red = reinterpret_cast<float*>(smem);
  constexpr int LD = R + 1;
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int ol = rg * 32 + tile * 16 + g;
      const int ml = n * 8 + 2 * t;
      float* p = red + (kg * kQmTileO + ol) * LD + ml;
      p[0] = acc[tile][n][0];
      p[1] = acc[tile][n][1];
      p[8 * LD] = acc[tile][n][2];
      p[8 * LD + 1] = acc[tile][n][3];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kQmTileO * R; idx += kQmThreads) {
    const int ol = idx & (kQmTileO - 1);
    const int ml = idx / kQmTileO;
    const int oo = o0 + ol;
    const int mm = m0 + ml;
    if (oo >= o || mm >= m) continue;
    float v = red[ol * LD + ml];
#pragma unroll
    for (int k = 1; k < 4; ++k) v += red[(k * kQmTileO + ol) * LD + ml];
    if (ksplit == 1) {
      out[(long long)mm * o + oo] = __float2bfloat16(v * s[oo]);
    } else {
      part[((long long)split * m + mm) * o + oo] = v;
    }
  }
}

// out[idx] = bf16((part[0][idx] + part[1][idx] + ...) * s[idx % o]), in order.
__global__ void __launch_bounds__(256) qmm_fold_kernel(
    const float* __restrict__ part, const float* __restrict__ s,
    __nv_bfloat16* __restrict__ out, long long mo, int o, int ksplit) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= mo) return;
  float v = part[idx];
  for (int k = 1; k < ksplit; ++k) v += part[(long long)k * mo + idx];
  out[idx] = __float2bfloat16(v * s[idx % o]);
}

template <int NT>
size_t qmm_smem_bytes() {
  constexpr size_t stage =
      kQmStages * ((size_t)(8 * NT) * kQmRowBytes + (size_t)kQmTileO * kQmWRowBytes);
  constexpr size_t red = 4 * (size_t)kQmTileO * (8 * NT + 1) * sizeof(float);
  return stage > red ? stage : red;
}

template <int NT>
cudaError_t qmm_launch(const void* x, const void* wq, const void* s, void* part,
                       void* out, long long m, int o, int i, long long ldw,
                       int ksplit, int chunks_per_split, cudaStream_t stream) {
  const size_t smem = qmm_smem_bytes<NT>();
  if (smem > 48 * 1024) {
    static bool opted_in = false;  // the attribute is per function, set once
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          qmm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
  }
  const dim3 grid((unsigned)((o + kQmTileO - 1) / kQmTileO), (unsigned)ksplit,
                  (unsigned)((m + 63) / 64));
  qmm_kernel<NT><<<grid, kQmThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)s, (float*)part,
      (__nv_bfloat16*)out, (int)m, o, i, ldw, chunks_per_split, ksplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, i) bf16 contiguous; wq int8, row r at wq + r * ldw; s (o,) f32; part:
// f32 scratch of ksplit * m * o values (unused when ksplit == 1); out (m, o)
// bf16.  ksplit * chunks_per_split must cover the ceil(i / 256) chunks of K.
// Returns a cudaError_t.
int dsm_qmm(const void* x, const void* wq, const void* s, void* part, void* out,
            long long m, int o, int i, long long ldw, int ksplit,
            int chunks_per_split, void* stream) {
  if (m == 0 || o == 0) return (int)cudaSuccess;
  const int n_chunks = (i + kQmChunkK - 1) / kQmChunkK;
  if (m < 0 || m > 64LL * 65535 || o < 0 || i < 16 || i % 16 || ldw < i || ldw % 16 ||
      ksplit < 1 || ksplit > 65535 || chunks_per_split < 1 ||
      (long long)ksplit * chunks_per_split < n_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (m <= 8) {
    err = qmm_launch<1>(x, wq, s, part, out, m, o, i, ldw, ksplit, chunks_per_split, st);
  } else if (m <= 16) {
    err = qmm_launch<2>(x, wq, s, part, out, m, o, i, ldw, ksplit, chunks_per_split, st);
  } else if (m <= 32) {
    err = qmm_launch<4>(x, wq, s, part, out, m, o, i, ldw, ksplit, chunks_per_split, st);
  } else {
    err = qmm_launch<8>(x, wq, s, part, out, m, o, i, ldw, ksplit, chunks_per_split, st);
  }
  if (err != cudaSuccess) return (int)err;
  if (ksplit > 1) {
    const long long mo = m * (long long)o;
    qmm_fold_kernel<<<(unsigned)((mo + 255) / 256), 256, 0, st>>>(
        (const float*)part, (const float*)s, (__nv_bfloat16*)out, mo, o, ksplit);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
