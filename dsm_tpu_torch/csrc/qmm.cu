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
// What bounds it on the H100: bytes, if the tensor cores keep up.  At the
// stt-2.6b serving shapes (M = 64) a call reads O*I bytes of weights (4 to
// 23 MB, 1.3 to 6.9 us at 3.35 TB/s) and does 128 FLOP per weight byte, 429
// TFLOP/s at the byte bound: mma.sync, whose rate on this card is about half
// of wgmma's, set the pace of the first versions of this kernel (a build
// without its MMAs ran 19-32 % faster).  The measurements quoted here were
// taken on an NVIDIA H100 80GB HBM3 at 700 W with
// dsm_tpu_torch/tools/qmm_variants.py.  The serving step streams some
// 2.5 GB of distinct weights, so every call finds its weight cold in device
// memory: what counts is that the grid keeps bytes in flight on every SM it
// holds, and how little of a call is set-up and hand-over around them.
//
// What the design does about it.
// - A block owns 128 output channels and R = 8 * NT rows of x (NT = 1, 2,
//   4, 8).  One copy warp keeps a ring of shared-memory stages
//   full with TMA tile copies through two tensor maps (tma_common.cuh): a
//   stage is 128 k of the 128 weight rows (one box of 16 KB) and of the
//   R rows of x (two boxes of 64 k), all with the 128-byte swizzle.  (One
//   bulk copy per row, 192 to 320 a stage, ran at some 36 ns a copy per SM:
//   the number of copies, not the bytes, set the pace.)  Two consumer
//   warpgroups wait on a stage's "full" mbarrier and release it on its
//   "empty" one; no __syncthreads in the K loop, and a wait that outlasts
//   2^28 polls traps.
// - x is read from L2 once per block and K range: 2 * R / 128 bytes of x per
//   weight byte, 1.0 at R = 64.  (A tile of 256 channels halved that and ran
//   slower: its wgmmas serialized.)
// - The products run on wgmma (m64nRk16, bf16 in, f32 out): the weights are
//   the A operand, from registers, x the B operand, straight from its
//   swizzled box in shared memory through a descriptor.  A warpgroup owns
//   64 channels; a lane of warp w builds the A fragment of
//   rows 16 w + g, 16 w + g + 8 and k 2t, 2t + 1, 2t + 8, 2t + 9 of each 16
//   k from two 32-bit loads and a byte permute, and makes the int8 bf16 in
//   registers (qm_cvt4, exact).  A stage's 8 wgmmas are one group, issued
//   while the next stage is converted; the group before is awaited and its
//   stage released after (A fragments double-buffered).
// - K is split over the KS blocks of a thread-block cluster (grid (ceil(O /
//   128), KS, ceil(M / R)), cluster (1, KS, 1), KS <= 8): cluster rank r takes
//   chunks [r * n / KS, (r + 1) * n / KS) of the n = ceil(I / 128) chunks of
//   K.  With KS = 1 the warpgroups scale, round and write from registers.
//   Else each block stages its partial tile in its shared memory; rank q
//   owns the output rows [q * M' / KS, (q + 1) * M' / KS) of the tile (M'
//   its valid rows), and every other rank sends q its partial of those rows
//   by one bulk copy into q's shared memory (a slot per sender, completing
//   on q's mbarrier).  q sums, for each element, the ranks' partials in rank
//   order, then scales, rounds and writes.  Two cluster barriers, each split
//   so that the work between its arrive and its wait hides it: the first
//   (barriers initialised) before any copy to a partner, the second (every
//   copy landed) before a block may leave.  One launch a call, no scratch
//   in device memory, no atomics: repeated runs are bit-identical.  (Pulling
//   the partners' partials with loads through distributed shared memory
//   cost 2.5-3 us a call at M = 64; storing them with st.async per element
//   cost more.)  The caller picks KS (qmm.qmm_tiling) so that the
//   grid runs in one wave of the clusters the card holds at once: a
//   cluster's blocks share a GPC, and on that H100 only 15 clusters of 8
//   (120 blocks), 17 of 6 or 30 of 4 fit at once.
// - An ordinary launch.  (With programmatic stream serialization and the
//   first stages' weights copied before the kernel ahead had finished, a
//   call queued behind another kernel took 0.8-1.6 us less, but the
//   host-bound serving step, whose device idles between launches, ran its
//   qmm kernels no faster: the head start is left for a step replayed as a
//   CUDA graph, where kernels do run back to back.)
// - M is served in tiles of 8, 16, 32 or 64 rows (a template parameter);
//   rows past M and channels past O are copied as zeros and never written,
//   and past I both boxes hold zeros, so every k16 block runs.
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): the
// entry point encodes the two tensor maps on the host (cuTensorMapEncodeTiled,
// found through cudaGetDriverEntryPoint: no -lcuda), launches on the caller's
// stream, does not synchronise, allocates nothing and returns a cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "tma_common.cuh"

namespace {

using namespace dsm_tma;

constexpr int kQmTileO = 128;                        // output channels a block owns
constexpr int kQmConsumers = 8;                      // warps that compute: two warpgroups
constexpr int kQmThreads = 32 * (kQmConsumers + 1);  // and one warp that copies
constexpr int kQmChunkK = 128;                       // k a stage holds
constexpr int kQmMaxStages = 4;                      // stages (deeper rings ran 2-6 % slower)
constexpr int kQmMaxSplit = 8;                       // blocks of a cluster (portable size)
constexpr int kQmSmemCap = 232448;                   // an H100 block's shared memory
// The variants tool's "timeline" build sets this: thread 0 of each block
// notes clock64() at 8 marks (entry, set up, first stage landed, K done,
// partial staged or output written, sent, received, end), then the global
// timer at entry and end, and writes them over the output (10 int64 a
// block) in place of the results.
constexpr bool kQmTimeline = false;

// Dynamic shared memory of a block, from a 1024-byte aligned base (the
// swizzle's period): the stages (x's two boxes of R rows x 128 bytes, then
// the weights' box of TO rows x 128 bytes), overlaid after the K loop by the
// block's partial tile; the partners' partials of this rank's output rows;
// the barriers.
template <int NT>
struct QmLayout {
  static constexpr int R = 8 * NT;                  // rows of x of the tile
  static constexpr int TO = kQmTileO;
  static constexpr int kXBox = R * 128;             // 64 k of R rows of x
  static constexpr int kW = 2 * kXBox;              // the weights' box
  static constexpr int kStage = kW + TO * 128;
  static constexpr int LDO = TO + 4;                // a partial row of TO channels
  static constexpr int kPart = R * LDO * 4;         // the block's partial: [row][channel]
  static constexpr int kRecv = (R + kQmMaxSplit) * LDO * 4;  // [rank][row of mine][channel]
  static constexpr int kBars = (2 * kQmMaxStages + 1) * 8;
  static constexpr int S0 = (kQmSmemCap - 1024 - kRecv - kBars) / kStage;
  static constexpr int S = S0 < kQmMaxStages ? S0 : kQmMaxStages;
  static constexpr int kRecvOff = S * kStage > kPart ? S * kStage : kPart;
  static constexpr int kBarOff = kRecvOff + kRecv;
  static constexpr int kBytes = 1024 + kBarOff + (2 * S + 1) * 8;  // with room to align
  static_assert(S >= 2 && kBytes <= kQmSmemCap, "shared memory");
};

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

// wgmma m64nNk16, bf16 in, f32 accumulated in d: A (64 channels x 16 k)
// from registers, B (N rows of x x 16 k) from shared memory through `desc`.
template <int N>
struct QmWgmma;

template <>
struct QmWgmma<8> {
  __device__ __forceinline__ static void mma(float* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct QmWgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct QmWgmma<32> {
  __device__ __forceinline__ static void mma(float* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct QmWgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,  "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma fence, commit or wait.
__device__ __forceinline__ void wg_hold(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// The shared-memory descriptor of a K-major box of 128-byte rows with the
// 128-byte swizzle (8-row atoms 1024 bytes apart), starting at `p`.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Grid (ceil(O / TO), ksplit, ceil(M / R)), cluster (1, ksplit, 1): the
// block's cluster rank is blockIdx.y.  wmap: the weights, boxes of 128 k x 128
// rows; xmap: x, boxes of 64 k x R rows; both with the 128-byte swizzle.
template <int NT>
__global__ void __launch_bounds__(kQmThreads, 1) qmm_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int m, int o, int i,
    int ksplit) {
  using L = QmLayout<NT>;
  constexpr int R = L::R;
  constexpr int TO = L::TO;
  extern __shared__ __align__(1024) unsigned char qm_smem_raw[];
  unsigned char* qm_smem = qm_smem_raw + ((1024 - (smem_u32(qm_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(qm_smem + L::kBarOff);
  uint64_t* empty = full + L::S;
  uint64_t* recv_bar = empty + L::S;
  float* part = reinterpret_cast<float*>(qm_smem);
  float* recv = reinterpret_cast<float*>(qm_smem + L::kRecvOff);

  long long marks[10] = {kQmTimeline ? clock64() : 0};
  if (kQmTimeline) marks[8] = globaltimer();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int o0 = blockIdx.x * TO;
  const int rank = blockIdx.y;
  const int m0 = blockIdx.z * R;
  const int rows_o = min(TO, o - o0);
  const int rows_x = min(R, m - m0);
  // This rank's share of the n = ceil(I / 128) chunks of K, from k_begin.
  // (Splitting at 16 k for balance cost more: each rank's last box then
  // overlapped the next rank's k, and those bytes were read twice.)
  const int n_chunks = (i + kQmChunkK - 1) / kQmChunkK;
  const int c_begin = (int)((long long)rank * n_chunks / ksplit);
  const int n_mine = (int)((long long)(rank + 1) * n_chunks / ksplit) - c_begin;
  const int k_begin = c_begin * kQmChunkK;
  // The output rows this rank sums, scales and writes, and the rows of a
  // partner's slot in recv.
  const int row_lo = rank * rows_x / ksplit;
  const int row_hi = (rank + 1) * rows_x / ksplit;
  const int slot_rows = (R + ksplit - 1) / ksplit;

  if (tid == 0) {
    for (int st = 0; st < L::S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kQmConsumers);
    }
    mbar_init(recv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // The partners' partials of this rank's rows complete on recv_bar.
    mbar_arrive_expect_tx(recv_bar, (uint32_t)((ksplit - 1) * (row_hi - row_lo) * L::LDO * 4));
  }
  __syncthreads();
  if (ksplit > 1) cluster_arrive_relaxed();  // waited for before the first copy to a partner
  auto mark = [&](int j) {
    if (kQmTimeline) marks[j] = clock64();
  };
  auto write_marks = [&]() {
    if (kQmTimeline && tid == 0) {
      long long* dst = reinterpret_cast<long long*>(out) +
                       10 * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));
      for (int j = 1; j < 8; ++j) marks[j] = max(marks[j], marks[j - 1]);
      marks[9] = globaltimer();
      for (int j = 0; j < 10; ++j) dst[j] = marks[j];
    }
  };
  mark(1);

  if (warp == kQmConsumers) {
    // The copy warp: one lane waits for the stage, announces its bytes and
    // copies the weights' box and x's two boxes (zero filled past I, the
    // second wholly so when the last chunk holds 64 k or fewer).
    if (lane == 0) {
      prefetch_tensor_map(&wmap);
      prefetch_tensor_map(&xmap);
      for (int c = 0; c < n_mine; ++c) {
        const int st = c % L::S;
        mbar_wait(&empty[st], ((c / L::S) & 1) ^ 1);  // the first round passes
        mbar_arrive_expect_tx(&full[st], (uint32_t)L::kStage);
        unsigned char* stage = qm_smem + st * L::kStage;
        tile_copy_2d(stage + L::kW, &wmap, k_begin + c * kQmChunkK, o0, &full[st]);
        for (int b = 0; b < 2; ++b)
          tile_copy_2d(stage + b * L::kXBox, &xmap, k_begin + c * kQmChunkK + 64 * b, m0,
                       &full[st]);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns channels [64 wg, 64 wg + 64) of the
  // tile; warp wq of the warpgroup holds rows 16 wq + g and 16 wq + g + 8.
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const unsigned sel = (t & 1) ? 0x7632u : 0x5410u;
  float acc[R / 2];
#pragma unroll
  for (int e = 0; e < R / 2; ++e) acc[e] = 0.f;

  // A stage's weights into A fragments: for k16 block j and rows r, r + 8,
  // k 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3), the 16-bit halves t
  // of the block's two 8-byte halves, made bf16.
  auto convert = [&](const unsigned char* base, unsigned (&a)[8][4]) {
    const unsigned char* wb = base + L::kW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* row = wb + (wg * 64 + 16 * wq + 8 * h + g) * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* piece = row + ((j ^ g) << 4) + 4 * (t >> 1);
        const unsigned w = __byte_perm(*reinterpret_cast<const unsigned*>(piece),
                                       *reinterpret_cast<const unsigned*>(piece + 8), sel);
        qm_cvt4(w, a[j][h], a[j][2 + h]);
      }
    }
  };
  // The stage's products into acc, asynchronously (one wgmma group).  Past
  // I both boxes hold zeros (the copies zero fill what lies outside x and
  // the weights), so every k16 block runs.
  auto issue = [&](const unsigned char* base, const unsigned (&a)[8][4]) {
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t desc = wg_desc(base + (j >> 2) * L::kXBox) + 2 * (j & 3);
      QmWgmma<R>::mma(acc, a[j], desc);
    }
    wg_commit();
  };
  auto release = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[c % L::S]);
  };
  // Chunk c: its A fragments (in the buffer chunk c - 2 used, whose products
  // are done), its products issued, then chunk c - 1's awaited and its stage
  // released: one group of products runs while the next chunk is converted.
  auto step = [&](int c, unsigned (&a)[8][4]) {
    const int st = c % L::S;
    mbar_wait(&full[st], (c / L::S) & 1);
    if (c == 0) mark(2);
    const unsigned char* base = qm_smem + st * L::kStage;
    convert(base, a);
    issue(base, a);
    if (c > 0) {
      wg_wait_1();
      release(c - 1);
    }
  };
#pragma unroll
  for (int e = 0; e < R / 2; ++e) wg_hold(acc[e]);
  {
    unsigned a0[8][4], a1[8][4];
    for (int c = 0; c < n_mine; c += 2) {
      step(c, a0);
      if (c + 1 < n_mine) step(c + 1, a1);
    }
  }
  wg_wait_all();
  release(n_mine - 1);
#pragma unroll
  for (int e = 0; e < R / 2; ++e) wg_hold(acc[e]);
  mark(3);

  // Element e of acc for n8 block nb = e / 4: row ml = 8 nb + 2t + (e & 1)
  // of x, channel ol = 64 wg + 16 wq + g + 8 ((e >> 1) & 1).
  if (ksplit == 1) {
#pragma unroll
    for (int idx = 0; idx < R / 2; ++idx) {
      const int ml = 8 * (idx >> 2) + 2 * t + (idx & 1);
      const int ol = wg * 64 + 16 * wq + g + 8 * ((idx >> 1) & 1);
      if (!kQmTimeline && ml < rows_x && ol < rows_o) {
        out[(long long)(m0 + ml) * o + o0 + ol] = __float2bfloat16(acc[idx] * s[o0 + ol]);
      }
    }
    mark(4);
    write_marks();
    return;
  }

  // The block's partial into part (over the stages, once every consumer is
  // done with them), then each partner q gets its rows by one bulk copy into
  // q's slot for this rank, completing on q's recv_bar.
  constexpr int kCons = 32 * kQmConsumers;
  bar_sync_1(kCons);
#pragma unroll
  for (int idx = 0; idx < R / 2; ++idx) {
    const int ml = 8 * (idx >> 2) + 2 * t + (idx & 1);
    const int ol = wg * 64 + 16 * wq + g + 8 * ((idx >> 1) & 1);
    part[ml * L::LDO + ol] = acc[idx];
  }
  fence_proxy_async_smem();  // the bulk copies below read what the threads wrote
  bar_sync_1(kCons);
  mark(4);
  cluster_wait();  // every partner's barrier is initialised
  if (tid < ksplit && tid != rank) {
    const int q_lo = tid * rows_x / ksplit;
    const int q_rows = (tid + 1) * rows_x / ksplit - q_lo;
    if (q_rows > 0) {
      bulk_copy_to_peer(cluster_addr(recv + rank * slot_rows * L::LDO, tid),
                        part + q_lo * L::LDO, (uint32_t)(q_rows * L::LDO * 4),
                        cluster_addr(recv_bar, tid));
    }
  }
  mark(5);
  mbar_wait(recv_bar, 0);
  mark(6);
  cluster_arrive();  // every partner has read this block's partial once all arrive

  // This rank's rows: each element the ranks' partials in rank order, then
  // scaled and rounded.
  for (int it = row_lo * (TO / 4) + tid; it < row_hi * (TO / 4); it += kCons) {
    const int ml = it / (TO / 4);
    const int ol = (it - ml * (TO / 4)) * 4;
    if (ol >= rows_o) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kQmMaxSplit; ++q) {
      if (q < ksplit) {
        const float* src = q == rank ? part + ml * L::LDO + ol
                                     : recv + (q * slot_rows + ml - row_lo) * L::LDO + ol;
        const float4 e = *reinterpret_cast<const float4*>(src);
        if (q == 0) {
          v = e;
        } else {
          v.x += e.x;
          v.y += e.y;
          v.z += e.z;
          v.w += e.w;
        }
      }
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat16* dst = out + (long long)(m0 + ml) * o + o0 + ol;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!kQmTimeline && ol + e < rows_o) dst[e] = __float2bfloat16(vs[e] * s[o0 + ol + e]);
    }
  }
  cluster_wait();  // no block leaves while a partner's copy may still read its partial
  mark(7);
  write_marks();
}

// cuTensorMapEncodeTiled, found once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D tensor map of `rows` rows of `cols` elements, `ld_bytes` apart, read
// in boxes of box_cols x box_rows with the 128-byte swizzle.
bool qmm_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long cols,
             long long rows, long long ld_bytes, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory beyond the 48 KB default for qmm_kernel<NT> on the current
// card: the attribute is the device's, so it is set once for each device,
// and kept in a set under a lock (engines launch from threads of their own).
template <int NT>
cudaError_t qmm_opt_in() {
  static std::mutex lock;
  static std::set<int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (done.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(qmm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QmLayout<NT>::kBytes);
  if (err == cudaSuccess) done.insert(dev);
  return err;
}

// The launch: clusters of ksplit blocks along y.
template <int NT>
cudaLaunchConfig_t qmm_config(long long m, int o, int ksplit, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = (unsigned)ksplit;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((o + kQmTileO - 1) / kQmTileO), (unsigned)ksplit,
                     (unsigned)((m + 8 * NT - 1) / (8 * NT)));
  cfg.blockDim = dim3(kQmThreads);
  cfg.dynamicSmemBytes = QmLayout<NT>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT>
cudaError_t qmm_launch(const void* x, const void* wq, const void* s, void* out, long long m,
                       int o, int i, long long ldw, int ksplit, cudaStream_t stream) {
  cudaError_t err = qmm_opt_in<NT>();
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap wmap, xmap;
  if (!qmm_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, i, o, ldw, kQmChunkK, kQmTileO) ||
      !qmm_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, i, m, 2LL * i, 64, 8 * NT)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qmm_config<NT>(m, o, ksplit, stream, &attr);
  return cudaLaunchKernelEx(&cfg, qmm_kernel<NT>, wmap, xmap, (const float*)s,
                            (__nv_bfloat16*)out, (int)m, o, i, ksplit);
}

template <int NT>
int qmm_max_clusters(long long m, int o, int ksplit) {
  if (qmm_opt_in<NT>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qmm_config<NT>(m, o, ksplit, nullptr, &attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, qmm_kernel<NT>, &cfg) == cudaSuccess ? n : -1;
}

// The template instance for m rows: F<NT>(args...).
#define DSM_QMM_DISPATCH(F, ...)                                                 \
  (m <= 8 ? F<1>(__VA_ARGS__) : m <= 16 ? F<2>(__VA_ARGS__) : m <= 32 ? F<4>(__VA_ARGS__) \
                                                                     : F<8>(__VA_ARGS__))

bool qmm_tiling_ok(long long m, int o, int i, int ksplit) {
  const int n_chunks = (i + kQmChunkK - 1) / kQmChunkK;
  return ksplit >= 1 && ksplit <= kQmMaxSplit && ksplit <= n_chunks && m > 0 &&
         m <= 64LL * 65535 && o > 0;
}

}  // namespace

extern "C" {

// x (m, i) bf16 contiguous, 16-byte aligned; wq int8, row r at wq + r * ldw,
// 16-byte aligned; s (o,) f32; out (m, o) bf16.  128 channels a block, K
// split over ksplit (1 to 8, at most ceil(i / 128)) blocks of a cluster.
// Returns a cudaError_t.
int dsm_qmm(const void* x, const void* wq, const void* s, void* out, long long m, int o,
            int i, long long ldw, int ksplit, void* stream) {
  if (m == 0 || o == 0) return (int)cudaSuccess;
  if (i < 16 || i % 16 || ldw < i || ldw % 16 || !qmm_tiling_ok(m, o, i, ksplit)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)DSM_QMM_DISPATCH(qmm_launch, x, wq, s, out, m, o, i, ldw, ksplit,
                               (cudaStream_t)stream);
}

// How many clusters of the (m, o, ksplit) launch the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1.
int dsm_qmm_max_clusters(long long m, int o, int ksplit) {
  if (!qmm_tiling_ok(m, o, 16 * kQmChunkK, ksplit)) return -1;
  return DSM_QMM_DISPATCH(qmm_max_clusters, m, o, ksplit);
}

}  // extern "C"
