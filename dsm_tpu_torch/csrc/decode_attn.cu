// Hopper (sm_90a) kernels of the int8 ring attention at T=1: the split
// pipeline's decode attention and the fused pipeline's attention + commit.
//
//   dsm_decode_attend         <- dsm_tpu/ops/decode_attn.py:_decode_attend_q_flash,
//                                :_decode_attend_q_4d and :_decode_attend_q (the
//                                head-major layout): decode_attend_q8_kernel
//     with packed4 = 1        <- dsm_tpu/ops/decode_attn.py:_decode_attend_q4_4d
//                                and :_decode_attend_q4 (the head-major layout):
//                                decode_attend_q4_kernel
//   dsm_decode_attend_commit  <- dsm_tpu/ops/decode_attn.py:_decode_attend_commit_q_4d
//                                and :_decode_attend_commit_q (h = 32, Dh = 64)
//
// T=1 decode attention of bf16 queries over an int8 K/V ring with per-row
// f32 scales, with this step's fresh bf16 K/V row joining the softmax
// exactly.  dsm_decode_attend reads the COMMITTED ring (ring_commit_q has
// already written this step's row at w); dsm_decode_attend_commit reads the
// PRE-commit ring (scale_commit has written the scale rings) and then writes
// the fresh int8 row into ring row w.  Row w is masked from the ring read in
// both, so both compute the same function:
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
// Spans are span_rows(C, n_split) rows, a multiple of 4, so that a span's
// first row and its first scale lie on 16 bytes.
//
// What bounds it on the H100: bytes.  At the s2s-2b serving shape (B=24,
// H=20, C=3072, Dh=128) a full ring is 2 x 24 x 20 x 3072 x 128 B = 377 MB
// of int8 plus 11.8 MB of scales per call, about 116 us at 3.35 TB/s, 24
// times a tick; at stt-1b (B=64, H=16, C=768) 201 MB, about 60 us, 16 times
// a step.  Two multiply-adds per byte, far below the card's ridge of about
// 300 operations per byte: no tensor cores, a query of one row against C
// rows is a matrix-vector product.  What counts is how many bytes are in
// flight: bytes in flight = rate x latency, and at about a microsecond of
// latency under load 3.35 TB/s wants some 25 KB in flight on each SM.
//
// What the designs do about it.  The TPU kernel walks the ring in chunks on
// a sequential grid axis and carries (m, l, acc) in scratch memory; here the
// chunks are reduced in parallel, each span of ring rows to one partial
// (acc[Dh], m, l) in f32, and the partials and the fresh row are folded in
// a fixed order (no atomics: repeated runs are bit-identical).  In the fused
// pipeline a grid of B*H * n_split blocks reduces the spans and a second
// small kernel folds them and writes the committed row w; it reads a
// partial or writes a ring row only once the whole first grid has finished
// (it is launched with programmatic stream serialization, so that its
// blocks start during the first one's tail, and waits with
// griddepcontrol.wait), so the in-place commit needs no other ordering.  In
// the split pipeline persistent blocks take (b, h, span) items in turn and,
// at one span, fold the fresh row themselves: one launch a call; where the
// ring is split the same fold kernel follows as a programmatic dependent
// launch.  No kernel reads row w's bytes into the result.
//
// The split pipeline's kernels (decode_attend_q8_kernel over int8 rings,
// decode_attend_q4_kernel over packed-int4 ones) share their copy warp: it
// builds an item's attended-row mask (interval arithmetic on the window, the
// valid bytes gathered four to a multiply) and header (q, the fresh rows)
// from loads issued while the item before it is copied, then brings the
// item's K and V tiles with their scales into a ring of shared-memory
// stages by TMA bulk copies (cp.async.bulk on full and empty mbarriers): of
// each tile only the rows from its first attended row to its last (rounded
// to 4 rows), tiles without one skipped, so a nearly empty ring moves and
// computes its few rows, not whole tiles, and a span with no attended row
// reads nothing and leaves m = -inf, l = 0.  The split on the card
// (ops/decode_attn.py:pick_split_card): one span unless the B*H items give
// the SMs fewer than two each, spans of whole tiles.
//
// decode_attend_q8_kernel replaces a kernel of one block of 256 threads a
// (b, h, span), each lane with one 16-byte register load in flight (24 KB
// an SM), every block walking every row of its span whatever the fill, and
// the fold a second launch: 55-72 % of the byte bound at the full serving
// rings, under half at a tp shard's, and a third of a full ring's time on a
// nearly empty one.  Its four warps that compute read a tile from shared
// memory in the fused pipeline's lane layout (a 128-byte row takes 8 lanes,
// a warp 4 rows a step; 8 rows at Dh=64), each value an f32 by unpack_i8,
// the dots on the CUDA cores (q . K_j and p_j V_j: bf16 times an 8-bit
// integer, exact products, f32 sums), a score's sum across the row's lanes
// by a 3-step (2-step) shuffle: in ca_attn.cu that costs some 3 % over the
// copies alone.  Two stages of 16 KB tiles where the card holds every item at
// once at that size, else of 8 KB (more blocks an SM).
//
// decode_attend_staged_kernel (the fused pipeline): the rows of a span are
// contiguous in memory (span x Dh bytes of K, span x 4 of scales), so one
// producer warp copies them into a ring of kStages shared-memory stages with
// TMA's 1-D bulk copy (cp.async.bulk), an 8 KB tile of K or V rows and its
// scales a stage, each stage with a "full" mbarrier that counts the bytes
// and an "empty" one the consumer warps arrive on.  Four consumer warps read
// the tiles from shared memory with 16-byte reads in the lane layout above:
// the K tiles first (scores into shared memory), then the span's maximum,
// then the V tiles, the first of which are already in flight while the last
// scores are computed.  Bytes in flight then depend on the stages, not on
// registers: 17 KB a block, eight blocks (135 KB) an SM.  On the H100 two
// stages beat three to six (more stages, fewer blocks an SM) and 4 or 16 KB
// tiles; what is left above the byte bound is mostly fixed cost (every
// block's mask and first copy before its first byte, and the fold), not
// bytes in flight: a nearly empty ring still takes over a quarter of a full
// one's time.  A tile with no attended row is not copied (a warp vote over
// ring_row_attended, made once into a bit mask of the span), so a ring not
// yet full is not read past pos; rows of a copied tile that the mask
// excludes get score -inf and probability 0, so their bytes never reach the
// result.
//
// Operands of dsm_decode_attend keep their (B, H, C, Dh) layout and are
// addressed through (b, h) strides, so a head-major (B*H, C, Dh) ring is the
// same kernel with other strides; the Dh values of a row and the C scales of
// one (b, h) are contiguous, rows 16-byte aligned.  dsm_decode_attend_commit
// takes contiguous (B, H, C, Dh) rings and (B, H, C) scales.
//
// Packed-int4 rings (packed4 = 1, dsm_decode_attend only): a ring row is
// Dh/2 bytes, byte d holding dims d (low nibble) and d + Dh/2 (high nibble),
// each stored excess-8 (dsm_tpu/ops/attention.py:pack4).  Half the int8
// ring's bytes for the same count of values, so the operations a value weigh
// twice as much: at 3.35 TB/s an SM takes some 26 values a clock, and an
// unpack of a shift, a logic operation and an f32 subtraction a value, then
// an FFMA, fill most of its issue slots.  decode_attend_q4_kernel: the copy
// warp above (the header also holds q in the score mma's operand order;
// stages of 12 KB at Dh=64, three, a 384-row span a tile; four of 8 KB at
// Dh=128).  The four warps that compute unpack two nibbles into a bf16x2
// pair with a logic operation and one bf16x2 fma (n - 8 exactly) and take
// the dots on mma.sync m16n8k16 (bf16 in, f32 accumulated: the products are
// exact, the sums f32): the scores with 16 rows as A and q in every column
// of B, the values with the dims as A's rows and 16 rows' probabilities as
// B, two rows paired into a bf16x2 by a byte permute; each row's probability
// is taken once a tile.  On the H100 the warps that compute are bound by the
// instructions they issue between dependent steps (an m16n8k16 computes 8
// columns of which one is used, and its result is waited for): fewer
// instructions an item bought more than more stages or blocks.  A
// never-written row is all zero bytes, which unpack to -8: it is masked by
// the bitmap; rows of a stage that the mask excludes (an earlier tile's
// bytes outside the copied rows, finite all the same) get score -inf and
// probability 0.

// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): each
// entry point launches its kernels (two; one for dsm_decode_attend at one
// span) on the caller's stream, does not synchronise, allocates nothing (the
// caller passes the partials' scratch) and returns cudaGetLastError().
//
// The position: each entry point takes a device pointer to the step's shared
// tick pos (int32, the query's position), and each kernel reads it at its
// start and derives w = pos % C, as the Pallas kernels read their
// scalar-prefetched position and write row from device memory.  The grid
// depends on shapes only (the split is picked from B*H and C), so a step's
// launches can be captured in a CUDA graph once and replayed at every tick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

#include "attn_common.cuh"
#include "tma_common.cuh"

namespace {

using namespace dsm_attn;
using namespace dsm_tma;

// One block of DH threads per (b, h): fold the spans' partials and the fresh
// bf16 row, in span order.  q, k_new, v_new, out are contiguous (B*H, DH).
// With kq_new (the fused pipeline) it also commits this step's int8 rows
// kq_new / vq_new (contiguous (B*H, DH)) into ring row w = *pos % c,
// addressed through the rings' (b, h) strides.
template <int DH>
__global__ void __launch_bounds__(DH) decode_attend_combine_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int n_split, float scale, int8_t* __restrict__ k_cache,
    int8_t* __restrict__ v_cache, const int8_t* __restrict__ kq_new,
    const int8_t* __restrict__ vq_new, int h, int c, long long kv_sb, long long kv_sh,
    const int* __restrict__ pos) {
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
  const float vn = __bfloat162float(v_new[row + tid]);
  // Launched after the kernel that writes the partials with programmatic
  // stream serialization, this block may have started while that kernel
  // still runs: wait here for all of it, its partials and its reads of the
  // ring.  Launched the usual way (the variants tools' fold-after-grid),
  // there is nothing to wait for.
  wait_prior_grid();

  const float* p = part + (int64_t)bh * n_split * (DH + 2);
  float m = s_new;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, p[i * (DH + 2) + DH]);
  const float e_new = expf(s_new - m);
  float denom = e_new;
  float o = e_new * vn;
  for (int i = 0; i < n_split; ++i) {
    const float pm = p[i * (DH + 2) + DH];
    if (pm == -INFINITY) continue;  // a span with no attended row
    const float corr = expf(pm - m);
    denom += p[i * (DH + 2) + DH + 1] * corr;
    o += p[i * (DH + 2) + tid] * corr;
  }
  out[row + tid] = __float2bfloat16(o / denom);
  if (kq_new != nullptr) {
    const int b = bh / h;
    const int w = *pos % c;
    const int64_t dst = b * kv_sb + (bh - b * h) * kv_sh + (int64_t)w * DH + tid;
    k_cache[dst] = kq_new[row + tid];
    v_cache[dst] = vq_new[row + tid];
  }
}

// ---------------------------------------------------------------------------
// The fused pipeline's partial kernel: a span's K and V tiles brought into
// shared memory by TMA bulk copies (see the note at the top; the copy and
// barrier helpers are tma_common.cuh's).
// ---------------------------------------------------------------------------

constexpr int kStages = 2;          // shared-memory stages of the copy ring
constexpr int kTileBytes = 8192;    // ring rows of one stage: 64 at Dh=128, 128 at Dh=64
constexpr int kConsumerWarps = 4;   // warps that compute; one more warp copies
constexpr int kStagedThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxDynSmem = 232448;  // an H100 block's shared memory with the opt-in

// The 16 int8 values of a 16-byte read as floats, without an int-to-float
// conversion (16 a clock on an SM, where the ring's 3.35 TB/s asks some 13
// values a clock of each SM): byte b of (u ^ 0x80808080) is x + 128, one byte
// permute puts it into the mantissa of 2^23, and one subtraction of
// 2^23 + 128 leaves x exactly.
__device__ __forceinline__ void unpack_i8(const int4 v, float* out) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u, (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u, (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | b)) - 8388736.f;
  }
}

// Dynamic shared memory of the staged kernel: the stages (tile, then its
// scales), the full and empty barriers, the span's attended-row bit mask,
// its scores, and the warps' partial outputs and reductions.
template <int DH>
struct StagedLayout {
  static constexpr int kRows = kTileBytes / DH;  // ring rows of a tile
  static constexpr int kStage = kTileBytes + 4 * kRows;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kMask = kBars + 2 * kStages * 8;
  __host__ __device__ static int scores(int span) { return kMask + 4 * ((span + 31) / 32); }
  __host__ __device__ static int red(int span) { return scores(span) + 4 * span; }
  __host__ __device__ static int bytes(int span) {
    return red(span) + 4 * (kConsumerWarps * DH + 2 * kConsumerWarps);
  }
};

// One block per (b, h, span): warps 0..3 compute, warp 4 copies.  Rings and
// scales are contiguous (B, H, C, DH) and (B, H, C); q contiguous (B*H, DH);
// part (B*H, n_split, DH + 2): acc[DH], then m, then l, as the fold reads it.
template <int DH>
__global__ void __launch_bounds__(kStagedThreads) decode_attend_staged_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const uint8_t* __restrict__ valid,
    float* __restrict__ part, int h, int c, int n_split, int span,
    const int* __restrict__ pos_p, int window, float scale) {
  using L = StagedLayout<DH>;
  constexpr int TR = L::kRows;
  constexpr int LPR = DH / 16;   // lanes per ring row
  constexpr int RPW = 32 / LPR;  // ring rows per warp and step
  constexpr int WPT = TR / 32;   // mask words per tile
  extern __shared__ __align__(128) unsigned char staged_smem[];
  unsigned char* smem = staged_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L::kMask);
  float* scores = reinterpret_cast<float*>(smem + L::scores(span));
  float* red = reinterpret_cast<float*>(smem + L::red(span));
  float* wmax = red + kConsumerWarps * DH;
  float* wsum = wmax + kConsumerWarps;

  // The fold kernel may launch once every block has started; it waits for
  // this whole grid before it reads a partial.
  launch_dependents();
  const int bh = blockIdx.x / n_split;
  const int sp = blockIdx.x - bh * n_split;
  const int b = bh / h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = sp * span;
  const int n = max(0, min(c, s0 + span) - s0);  // rows of this span (a multiple of 4)
  const int n_tiles = (n + TR - 1) / TR;
  const int n_words = (n + 31) / 32;
  const uint8_t* va = valid + (int64_t)b * c;
  float* out = part + ((int64_t)bh * n_split + sp) * (DH + 2);
  const long long pos = *pos_p;
  const int w = (int)(pos % c);

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Which rows of the span are attended: one ballot per 32 rows.
  for (int wd = warp; wd < n_words; wd += kConsumerWarps + 1) {
    const int j = s0 + wd * 32 + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, j < s0 + n && ring_row_attended(j, w, c, pos, window, va));
    if (lane == 0) mask[wd] = bits;
  }
  __syncthreads();
  auto tile_live = [&](int t) {
    unsigned any = 0;
    for (int i = t * WPT; i < min(n_words, (t + 1) * WPT); ++i) any |= mask[i];
    return any != 0;
  };

  if (warp == kConsumerWarps) {  // the producer: one lane issues every copy
    if (lane == 0) {
      int i = 0;  // tiles issued so far
      for (int pass = 0; pass < 2; ++pass) {
        const int8_t* ring = (pass ? v_cache : k_cache) + ((int64_t)bh * c + s0) * DH;
        const float* sc = (pass ? v_scale : k_scale) + (int64_t)bh * c + s0;
        for (int t = 0; t < n_tiles; ++t) {
          if (!tile_live(t)) continue;
          const int st = i % kStages;
          mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);  // the first round passes
          const int rows = min(TR, n - t * TR);
          unsigned char* stage = smem + st * L::kStage;
          mbar_arrive_expect_tx(&full[st], (uint32_t)rows * (DH + 4));
          bulk_copy(stage, ring + (int64_t)t * TR * DH, (uint32_t)rows * DH, &full[st]);
          bulk_copy(stage + kTileBytes, sc + t * TR, (uint32_t)rows * 4, &full[st]);
          ++i;
        }
      }
    }
    return;
  }

  // The consumers: 128 threads; a lane reads bytes [16 sub, 16 sub + 16) of
  // row rsub of its warp's step.
  const int sub = lane % LPR;
  const int rsub = lane / LPR;
  float qf[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) qf[e] = __bfloat162float(q[(int64_t)bh * DH + sub * 16 + e]);

  // K tiles: the scores of the span's rows, -inf where the mask excludes.
  int i = 0;  // tiles consumed so far
  float local_max = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    if (!tile_live(t)) continue;
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const int rows = min(TR, n - t * TR);
    const unsigned char* tile = smem + st * L::kStage;
    const float* tsc = reinterpret_cast<const float*>(tile + kTileBytes);
    for (int r0 = warp * RPW; r0 < rows; r0 += kConsumerWarps * RPW) {
      const int r = r0 + rsub;
      float acc = 0.f;
      if (r < rows) {
        float kv[16];
        unpack_i8(*reinterpret_cast<const int4*>(tile + r * DH + sub * 16), kv);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0 && r < rows) {
        const int jr = t * TR + r;
        const float s = (mask[jr >> 5] >> (jr & 31)) & 1u ? acc * (tsc[r] * scale) : -INFINITY;
        scores[jr] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    ++i;
  }
  local_max = warp_max(local_max);
  if (lane == 0) wmax[warp] = local_max;
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumerWarps) : "memory");
  float m = wmax[0];
#pragma unroll
  for (int k = 1; k < kConsumerWarps; ++k) m = fmaxf(m, wmax[k]);
  const bool empty_span = i == 0;  // no attended row: nothing was copied

  // V tiles: probabilities bf16(e_j * vs_j) times the rows.
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  float lsum = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    if (!tile_live(t)) continue;
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const int rows = min(TR, n - t * TR);
    const unsigned char* tile = smem + st * L::kStage;
    const float* tsc = reinterpret_cast<const float*>(tile + kTileBytes);
    for (int r0 = warp * RPW; r0 < rows; r0 += kConsumerWarps * RPW) {
      const int r = r0 + rsub;
      if (r >= rows) continue;
      const float s = scores[t * TR + r];
      float p = 0.f;
      if (s != -INFINITY) {
        const float e = expf(s - m);
        if (sub == 0) lsum += e;
        p = __bfloat162float(__float2bfloat16(e * tsc[r]));
      }
      float vv[16];
      unpack_i8(*reinterpret_cast<const int4*>(tile + r * DH + sub * 16), vv);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += p * vv[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    ++i;
  }
  // Fold the warp's RPW row groups (lanes with the same sub), then the warps.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (rsub == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[warp * DH + sub * 16 + e] = acc[e];
  }
  lsum = warp_sum(lsum);
  if (lane == 0) wsum[warp] = lsum;
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumerWarps) : "memory");
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < kConsumerWarps; ++k) o += red[k * DH + tid];
    out[tid] = o;
  }
  if (tid == 0) {
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < kConsumerWarps; ++k) l += wsum[k];
    out[DH] = empty_span ? -INFINITY : m;
    out[DH + 1] = l;
  }
}

// ---------------------------------------------------------------------------
// The split pipeline's kernels (see the note at the top): persistent blocks
// over (b, h, span) items, whose copy warp brings each item's attended rows
// into shared memory by TMA bulk copies; decode_attend_q8_kernel over int8
// rings (the dots on the CUDA cores), decode_attend_q4_kernel over
// packed-int4 rings (the dots on mma.sync).  The two share their layout of
// shared memory, their copy warp, the attended rows of a tile and the end of
// an item.
// ---------------------------------------------------------------------------

constexpr int kQ4Warps = 4;          // warps that compute; one more warp copies
constexpr int kQ4Threads = 32 * (kQ4Warps + 1);
constexpr int kQ8Warps = 4;          // the same for int8 rings
constexpr int kQ8Threads = 32 * (kQ8Warps + 1);
// The int8 kernel's copy ring (tools/int8_attend_variants.py): two stages of
// 16 KB tiles where the card holds every item at once at that size, else of
// 8 KB (more blocks an SM); and the blocks an SM holds at once, which caps a
// thread's registers (48 at Dh=64, a few bytes spilled; at Dh=128 six blocks,
// no spill).
constexpr int kQ8Stages = 2;
constexpr int kQ8TileBytes = 16384;
constexpr int kQ8SmallTileBytes = 8192;
constexpr int q8_min_blocks(int dh) { return dh == 64 ? 8 : 6; }

// Dynamic shared memory of a persistent kernel over ring rows of ROW_BYTES
// bytes: the stages (tile, then its scales), two item headers (q, k_new,
// v_new as bf16, then for packed rings q in the score mma's operand order),
// the barriers (full and empty a stage, full and empty a header), the warps'
// partial outputs, maxima and sums, for packed rings two tiles' bf16
// probabilities, two attended-row bit masks of a span, and the span's
// scores.  A tile holds a multiple of 32 rows (whole mask words).
template <int DH, int ROW_BYTES, int STAGES, int TILE_BYTES, int WARPS, bool PACKED>
struct RingLayout {
  static constexpr int kDh = DH;
  static constexpr bool kPacked = PACKED;
  static constexpr int kStages = STAGES;
  static constexpr int kTileBytes = TILE_BYTES;
  static constexpr int kRowBytes = ROW_BYTES;
  static constexpr int kRows = kTileBytes / kRowBytes;  // ring rows of a tile
  static_assert(kRows % 32 == 0, "a tile holds whole mask words");
  static constexpr int kStage = kTileBytes + 4 * kRows;
  static constexpr int kHead = kStages * kStage;
  static constexpr int kHeadBytes = 2 * DH * (PACKED ? 4 : 3);
  static constexpr int kBars = kHead + 2 * kHeadBytes;
  static constexpr int kRed = kBars + 8 * (2 * kStages + 4);
  static constexpr int kProbs = kRed + 4 * (WARPS * DH + 2 * WARPS);
  static constexpr int kMask = kProbs + (PACKED ? 2 * 2 * kRows : 0);
  __host__ __device__ static int mask_words(int span) { return (span + 31) / 32; }
  __host__ __device__ static int scores(int span) { return kMask + 2 * 4 * mask_words(span); }
  __host__ __device__ static int bytes(int span) { return scores(span) + 4 * span; }
  // Item k's header and attended-row mask: two slots each, by k's parity.
  __device__ static unsigned short* header(unsigned char* smem, int k) {
    return reinterpret_cast<unsigned short*>(smem + kHead + (k & 1) * kHeadBytes);
  }
  __device__ static uint32_t* mask(unsigned char* smem, int k, int n_words) {
    return reinterpret_cast<uint32_t*>(smem + kMask) + (k & 1) * n_words;
  }
};

// Stages and tile bytes of the packed kernel by head width
// (tools/q4_attend_variants.py): at Dh=64 three stages of 12 KB, a stt-2.6b
// span of 384 rows a tile; at Dh=128 four of 8 KB (128 rows).
template <int DH>
struct Q4Tiles {
  static constexpr int kStages = DH == 64 ? 3 : 4;
  static constexpr int kTileBytes = DH == 64 ? 12288 : 8192;
};
template <int DH>
using Q4Layout =
    RingLayout<DH, DH / 2, Q4Tiles<DH>::kStages, Q4Tiles<DH>::kTileBytes, kQ4Warps, true>;

template <int DH, int TILE>
using Q8Layout = RingLayout<DH, DH, kQ8Stages, TILE, kQ8Warps, false>;

// A bf16x2 pair of nibbles: bits 0-3 and 16-19 of x, each n = 0..15, go into
// the mantissas of bf16 128 (0x4300), and one bf16x2 fma with -136 leaves
// n - 8 exactly.  Two values for a logic operation and an fma.
__device__ __forceinline__ uint32_t q4_pair(uint32_t x) {
  const uint32_t r = (x & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The 8 values of a 32-bit word of packed bytes (bytes e = 0..3 holding
// dims d + e in the low nibble and d + e + Dh/2 in the high one) as four
// bf16x2 pairs: (d, d+2), (d+H, d+2+H), (d+1, d+3), (d+1+H, d+3+H), H = Dh/2.
// Through a byte permute of two rows' words, the same pairs hold one dim of
// two rows.
__device__ __forceinline__ void q4_word(uint32_t x, uint32_t* r) {
  r[0] = q4_pair(x);
  r[1] = q4_pair(x >> 4);
  r[2] = q4_pair(x >> 8);
  r[3] = q4_pair(x >> 12);
}

// d += a b: mma.sync m16n8k16, bf16 in, f32 accumulated.  Fragments as the
// PTX manual gives them, g = lane / 4, t = lane % 4: a0 (row g, k 2t, 2t+1),
// a1 (row g+8, the same k), a2 (row g, k 2t+8, 2t+9), a3 (row g+8, those);
// b0 (k 2t, 2t+1, column g), b1 (k 2t+8, 2t+9); d0, d1 (row g, columns 2t,
// 2t+1), d2, d3 (row g+8).
__device__ __forceinline__ void q4_mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bits r = 0..31 set where j0 + r lies in [lo, hi).
__device__ __forceinline__ uint32_t q4_rows_between(int j0, int lo, int hi) {
  lo = max(lo, j0) - j0;
  hi = min(hi, j0 + 32) - j0;
  if (hi <= lo) return 0u;
  return (hi - lo == 32 ? 0xffffffffu : (1u << (hi - lo)) - 1u) << lo;
}

// The attended rows of tile t of an item (mk: its mask, nw: its words) as
// [lo, hi) from the tile's first row, lo rounded down and hi up to 4 rows
// (16 bytes of scales); false for a tile with none.  Only those rows are
// copied and taken: a row of the stage outside them holds an earlier tile's
// bytes, which unpack to finite values, and is masked (score -inf,
// probability 0).
template <class L>
__device__ __forceinline__ bool attended_rows(const uint32_t* mk, int t, int nw, int& lo,
                                              int& hi) {
  constexpr int MPT = L::kRows / 32;  // mask words of a tile
  const int x0 = t * MPT, x1 = min(nw, x0 + MPT);
  int a = x0;
  while (a < x1 && mk[a] == 0u) ++a;
  if (a == x1) return false;
  int z = x1 - 1;
  while (mk[z] == 0u) --z;
  lo = (32 * (a - x0) + __ffs(mk[a]) - 1) & ~3;
  hi = (32 * (z - x0) + 32 - __clz(mk[z]) + 3) & ~3;
  return true;
}

// The barriers of a persistent kernel's block (layout L, `warps` consumer
// warps): a stage's full (the copy's bytes) and empty (each consumer warp),
// a header slot's full (the copy warp's lanes) and empty (each consumer
// warp); initialised before any thread of the block uses one.
template <class L>
__device__ __forceinline__ void ring_barriers(unsigned char* smem, int warps) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* hfull = empty + L::kStages;
  uint64_t* hempty = hfull + 2;
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], warps);
    }
    for (int sl = 0; sl < 2; ++sl) {
      mbar_init(&hfull[sl], 32);
      mbar_init(&hempty[sl], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The copy warp of a persistent kernel (layout L; ring rows of L::kRowBytes
// bytes, strides in bytes for the rings, in values for the scales).  Block
// x takes the items (b, h, span) [x per_block, (x + 1) per_block) in turn
// (item i is span i % n_split of (b, h) = i / n_split: a block's items are
// neighbouring heads of one batch row, contiguous in memory).  For each, once
// the consumers have released header slot k % 2, it writes the item's
// attended-row mask and header there, then brings the item's K tiles and V
// tiles with their scales into the stages: of each tile only the rows from
// its first attended row to its last, tiles without one skipped.  An item's
// loads (its header, the first 1,024 rows of its validity row) are issued
// before the item before it is copied, so that they land meanwhile.
template <class L>
__device__ __forceinline__ void ring_producer(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_cache,
    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const uint8_t* __restrict__ valid, int n_items,
    int per_block, int h, int c, int n_split, int span, long long kv_sb, long long kv_sh,
    long long s_sb, long long s_sh, const int* __restrict__ pos_p, int window) {
  constexpr int DH = L::kDh;
  constexpr int RB = L::kRowBytes;
  constexpr int TR = L::kRows;
  const int lane = threadIdx.x & 31;
  const int n_words = L::mask_words(span);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* hfull = empty + L::kStages;
  uint64_t* hempty = hfull + 2;
  // An item's (b, h), first row and rows.
  auto place = [&](int it, int& bh, int& s0, int& n) {
    bh = it / n_split;
    s0 = (it - bh * n_split) * span;
    n = max(0, min(c, s0 + span) - s0);
  };
  // An item's loads: its header (q and, where the block folds, the fresh
  // rows) and 1,024 rows of its validity row from mask word x0, each lane
  // 4-byte words of rows [32 L, 32 L + 32) (c and the span starts are
  // multiples of 4, the rows 4-byte aligned).
  unsigned short hv[3][DH / 32];
  uint32_t vb[8];
  auto fetch = [&](int it, int x0) {  // x0: the first mask word (a multiple of 32)
    int bh, s0, n;
    place(it, bh, s0, n);
    if (x0 == 0) {
      const int64_t row = (int64_t)bh * DH;
#pragma unroll
      for (int x = 0; x < DH / 32; ++x) {
        const int e = lane + 32 * x;
        hv[0][x] = reinterpret_cast<const unsigned short*>(q)[row + e];
        hv[1][x] = n_split == 1 ? reinterpret_cast<const unsigned short*>(k_new)[row + e] : 0;
        hv[2][x] = n_split == 1 ? reinterpret_cast<const unsigned short*>(v_new)[row + e] : 0;
      }
    }
    const uint8_t* va = valid + (int64_t)(bh / h) * c;
    const int j0 = s0 + 32 * (x0 + lane);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      vb[x] = j0 + 4 * x < s0 + n ? *reinterpret_cast<const uint32_t*>(va + j0 + 4 * x) : 0u;
  };
  // Rows at ring distance 1 .. d_max from w are in the window.
  const long long pos = *pos_p;
  const int w = (int)(pos % c);
  const int d_max = (int)min((long long)min(window - 1, c - 1), pos);
  int i = 0;  // tiles issued so far (lane 0)
  int k = 0;  // items so far
  const int first = blockIdx.x * per_block;
  const int last = min(n_items, first + per_block);
  if (first < last) fetch(first, 0);
  for (int it = first; it < last; ++it, ++k) {
    int bh, s0, n;
    place(it, bh, s0, n);
    const int b = bh / h;
    const int hh = bh - b * h;
    const int nw = (n + 31) / 32;
    if (lane == 0) mbar_wait(&hempty[k & 1], ((k >> 1) & 1) ^ 1);  // the first round passes
    __syncwarp();
    // Which rows of the span are attended: lane L builds mask words L,
    // L + 32, ... (past the first 1,024 rows, from loads made here): the
    // rows of the window w - d_max .. w - 1 (mod c), and a valid byte (0
    // or 1) a row, four to a word, gathered into four bits by a multiply.
    uint32_t* mk = L::mask(smem, k, n_words);
    for (int x0 = 0; x0 < nw; x0 += 32) {
      // The chunk's rows [a, z): where the window holds none, no loads.
      const int a = s0 + 32 * x0, z = min(s0 + n, a + 1024);
      const bool near = max(a, w - d_max) < min(z, w) || max(a, c + w - d_max) < min(z, c);
      if (x0 > 0 && near) fetch(it, x0);
      const int j0 = s0 + 32 * (x0 + lane);
      uint32_t bits = 0;
      if (near) {
#pragma unroll
        for (int x = 0; x < 8; ++x) bits |= ((vb[x] * 0x01020408u) >> 24) << (4 * x);
        bits &= q4_rows_between(j0, w - d_max, w) | q4_rows_between(j0, c + w - d_max, c);
      }
      if (x0 + lane < nw) mk[x0 + lane] = bits;
    }
    unsigned short* hd = L::header(smem, k);
#pragma unroll
    for (int x = 0; x < DH / 32; ++x) {
      hd[lane + 32 * x] = hv[0][x];
      hd[DH + lane + 32 * x] = hv[1][x];
      hd[2 * DH + lane + 32 * x] = hv[2][x];
    }
    __syncwarp();
    if constexpr (L::kPacked) {
      // q as the B operand of the score mmas, pair p of lane group tq: in
      // step 2x the k of word x of the group's part of a row (dims d = 4 (tq
      // WPT + x)) are the pairs q4_word gives, (d, d+2) and (d+H, d+2+H); in
      // step 2x+1 the others.
      constexpr int H = DH / 2;
      constexpr int WPT = DH / 32;  // words of a row a lane reads for the scores
#pragma unroll
      for (int y = 0; y < DH / 64; ++y) {
        const int p = lane + 32 * y;  // of DH / 2 pairs: tq = p / (4 WPT)
        const int x = (p % (4 * WPT)) / 4, r = p % 4;
        const int d = 4 * ((p / (4 * WPT)) * WPT + x) + (r >> 1) + (r & 1) * H;
        reinterpret_cast<uint32_t*>(hd + 3 * DH)[p] = (uint32_t)hd[d] | ((uint32_t)hd[d + 2] << 16);
      }
      __syncwarp();
    }
    mbar_arrive(&hfull[k & 1]);
    if (it + 1 < last) fetch(it + 1, 0);
    if (lane == 0) {  // K tiles, then V tiles, with their scales
      const int n_tiles = (n + TR - 1) / TR;
      for (int pass = 0; pass < 2; ++pass) {
        const uint8_t* ring = (pass ? v_cache : k_cache) + b * kv_sb + hh * kv_sh +
                              (int64_t)s0 * RB;
        const float* sc = (pass ? v_scale : k_scale) + b * s_sb + hh * s_sh + s0;
        for (int t = 0; t < n_tiles; ++t) {
          int lo, hi;
          if (!attended_rows<L>(mk, t, nw, lo, hi)) continue;
          const int st = i % L::kStages;
          mbar_wait(&empty[st], ((i / L::kStages) & 1) ^ 1);
          unsigned char* stage = smem + st * L::kStage;
          const int r0 = t * TR + lo;
          mbar_arrive_expect_tx(&full[st], (uint32_t)(hi - lo) * (RB + 4));
          bulk_copy(stage + lo * RB, ring + (int64_t)r0 * RB, (uint32_t)(hi - lo) * RB,
                    &full[st]);
          bulk_copy(stage + L::kTileBytes + 4 * lo, sc + r0, (uint32_t)(hi - lo) * 4, &full[st]);
          ++i;
        }
      }
    }
    __syncwarp();
  }
}

// The end of an item, in thread tid < DH of the consumers: o, dim tid of
// its span's sum of p_j V_j; l, its sum of e_j; m_span, its maximum (-inf
// for a span with no attended row); hd, its header.  At one span the fresh
// row is folded in as decode_attend_combine_kernel folds it and the result
// written; else the span's partial, for the fold kernel.
template <int DH>
__device__ __forceinline__ void finish_item(const unsigned short* hd, float o, float l,
                                            float m_span, int bh, int sp, int n_split,
                                            float scale, float* __restrict__ part,
                                            __nv_bfloat16* __restrict__ out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (n_split == 1) {
    constexpr int EPL = DH / 32;
    const __nv_bfloat16* hq = reinterpret_cast<const __nv_bfloat16*>(hd);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      a += __bfloat162float(hq[lane * EPL + e]) * __bfloat162float(hq[DH + lane * EPL + e]);
    const float s_new = warp_sum(a) * scale;
    const float vn = __bfloat162float(hq[2 * DH + tid]);
    const float mt = fmaxf(s_new, m_span);
    const float e_new = expf(s_new - mt);
    float denom = e_new;
    float y = e_new * vn;
    if (m_span != -INFINITY) {
      const float corr = expf(m_span - mt);
      denom += l * corr;
      y += o * corr;
    }
    out[(int64_t)bh * DH + tid] = __float2bfloat16(y / denom);
  } else {
    float* po = part + ((int64_t)bh * n_split + sp) * (DH + 2);
    po[tid] = o;
    if (tid == 0) {
      po[DH] = m_span;
      po[DH + 1] = l;
    }
  }
}

// Persistent blocks over packed-int4 rings (see the note at the top): warps
// 0..3 compute, warp 4 copies (ring_producer).  Strides in bytes for the
// rings, whose rows are DH/2 bytes, in values for the scales; q, k_new, v_new
// and out contiguous (B*H, DH).  With n_split = 1 the block folds the fresh
// row and writes out, else the span's partial into part (B*H, n_split,
// DH + 2).
template <int DH>
__global__ void __launch_bounds__(kQ4Threads) decode_attend_q4_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_cache,
    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const uint8_t* __restrict__ valid,
    float* __restrict__ part, __nv_bfloat16* __restrict__ out, int n_items, int per_block,
    int h, int c, int n_split, int span, long long kv_sb, long long kv_sh, long long s_sb,
    long long s_sh, const int* __restrict__ pos_p, int window, float scale) {
  using L = Q4Layout<DH>;
  constexpr int RB = L::kRowBytes;
  constexpr int TR = L::kRows;
  constexpr int H = DH / 2;
  constexpr int WPT = DH / 32;  // words of a row a lane reads for the scores
  extern __shared__ __align__(128) unsigned char q4_smem[];
  unsigned char* smem = q4_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* hfull = empty + L::kStages;
  uint64_t* hempty = hfull + 2;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  float* wmax = red + kQ4Warps * DH;
  float* wsum = wmax + kQ4Warps;
  const int n_words = L::mask_words(span);
  float* scores = reinterpret_cast<float*>(smem + L::scores(span));

  // The fold kernel (n_split > 1) may launch once every block has started;
  // it waits for this whole grid before it reads a partial.
  launch_dependents();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  ring_barriers<L>(smem, kQ4Warps);
  if (warp == kQ4Warps) {
    ring_producer<L>(smem, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, n_items,
                     per_block, h, c, n_split, span, kv_sb, kv_sh, s_sb, s_sh, pos_p, window);
    return;
  }

  // The consumers: 128 threads; in an mma, g = lane / 4, tq = lane % 4.
  const int g = lane >> 2;
  const int tq = lane & 3;
  unsigned short* probs = reinterpret_cast<unsigned short*>(smem + L::kProbs);
  // Row x = tid % 16 of a chunk's probabilities sits in half x / 4 % 2 of
  // 32-bit word 4 (x / 8) + x % 4 (the rows steps of 32 kQ4Warps keep x).
  const int pslot = 2 * (4 * ((tid & 15) >> 3) + (tid & 3)) + ((tid >> 2) & 1);
  int i = 0;  // tiles consumed so far
  int k = 0;  // items so far
  const int last = min(n_items, (int)blockIdx.x * per_block + per_block);
  for (int it = blockIdx.x * per_block; it < last; ++it, ++k) {
    const int bh = it / n_split;
    const int sp = it - bh * n_split;
    const int n = max(0, min(c, sp * span + span) - sp * span);
    const int n_tiles = (n + TR - 1) / TR;
    const int nw = (n + 31) / 32;
    mbar_wait(&hfull[k & 1], (k >> 1) & 1);
    const uint32_t* mk = L::mask(smem, k, n_words);
    const unsigned short* hd = L::header(smem, k);

    uint32_t qf[4 * WPT];  // q as the score mmas' B operand (the header's last part)
#pragma unroll
    for (int x = 0; x < WPT; ++x) {
      const uint4 v = reinterpret_cast<const uint4*>(hd + 3 * DH)[tq * WPT + x];
      qf[4 * x] = v.x, qf[4 * x + 1] = v.y, qf[4 * x + 2] = v.z, qf[4 * x + 3] = v.w;
    }

    // K tiles: a warp scores 16 rows an mma chain, A the rows (row g and
    // g+8 of the 16), B q in every column: d0 and d2 are the rows' dots.
    int live = 0;
    float local_max = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      int lo, hi;  // the tile's attended rows
      if (!attended_rows<L>(mk, t, nw, lo, hi)) continue;
      const int st = i % L::kStages;
      mbar_wait(&full[st], (i / L::kStages) & 1);
      const unsigned char* tile = smem + st * L::kStage;
      const float* tsc = reinterpret_cast<const float*>(tile + L::kTileBytes);
      // Two chunks a step (rows r0.. and r0 + 64..), two independent chains;
      // the steps from the one that holds row lo.
      for (int r0 = lo / (32 * kQ4Warps) * (32 * kQ4Warps) + 16 * warp; r0 < hi;
           r0 += 32 * kQ4Warps) {
        const int r1 = r0 + 16 * kQ4Warps;
        uint32_t lw[2][WPT], hw[2][WPT];  // this lane's words of rows g and g+8
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ru = u && r1 < hi ? r1 : r0;  // past the rows: chunk r0 again, unused
          const unsigned char* src = tile + (ru + g) * RB + tq * WPT * 4;
          if constexpr (WPT == 2) {
            const uint2 a = *reinterpret_cast<const uint2*>(src);
            const uint2 b = *reinterpret_cast<const uint2*>(src + 8 * RB);
            lw[u][0] = a.x, lw[u][1] = a.y, hw[u][0] = b.x, hw[u][1] = b.y;
          } else {
            const uint4 a = *reinterpret_cast<const uint4*>(src);
            const uint4 b = *reinterpret_cast<const uint4*>(src + 8 * RB);
            lw[u][0] = a.x, lw[u][1] = a.y, lw[u][2] = a.z, lw[u][3] = a.w;
            hw[u][0] = b.x, hw[u][1] = b.y, hw[u][2] = b.z, hw[u][3] = b.w;
          }
        }
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int x = 0; x < WPT; ++x) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t ra[4], rb[4];
            q4_word(lw[u][x], ra);
            q4_word(hw[u][x], rb);
            q4_mma(acc[u], ra[0], rb[0], ra[1], rb[1], qf[4 * x], qf[4 * x + 1]);
            q4_mma(acc[u], ra[2], rb[2], ra[3], rb[3], qf[4 * x + 2], qf[4 * x + 3]);
          }
        }
        // The four lanes of group g hold the same dots: lane tq scores row
        // g + 8 (tq & 1) of chunk tq >> 1.
        const int r = (tq >> 1 ? r1 : r0) + g + 8 * (tq & 1);
        if (r < hi) {
          const float dot = tq >> 1 ? (tq & 1 ? acc[1][2] : acc[1][0])
                                    : (tq & 1 ? acc[0][2] : acc[0][0]);
          const int jr = t * TR + r;
          const float s = (mk[jr >> 5] >> (jr & 31)) & 1u ? dot * (tsc[r] * scale) : -INFINITY;
          scores[jr] = s;
          local_max = fmaxf(local_max, s);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++i;
      ++live;
    }
    local_max = warp_max(local_max);
    if (lane == 0) wmax[warp] = local_max;
    bar_sync_1(32 * kQ4Warps);
    float m = wmax[0];
#pragma unroll
    for (int x = 1; x < kQ4Warps; ++x) m = fmaxf(m, wmax[x]);

    // V tiles: first the tile's probabilities bf16(e * vs), each row's once,
    // into one of two buffers (0 past the rows, up to the 16 of a chunk),
    // stored so that rows (tq, tq+4) and (tq+8, tq+12) of a chunk are 32-bit
    // words tq and 4 + tq of its eight.  Then a warp takes 16 rows an mma
    // chain, A the rows' values with the dims as rows (dim 4v+j of word v =
    // g + 8 grp as row g, dim 4v+j+H as row g+8, j the mma of the four), k the
    // 16 rows (rows tq, tq+4 in a0 and a1, tq+8, tq+12 in a2 and a3, paired by
    // a byte permute), B the rows' probabilities in every column.
    float acc[DH / 64][4][4];
#pragma unroll
    for (int grp = 0; grp < DH / 64; ++grp)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[grp][j][e] = 0.f;
    float lsum = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      int lo, hi;
      if (!attended_rows<L>(mk, t, nw, lo, hi)) continue;
      const int st = i % L::kStages;
      mbar_wait(&full[st], (i / L::kStages) & 1);
      const unsigned char* tile = smem + st * L::kStage;
      const float* tsc = reinterpret_cast<const float*>(tile + L::kTileBytes);
      unsigned short* pt = probs + (i & 1) * TR;
      // From the step of 128 rows that holds row lo: a thread's rows, and so
      // its sum's order, as over the whole tile.
      for (int r = lo / (32 * kQ4Warps) * (32 * kQ4Warps) + tid; r < (hi + 15) / 16 * 16;
           r += 32 * kQ4Warps) {
        float p = 0.f;
        if (r < hi) {
          const float sc = scores[t * TR + r];
          if (sc != -INFINITY) {
            const float e = expf(sc - m);
            lsum += e;
            p = e * tsc[r];
          }
        }
        pt[(r & ~15) + pslot] = __bfloat16_as_ushort(__float2bfloat16(p));
      }
      bar_sync_1(32 * kQ4Warps);
      for (int r0 = lo / (16 * kQ4Warps) * (16 * kQ4Warps) + 16 * warp; r0 < hi;
           r0 += 16 * kQ4Warps) {
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(pt + r0);
        const uint32_t b0 = pw[tq];
        const uint32_t b1 = pw[4 + tq];
        const unsigned char* src = tile + (r0 + tq) * RB;
#pragma unroll
        for (int grp = 0; grp < DH / 64; ++grp) {
          const int v = 4 * (g + 8 * grp);  // byte offset of word g + 8 grp
          const uint32_t u0 = *reinterpret_cast<const uint32_t*>(src + v);
          const uint32_t u4 = *reinterpret_cast<const uint32_t*>(src + 4 * RB + v);
          const uint32_t u8 = *reinterpret_cast<const uint32_t*>(src + 8 * RB + v);
          const uint32_t u12 = *reinterpret_cast<const uint32_t*>(src + 12 * RB + v);
          uint32_t ra[8], rb[8];  // dims 4v', 4v'+H, 4v'+1, ... of rows (tq, tq+4), (tq+8, tq+12)
          q4_word(__byte_perm(u0, u4, 0x5410), ra);
          q4_word(__byte_perm(u0, u4, 0x7632), ra + 4);
          q4_word(__byte_perm(u8, u12, 0x5410), rb);
          q4_word(__byte_perm(u8, u12, 0x7632), rb + 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q4_mma(acc[grp][j], ra[2 * j], ra[2 * j + 1], rb[2 * j], rb[2 * j + 1], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++i;
    }
    // The warps' outputs (d0: dim 4v+j, d2: dim 4v+j+H), then in warp order.
    if (tq == 0) {
#pragma unroll
      for (int grp = 0; grp < DH / 64; ++grp)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = 4 * (g + 8 * grp) + j;
          red[warp * DH + d] = acc[grp][j][0];
          red[warp * DH + d + H] = acc[grp][j][2];
        }
    }
    lsum = warp_sum(lsum);
    if (lane == 0) wsum[warp] = lsum;
    bar_sync_1(32 * kQ4Warps);
    if (tid < DH) {
      float o = 0.f, l = 0.f;
#pragma unroll
      for (int x = 0; x < kQ4Warps; ++x) {
        o += red[x * DH + tid];
        l += wsum[x];
      }
      finish_item<DH>(hd, o, l, live ? m : -INFINITY, bh, sp, n_split, scale, part, out);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&hempty[k & 1]);
  }
}

// Persistent blocks over int8 rings (see the note at the top): warps 0..3
// compute, warp 4 copies (ring_producer), items and strides as
// decode_attend_q4_kernel's, ring rows of DH bytes.  A consumer lane takes
// bytes [16 sub, 16 sub + 16) of row rsub of its warp's step of RPW rows,
// each value an f32 by unpack_i8; a score's sum runs over the row's lanes by
// shuffles, a row's probability is taken in each of its lanes, and its V
// values times it go into 16 f32 sums a lane, folded over the warp's rows
// and then over the warps in warp order.  The steps start from the step that
// holds a tile's first copied row, so a thread's rows, and so its sums'
// order, are those of the whole tile whatever rows are copied.
template <int DH, int TILE>
__global__ void __launch_bounds__(kQ8Threads, q8_min_blocks(DH)) decode_attend_q8_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k_cache,
    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const uint8_t* __restrict__ valid,
    float* __restrict__ part, __nv_bfloat16* __restrict__ out, int n_items, int per_block,
    int h, int c, int n_split, int span, long long kv_sb, long long kv_sh, long long s_sb,
    long long s_sh, const int* __restrict__ pos_p, int window, float scale) {
  using L = Q8Layout<DH, TILE>;
  constexpr int TR = L::kRows;
  constexpr int LPR = DH / 16;          // lanes of a ring row
  constexpr int RPW = 32 / LPR;         // ring rows of a warp's step
  constexpr int STEP = kQ8Warps * RPW;  // ring rows of the consumers' step
  extern __shared__ __align__(128) unsigned char q8_smem[];
  unsigned char* smem = q8_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* hfull = empty + L::kStages;
  uint64_t* hempty = hfull + 2;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  float* wmax = red + kQ8Warps * DH;
  float* wsum = wmax + kQ8Warps;
  const int n_words = L::mask_words(span);
  float* scores = reinterpret_cast<float*>(smem + L::scores(span));

  // The fold kernel (n_split > 1) may launch once every block has started;
  // it waits for this whole grid before it reads a partial.
  launch_dependents();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ring_barriers<L>(smem, kQ8Warps);
  if (warp == kQ8Warps) {
    ring_producer<L>(smem, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, n_items,
                     per_block, h, c, n_split, span, kv_sb, kv_sh, s_sb, s_sh, pos_p, window);
    return;
  }

  const int sub = lane % LPR;
  const int rsub = lane / LPR;
  int i = 0;  // tiles consumed so far
  int k = 0;  // items so far
  const int last = min(n_items, (int)blockIdx.x * per_block + per_block);
  for (int it = blockIdx.x * per_block; it < last; ++it, ++k) {
    const int bh = it / n_split;
    const int sp = it - bh * n_split;
    const int n = max(0, min(c, sp * span + span) - sp * span);
    const int n_tiles = (n + TR - 1) / TR;
    const int nw = (n + 31) / 32;
    mbar_wait(&hfull[k & 1], (k >> 1) & 1);
    const uint32_t* mk = L::mask(smem, k, n_words);
    const unsigned short* hd = L::header(smem, k);
    float qf[16];  // q's dims [16 sub, 16 sub + 16): a bf16 is the high half of its f32
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint4 v = reinterpret_cast<const uint4*>(hd)[2 * sub + x];
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qf[8 * x + 2 * e] = __uint_as_float(u[e] << 16);
        qf[8 * x + 2 * e + 1] = __uint_as_float(u[e] & 0xFFFF0000u);
      }
    }
    auto attended = [&](int jr) { return (mk[jr >> 5] >> (jr & 31)) & 1u; };

    // K tiles: the scores of the attended rows (exact products, f32 sums).
    int live = 0;
    float local_max = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      int lo, hi;  // the tile's attended rows
      if (!attended_rows<L>(mk, t, nw, lo, hi)) continue;
      const int st = i % L::kStages;
      mbar_wait(&full[st], (i / L::kStages) & 1);
      const unsigned char* tile = smem + st * L::kStage;
      const float* tsc = reinterpret_cast<const float*>(tile + L::kTileBytes);
      for (int r0 = lo / STEP * STEP + warp * RPW; r0 < hi; r0 += STEP) {
        const int r = r0 + rsub;
        float acc = 0.f;
        if (r < hi) {
          float kv[16];
          unpack_i8(*reinterpret_cast<const int4*>(tile + sub * 16 + r * DH), kv);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const int jr = t * TR + r;
        if (sub == 0 && r < hi && attended(jr)) {
          const float s = acc * (tsc[r] * scale);
          scores[jr] = s;
          local_max = fmaxf(local_max, s);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++i;
      ++live;
    }
    local_max = warp_max(local_max);
    if (lane == 0) wmax[warp] = local_max;
    bar_sync_1(32 * kQ8Warps);
    float m = wmax[0];
#pragma unroll
    for (int x = 1; x < kQ8Warps; ++x) m = fmaxf(m, wmax[x]);

    // V tiles: each row's probability bf16(e * vs) times its values.
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    float lsum = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      int lo, hi;
      if (!attended_rows<L>(mk, t, nw, lo, hi)) continue;
      const int st = i % L::kStages;
      mbar_wait(&full[st], (i / L::kStages) & 1);
      const unsigned char* tile = smem + st * L::kStage;
      const float* tsc = reinterpret_cast<const float*>(tile + L::kTileBytes);
      for (int r0 = lo / STEP * STEP + warp * RPW; r0 < hi; r0 += STEP) {
        const int r = r0 + rsub;
        if (r >= hi) continue;
        const int jr = t * TR + r;
        float p = 0.f;
        if (attended(jr)) {
          const float e = expf(scores[jr] - m);
          if (sub == 0) lsum += e;
          p = __bfloat162float(__float2bfloat16(e * tsc[r]));
        }
        float vv[16];
        unpack_i8(*reinterpret_cast<const int4*>(tile + sub * 16 + r * DH), vv);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += p * vv[e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++i;
    }
    // Fold the warp's RPW rows (lanes with the same sub), then the warps.
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (rsub == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) red[warp * DH + sub * 16 + e] = acc[e];
    }
    lsum = warp_sum(lsum);
    if (lane == 0) wsum[warp] = lsum;
    bar_sync_1(32 * kQ8Warps);
    if (tid < DH) {
      float o = 0.f, l = 0.f;
#pragma unroll
      for (int x = 0; x < kQ8Warps; ++x) {
        o += red[x * DH + tid];
        l += wsum[x];
      }
      finish_item<DH>(hd, o, l, live ? m : -INFINITY, bh, sp, n_split, scale, part, out);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&hempty[k & 1]);
  }
}


// Rows of each of the n_split spans of a ring of c rows: ceil(c / n_split),
// rounded up to a multiple of 4 (the trailing spans may be short or empty).
inline int span_rows(int c, int n_split) { return ((c + n_split - 1) / n_split + 3) / 4 * 4; }

// The fused pipeline's fold: launched with programmatic stream
// serialization, so that its blocks start (and read q and the fresh rows)
// while the partial kernel's last blocks run.
template <int DH>
cudaError_t launch_fold(unsigned bh, cudaStream_t s, const void* q, const void* k_new,
                        const void* v_new, const void* part, void* out, int n_split, float scale,
                        void* k_cache, void* v_cache, const void* kq_new, const void* vq_new,
                        int h, int c, long long kv_sb, long long kv_sh, const int* pos) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh);
  cfg.blockDim = dim3(DH);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attend_combine_kernel<DH>, (const __nv_bfloat16*)q,
                            (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
                            (const float*)part, (__nv_bfloat16*)out, n_split, scale,
                            (int8_t*)k_cache, (int8_t*)v_cache, (const int8_t*)kq_new,
                            (const int8_t*)vq_new, h, c, kv_sb, kv_sh, pos);
}

// Shared memory beyond the 48 KB default for decode_attend_staged_kernel<DH>
// on the current card: the attribute is the device's, so it is set once for
// each device, and kept in a set under a lock (engines launch from threads of
// their own), as resident_blocks keeps its table.
template <int DH>
cudaError_t staged_opt_in() {
  static std::mutex lock;
  static std::set<int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (done.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attend_staged_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err == cudaSuccess) done.insert(dev);
  return err;
}
// Blocks of `kernel` (`threads` a block) that the current card holds at
// once with `smem` bytes of shared memory each, asked of the card (after its
// opt-in to shared memory beyond 48 KB) once for each (device, kernel, bytes)
// and kept in a table under a lock: engines launch from their own threads.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int* blocks) {
  static std::mutex lock;
  static std::map<std::tuple<int, const void*, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(dev, (const void*)kernel, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = max(1, per_sm) * sms;
  known[key] = *blocks;
  return cudaSuccess;
}

// The split pipeline's launch of `kernel`: persistent blocks, as many as the
// card holds at once (`resident`), each taking the same count of items (the
// last ones one fewer); then, where n_split > 1, the fold, as a programmatic
// dependent launch.
template <int DH, class Kernel>
cudaError_t ring_launch(Kernel kernel, int threads, int smem, int resident, cudaStream_t s,
                        const void* q, const void* k_cache, const void* v_cache,
                        const void* k_scale, const void* v_scale, const void* k_new,
                        const void* v_new, const void* valid, void* part, void* out,
                        long long bh, int h, int c, int n_split, int span, long long kv_sb,
                        long long kv_sh, long long s_sb, long long s_sh, const int* pos,
                        int window, float scale) {
  const long long items = bh * n_split;
  const long long per_block = (items + resident - 1) / resident;
  const unsigned grid = (unsigned)((items + per_block - 1) / per_block);
  kernel<<<grid, threads, smem, s>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k_cache, (const uint8_t*)v_cache,
      (const float*)k_scale, (const float*)v_scale, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (const uint8_t*)valid, (float*)part, (__nv_bfloat16*)out,
      (int)items, (int)per_block, h, c, n_split, span, kv_sb, kv_sh, s_sb, s_sh, pos, window,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return launch_fold<DH>((unsigned)bh, s, q, k_new, v_new, part, out, n_split, scale, nullptr,
                         nullptr, nullptr, nullptr, h, c, kv_sb, kv_sh, pos);
}

// The split pipeline's kernel for the ring type: packed-int4 rings take
// decode_attend_q4_kernel; int8 rings decode_attend_q8_kernel with tiles of
// kQ8TileBytes where the card holds every (b, h, span) item at once at that
// size, else of kQ8SmallTileBytes (smaller blocks, more of them an SM).
template <int DH>
cudaError_t split_launch(bool packed4, cudaStream_t s, const void* q, const void* k_cache,
                         const void* v_cache, const void* k_scale, const void* v_scale,
                         const void* k_new, const void* v_new, const void* valid, void* part,
                         void* out, long long bh, int h, int c, int n_split, int span,
                         long long kv_sb, long long kv_sh, long long s_sb, long long s_sh,
                         const int* pos, int window, float scale) {
  // Launch `kernel` at `smem` bytes a block where the card holds at least
  // `need` of its blocks at once; `*held` says whether it did.
  auto try_launch = [&](auto kernel, int threads, int smem, long long need, bool* held) {
    *held = false;
    int resident = 0;
    if (smem > kMaxDynSmem) return cudaSuccess;
    const cudaError_t err = resident_blocks(kernel, threads, smem, &resident);
    if (err != cudaSuccess || resident < need) return err;
    *held = true;
    return ring_launch<DH>(kernel, threads, smem, resident, s, q, k_cache, v_cache, k_scale,
                           v_scale, k_new, v_new, valid, part, out, bh, h, c, n_split, span,
                           kv_sb, kv_sh, s_sb, s_sh, pos, window, scale);
  };
  bool held = false;
  cudaError_t err = cudaSuccess;
  if (packed4) {
    err = try_launch(decode_attend_q4_kernel<DH>, kQ4Threads, Q4Layout<DH>::bytes(span), 1,
                     &held);
  } else {
    err = try_launch(decode_attend_q8_kernel<DH, kQ8TileBytes>, kQ8Threads,
                     Q8Layout<DH, kQ8TileBytes>::bytes(span), bh * n_split, &held);
    if (err == cudaSuccess && !held)
      err = try_launch(decode_attend_q8_kernel<DH, kQ8SmallTileBytes>, kQ8Threads,
                       Q8Layout<DH, kQ8SmallTileBytes>::bytes(span), 1, &held);
  }
  return err == cudaSuccess && !held ? cudaErrorInvalidValue : err;
}

}  // namespace

extern "C" {

// The least dynamic shared memory the split pipeline's kernel needs for
// spans of `span` rows over int8 rings, or packed-int4 ones (packed4); -1
// for a head width it does not take.
long long dsm_decode_attend_smem_bytes(int span, int dh, int packed4) {
  if (dh == 128)
    return packed4 ? Q4Layout<128>::bytes(span) : Q8Layout<128, kQ8SmallTileBytes>::bytes(span);
  if (dh == 64)
    return packed4 ? Q4Layout<64>::bytes(span) : Q8Layout<64, kQ8SmallTileBytes>::bytes(span);
  return -1;
}

// Ring rows of one of the split pipeline kernel's tiles where the ring is
// split (for int8 rings the larger tiles: a split ring's items are few);
// -1 for a head width it does not take.
int dsm_decode_attend_tile_rows(int dh, int packed4) {
  if (dh == 128) return packed4 ? Q4Layout<128>::kRows : Q8Layout<128, kQ8TileBytes>::kRows;
  if (dh == 64) return packed4 ? Q4Layout<64>::kRows : Q8Layout<64, kQ8TileBytes>::kRows;
  return -1;
}

// part: f32 scratch of b * h * n_split * (dh + 2) values (unused, and may be
// null, at n_split = 1).  pos: the device int32 tick, the query's position;
// the ring's newest row is w = pos % c.  packed4: the rings are nibble-packed
// int4 rows of dh / 2 bytes (else int8 rows of dh).  c a multiple of 4;
// rows, scales and their (b, h) strides 16-byte aligned (the bulk copies),
// the validity rows 4-byte aligned.  Returns a cudaError_t.
int dsm_decode_attend(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale, const void* k_new,
                      const void* v_new, const void* valid, void* part, void* out,
                      long long b, int h, int c, int dh, int packed4, int n_split,
                      long long kv_sb, long long kv_sh, long long s_sb,
                      long long s_sh, const int* pos, int window,
                      float scale, void* stream) {
  const long long bh = b * h;
  if (bh == 0) return (int)cudaSuccess;
  if (n_split < 1 || c < 4 || pos == nullptr) return (int)cudaErrorInvalidValue;
  if (c % 4 || kv_sb % 16 || kv_sh % 16 || s_sb % 4 || s_sh % 4)
    return (int)cudaErrorInvalidValue;
  const int span = span_rows(c, n_split);
  cudaStream_t s = (cudaStream_t)stream;
#define DSM_DA_LAUNCH(DH)                                                                    \
  return (int)split_launch<DH>(packed4 != 0, s, q, k_cache, v_cache, k_scale, v_scale, k_new, \
                               v_new, valid, part, out, bh, h, c, n_split, span, kv_sb, kv_sh, \
                               s_sb, s_sh, pos, window, scale)
  if (dh == 128) DSM_DA_LAUNCH(128);
  if (dh == 64) DSM_DA_LAUNCH(64);
#undef DSM_DA_LAUNCH
  return (int)cudaErrorInvalidValue;
}


// Dynamic shared memory the staged kernel needs for spans of `span` rows
// (-1 for a head width it does not take).
long long dsm_decode_attend_commit_smem_bytes(int span, int dh) {
  if (dh == 128) return StagedLayout<128>::bytes(span);
  if (dh == 64) return StagedLayout<64>::bytes(span);
  return -1;
}

// The fused pipeline: the TMA-staged attention over the pre-commit ring in
// n_split spans, then the fold, which also commits kq_new / vq_new into ring
// row w = pos % c (pos the device int32 tick).  Contiguous (B, H, C, dh)
// int8 rings, (B, H, C) f32 scales, c a multiple of 4.  part: f32 scratch of
// b * h * n_split * (dh + 2) values.  Returns a cudaError_t.
int dsm_decode_attend_commit(const void* q, void* k_cache, void* v_cache,
                             const void* k_scale, const void* v_scale, const void* kq_new,
                             const void* vq_new, const void* k_new, const void* v_new,
                             const void* valid, void* part, void* out, long long b, int h,
                             int c, int dh, int n_split, const int* pos, int window,
                             float scale, void* stream) {
  const long long bh = b * h;
  if (bh == 0) return (int)cudaSuccess;
  if (n_split < 1 || c < 4 || c % 4 || pos == nullptr) return (int)cudaErrorInvalidValue;
  const int span = span_rows(c, n_split);
  const long long kv_sh = (long long)c * dh, kv_sb = h * kv_sh;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(bh * n_split);
#define DSM_DAC_LAUNCH(DH)                                                                \
  const long long smem = StagedLayout<DH>::bytes(span);                                   \
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;                              \
  cudaError_t err = staged_opt_in<DH>();                                                  \
  if (err != cudaSuccess) return (int)err;                                                \
  decode_attend_staged_kernel<DH><<<blocks, kStagedThreads, (size_t)smem, s>>>(           \
      (const __nv_bfloat16*)q, (const int8_t*)k_cache, (const int8_t*)v_cache,           \
      (const float*)k_scale, (const float*)v_scale, (const uint8_t*)valid, (float*)part,   \
      h, c, n_split, span, pos, window, scale);                                           \
  err = cudaGetLastError();                                                               \
  if (err != cudaSuccess) return (int)err;                                                \
  err = launch_fold<DH>((unsigned)bh, s, q, k_new, v_new, part, out, n_split, scale,      \
                        k_cache, v_cache, kq_new, vq_new, h, c, kv_sb, kv_sh, pos);       \
  if (err != cudaSuccess) return (int)err
  if (dh == 128) {
    DSM_DAC_LAUNCH(128);
  } else if (dh == 64) {
    DSM_DAC_LAUNCH(64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DSM_DAC_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
