// Hopper (sm_90a) kernels of the int8 ring attention at T=1: the split
// pipeline's decode attention and the fused pipeline's attention + commit.
//
//   dsm_decode_attend         <- dsm_tpu/ops/decode_attn.py:_decode_attend_q_flash
//     with packed4 = 1        <- dsm_tpu/ops/decode_attn.py:_decode_attend_q4_4d
//                                and :_decode_attend_q4 (the head-major layout)
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
// chunks are blocks that run in parallel: grid (B*H * n_split), each block
// reduces its span of ring rows to one partial (acc[Dh], m, l) in f32, and a
// second small kernel folds the partials and the fresh row in a fixed order
// (no atomics: repeated runs are bit-identical); for the fused pipeline the
// same second kernel writes the committed row w.  No partial block reads
// row w's bytes into the result, and the second kernel reads a partial or
// writes a ring row only once the whole partial grid has finished (stream
// order; in the fused pipeline, where the second kernel is launched with
// programmatic stream serialization so that its blocks start during the
// first one's tail, griddepcontrol.wait), so the in-place commit needs no
// other ordering.
//
// decode_attend_partial_kernel (dsm_decode_attend): a lane loads 16 bytes
// of a row into registers, so a 128-byte row takes 8 lanes and a warp reads
// 4 rows per step (8 rows at Dh=64) with a 3-step (2-step) shuffle each.
// Rows the mask excludes are never read, and a span without an attended row
// exits with m = -inf, l = 0 after reading nothing, so a ring that is not
// yet full is not read past pos and exp(-1e9 - -1e9) = 1 cannot arise.  A
// lane keeps one 16-byte load in flight: 4 KB a block, 24 KB an SM at six
// blocks.
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
// each stored excess-8 (dsm_tpu/ops/attention.py:pack4).  The body is the
// same; only the load differs.  A lane's 16-byte load now holds 32 values of
// one row: 16 neighbouring dims of the first half of the feature dim in the
// low nibbles and the 16 dims Dh/2 further on in the high nibbles, so the
// lane keeps those 32 entries of q (and 32 output sums) and a row takes
// Dh/32 lanes: a warp reads 8 rows per step at Dh=128 and 16 at Dh=64.  The
// values are (nibble - 8) as f32: the products with bf16 q and the
// bf16-rounded probs are the Pallas kernels' bf16 x bf16 -> f32 dots.  A
// never-written row is all zero bytes, which unpack to -8: it is masked by
// the bitmap and never read.  What bounds it: half the int8 ring's bytes for
// the same count of values, so the operations per value weigh twice as much:
// the unpack is a shift, one logic operation and one f32 subtraction a value
// (unpack_load, attn_common.cuh).
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): each
// entry point launches both of its kernels on the caller's stream, does not
// synchronise, allocates nothing (the caller passes the partials' scratch)
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "tma_common.cuh"

namespace {

using namespace dsm_attn;
using namespace dsm_tma;

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
// With kq_new (the fused pipeline) it also commits this step's int8 rows
// kq_new / vq_new (contiguous (B*H, DH)) into ring row w, addressed as the
// partial kernels address the rings.
template <int DH>
__global__ void __launch_bounds__(DH) decode_attend_combine_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int n_split, float scale, int8_t* __restrict__ k_cache,
    int8_t* __restrict__ v_cache, const int8_t* __restrict__ kq_new,
    const int8_t* __restrict__ vq_new, int h, long long kv_sb, long long kv_sh, int w) {
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
  // Launched after the partial kernel with programmatic stream serialization
  // (the fused pipeline), this block may have started while that kernel still
  // runs: wait here for all of it, its partials and its reads of the ring.
  // Launched the usual way (dsm_decode_attend), there is nothing to wait for.
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
// part (B*H, n_split, DH + 2) as decode_attend_partial_kernel writes it.
template <int DH>
__global__ void __launch_bounds__(kStagedThreads) decode_attend_staged_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_cache,
    const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const uint8_t* __restrict__ valid,
    float* __restrict__ part, int h, int c, int n_split, int span, long long pos, int w,
    int window, float scale) {
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
                        int h, long long kv_sb, long long kv_sh, int w) {
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
                            (const int8_t*)vq_new, h, kv_sb, kv_sh, w);
}

template <int DH>
cudaError_t staged_opt_in() {
  // Once per template instance: shared memory beyond the 48 KB default.
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attend_staged_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  return err;
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
  const int span = span_rows(c, n_split);
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
      n_split, scale, nullptr, nullptr, nullptr, nullptr, h, kv_sb, kv_sh, w)
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

// Dynamic shared memory the staged kernel needs for spans of `span` rows
// (-1 for a head width it does not take).
long long dsm_decode_attend_commit_smem_bytes(int span, int dh) {
  if (dh == 128) return StagedLayout<128>::bytes(span);
  if (dh == 64) return StagedLayout<64>::bytes(span);
  return -1;
}

// The fused pipeline: the TMA-staged attention over the pre-commit ring in
// n_split spans, then the fold, which also commits kq_new / vq_new into ring
// row w.  Contiguous (B, H, C, dh) int8 rings, (B, H, C) f32 scales, c a
// multiple of 4.  part: f32 scratch of b * h * n_split * (dh + 2) values.
// Returns a cudaError_t.
int dsm_decode_attend_commit(const void* q, void* k_cache, void* v_cache,
                             const void* k_scale, const void* v_scale, const void* kq_new,
                             const void* vq_new, const void* k_new, const void* v_new,
                             const void* valid, void* part, void* out, long long b, int h,
                             int c, int dh, int n_split, long long pos, int w, int window,
                             float scale, void* stream) {
  const long long bh = b * h;
  if (bh == 0) return (int)cudaSuccess;
  if (n_split < 1 || c < 4 || c % 4 || w < 0 || w >= c) return (int)cudaErrorInvalidValue;
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
      h, c, n_split, span, pos, w, window, scale);                                        \
  err = cudaGetLastError();                                                               \
  if (err != cudaSuccess) return (int)err;                                                \
  err = launch_fold<DH>((unsigned)bh, s, q, k_new, v_new, part, out, n_split, scale,      \
                        k_cache, v_cache, kq_new, vq_new, h, kv_sb, kv_sh, w);            \
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
