// Hopper (sm_90a) kernel of the TTS voice cross-attention.
//
//   dsm_ca_decode_attend  <- dsm_tpu/ops/decode_attn.py:_ca_decode_attend_q_4d
//                            and :_ca_decode_attend_q (the head-major layout)
//
// Decode cross-attention (T=1) of bf16 queries over a static int8 voice
// source with per-row f32 scales; rows j >= s_len are padding and are never
// read.  In the TPU kernel's order (not the XLA fallback's, which
// normalises first):
//
//   s_j = (q . K_j) * (ks_j * scale)        f32, j < s_len
//   m = max_j s_j (over all real rows); e_j = exp(s_j - m); denom = sum_j e_j
//   p_j = bf16(e_j * vs_j)                   rounded before the V dot
//   out = (sum_j p_j V_j) / denom            -> bf16
//
// What bounds it on the H100: bytes.  At the TTS serving shapes (B=64,
// H=16, 625 real rows of Dh=128) one call reads 2 x 64 x 16 x 625 x 128 B =
// 164 MB of int8 plus 5 MB of scales, 50 us at 3.35 TB/s; 16 layers a tick
// (48 for tts_202501 at H=32, Dh=64).  Its arithmetic is two multiply-adds a
// byte, far below the card's ridge: one query row against S rows is a
// matrix-vector product, so no tensor cores.  What counts is bytes in
// flight (some 25 KB an SM at about a microsecond of latency under load),
// enough blocks to keep every SM busy, and few instructions a byte: at
// 3.35 TB/s an SM takes some 13 int8 values a clock, and an int-to-float
// conversion runs at 16 a clock an SM.  The kernel before this one (one
// block of 256 threads a (b, h), a warp loading one row a step, K and V in
// two serial passes, each value converted by I2F) reached 74 % of the bound
// at B=64, H=16, 53 % at Dh=64 and 30 % at a tp shard's B=32, H=8, where
// its 256 blocks gave the 132 SMs under two each, with 1 KB in flight a
// block.
//
// What the design does about it:
// - The source rows of a (b, h) are split over a thread-block cluster of n
//   blocks (n <= 8, the portable size; grid B*H*n, cluster (n, 1, 1)):
//   cluster rank r takes rows [r * span, (r + 1) * span) of the s_len real
//   rows, span = ceil(s_len / n) rounded up to 4 rows.  The wrapper picks n
//   (ops/decode_attn.py:pick_ca_cluster) so that B*H*n blocks give every SM
//   two at least: 1 at the serving batches (B*H 1,024 and 2,048), 2 at a tp
//   shard's 256, 8 at B=1.  A cluster of one is an ordinary launch (1,024
//   empty blocks launched with the cluster attribute took 4.4 us, 2.6
//   without, though the whole kernel measured the same).
// - A block's K and V rows are contiguous, so one producer warp brings them
//   into a ring of kCaStages shared-memory stages with TMA 1-D bulk copies
//   (cp.async.bulk), each stage with a "full" mbarrier that counts the
//   bytes and an "empty" one the consumer warps arrive on.  The K tiles go
//   first, then the V tiles: the first V tiles are in flight while the last
//   scores, the maximum and the probabilities are computed.  The span's
//   scales are read once into shared memory by the consumers while the
//   first tile lands.  A tile is 4 KB for a block of one and 8 KB in a
//   cluster, so that an SM keeps some 64 KB in flight at eight blocks (a
//   block of one takes 18 KB of shared memory at 625 rows, and at most 48
//   registers a thread) or at the tp shard's four.
// - Four consumer warps read a tile with 16-byte shared-memory reads: a
//   128-byte row takes 8 lanes (a 64-byte row 4), so a warp reads 4 rows a
//   step (8 at Dh=64) and a score's shuffle takes 3 steps (2).  An int8
//   value becomes an f32 by one byte permute into the mantissa of 2^23 and
//   one subtraction (exact), not by I2F, which measured 5-13 % slower.
// - The global maximum: each block reduces its span's maximum and stores it
//   into the shared memory of every other block of its cluster with a
//   4-byte st.async, which completes on that block's mbarrier; so every
//   block takes the same m over all real rows (a maximum is exact in any
//   order).  Each block then computes its p_j, its partial denominator and
//   its partial sum_j p_j V_j; ranks 1..n-1 store theirs into rank 0's
//   shared memory the same way and leave, and rank 0 sums the partials in
//   rank order, divides and writes.  No atomics and a fixed order: repeated
//   runs are bit-identical.  One cluster barrier, split: every block's
//   mbarriers are initialised before any store to a partner.  No block
//   leaves while a store to it may be in flight, since each waits on its
//   mbarriers first; the producer warp arrives at the barrier and leaves
//   once its copies are issued, so it never waits on a partner.  (Bulk
//   copies between the shared memories and a second cluster barrier cost
//   0.7-0.8 us more at B=1.)
// - One launch a call, no scratch in device memory, no host read: a call
//   can be captured in a CUDA graph.
//
// On the H100 (tools/ca_attend_variants.py) the consumers' work costs some
// 3 % over copies alone at the serving batches, where the copies reach some 85 %
// of the byte bound; at the tp shard and at B=1 the fixed cost of a
// block (its launch, its first tile, the exchanges) is what is left.
//
// Operands are addressed through (b, h) strides, so the head-major layout
// of _ca_decode_attend_q ((B*H, S, Dh)) is the same kernel with other
// strides; rows of Dh values and the S scales of one (b, h) are contiguous,
// the source 16-byte aligned.
//
// Plain C interface, loaded with ctypes (dsm_tpu_torch/ops/_build.py): the
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "tma_common.cuh"

namespace {

using namespace dsm_tma;

constexpr int kCaStages = 2;         // shared-memory stages of the copy ring
// Bytes of a stage's tile: 4 KB for a block of one (eight blocks an SM at the
// serving batches), 8 KB in a cluster (fewer blocks an SM), so that an SM
// keeps some 64 KB in flight either way (tools/ca_attend_variants.py).
constexpr int kCaTileAlone = 4096;
constexpr int kCaTileCluster = 8192;
constexpr int kCaWarps = 4;          // warps that compute; one more warp copies
constexpr int kCaThreads = 32 * (kCaWarps + 1);
// Blocks an SM holds at once, which caps a thread at 48 registers: at the
// serving batches a block of one's 18 KB of shared memory lets eight share
// an SM.  Unbounded, the compiler took 80 registers (six blocks an SM), 8-9 %
// slower at the serving shapes.
constexpr int kCaMinBlocks = 8;
constexpr int kCaConsumers = 32 * kCaWarps;
constexpr int kCaMaxCluster = 8;     // blocks of a cluster (the portable size)
constexpr int kCaMaxSmem = 232448;   // an H100 block's shared memory with the opt-in

// The 16 int8 values of a 16-byte read as floats: byte b of (u ^ 0x80808080)
// is x + 128, one byte permute puts it into the mantissa of 2^23, and one
// subtraction of 2^23 + 128 leaves x exactly.
__device__ __forceinline__ void ca_unpack(const int4 v, float* out) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u, (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u, (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | b)) - 8388736.f;
  }
}

__device__ __forceinline__ float ca_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float ca_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory: the stages of TB bytes; the barriers (full and
// empty a stage, the partners' maxima, the partners' partials); the warps'
// partial outputs, maxima and sums; the span's key scales, scores
// (probabilities once m is known) and value scales; then, in a cluster of
// n > 1 blocks only, the ranks' maxima (a float a rank) and partials (DH
// sums, the denominator, padding to 16 bytes; read by rank 0).  A block of
// one is the smallest, so that eight fit an SM at 625 rows
// (CaLayout<128, kCaTileAlone>::bytes(628, 1): 18 KB).
template <int DH, int TB>
struct CaLayout {
  static constexpr int kRows = TB / DH;   // source rows of a tile
  static constexpr int kPart = DH + 4;    // floats of a rank's partial
  static constexpr int kBars = kCaStages * TB;
  static constexpr int kRed = kBars + 16 * ((8 * (2 * kCaStages + 2) + 15) / 16);
  static constexpr int kWred = kRed + 4 * kCaWarps * DH;
  static constexpr int kSpan = kWred + 4 * 2 * kCaWarps;
  // span is a multiple of 4 rows, so the cluster's buffers start on 16 bytes
  __host__ __device__ static int cluster(int span) { return kSpan + 3 * 4 * span; }
  __host__ __device__ static int bytes(int span, int n_cl) {
    return cluster(span) + (n_cl > 1 ? 4 * kCaMaxCluster + 4 * kPart * n_cl : 0);
  }
};

// A 4-byte store into the shared memory of another block of the cluster
// (`dst` and `bar` from cluster_addr), completing on that block's mbarrier.
__device__ __forceinline__ void store_to_peer(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Grid B*H*n_cl, clusters of n_cl blocks along x: cluster rank = blockIdx.x
// mod n_cl.  Strides are in elements: q (b, h) -> q + b*q_sb + h*q_sh, DH
// values; k/v (b, h) -> base + b*kv_sb + h*kv_sh, then row j at j*DH;
// scales (b, h) -> base + b*s_sb + h*s_sh, then row j at j; out contiguous
// (B, H, DH).
template <int DH, int TB>
__global__ void __launch_bounds__(kCaThreads, kCaMinBlocks) ca_decode_attend_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_src,
    const int8_t* __restrict__ v_src, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out, int h, int s_len,
    int n_cl, int span, long long q_sb, long long q_sh, long long kv_sb, long long kv_sh,
    long long s_sb, long long s_sh, float scale) {
  using L = CaLayout<DH, TB>;
  constexpr int TR = L::kRows;
  constexpr int LPR = DH / 16;   // lanes per source row
  constexpr int RPW = 32 / LPR;  // source rows per warp and step
  extern __shared__ __align__(128) unsigned char ca_smem[];
  unsigned char* smem = ca_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kCaStages;
  uint64_t* max_bar = empty + kCaStages;
  uint64_t* part_bar = max_bar + 1;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  float* wmax = reinterpret_cast<float*>(smem + L::kWred);
  float* wsum = wmax + kCaWarps;
  float* ks_s = reinterpret_cast<float*>(smem + L::kSpan);
  float* probs = ks_s + span;
  float* vs_s = probs + span;
  float* maxima = reinterpret_cast<float*>(smem + L::cluster(span));  // rank r's at [r]
  float* recv = maxima + kCaMaxCluster;  // rank r's partial at [r kPart]

  const int bh = blockIdx.x / n_cl;
  const int rank = blockIdx.x - bh * n_cl;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = rank * span;
  const int n = max(0, min(s_len, s0 + span) - s0);  // real rows of this block's span
  const int n_tiles = (n + TR - 1) / TR;
  const bool clustered = n_cl > 1;

  if (tid == 0) {
    for (int st = 0; st < kCaStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kCaWarps);
    }
    mbar_init(max_bar, 1);
    mbar_init(part_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (clustered) {  // the partners' maxima, and at rank 0 their partials, land here
      mbar_arrive_expect_tx(max_bar, (uint32_t)(4 * (n_cl - 1)));
      if (rank == 0) mbar_arrive_expect_tx(part_bar, (uint32_t)(4 * (DH + 1) * (n_cl - 1)));
    }
  }
  __syncthreads();
  if (clustered) cluster_arrive_relaxed();  // waited for before the first store to a partner

  if (warp == kCaWarps) {  // the producer: one lane issues every copy, K tiles then V tiles
    if (lane == 0) {
      const int8_t* src[2] = {k_src + b * kv_sb + hh * kv_sh + (int64_t)s0 * DH,
                              v_src + b * kv_sb + hh * kv_sh + (int64_t)s0 * DH};
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int pass = i >= n_tiles;
        const int t = i - pass * n_tiles;
        const int st = i % kCaStages;
        mbar_wait(&empty[st], ((i / kCaStages) & 1) ^ 1);  // the first round passes
        const uint32_t bytes = (uint32_t)min(TR, n - t * TR) * DH;
        mbar_arrive_expect_tx(&full[st], bytes);
        bulk_copy(smem + st * TB, src[pass] + (int64_t)t * TR * DH, bytes, &full[st]);
      }
    }
    return;
  }

  // The consumers: 128 threads; a lane reads bytes [16 sub, 16 sub + 16) of
  // row rsub of its warp's step.
  const int sub = lane % LPR;
  const int rsub = lane / LPR;
  float qf[16];
  {
    const __nv_bfloat16* qp = q + b * q_sb + hh * q_sh + sub * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) qf[e] = __bfloat162float(qp[e]);
  }
  {
    const float* ksp = k_scale + b * s_sb + hh * s_sh + s0;
    const float* vsp = v_scale + b * s_sb + hh * s_sh + s0;
    for (int j = tid; j < n; j += kCaConsumers) {
      ks_s[j] = ksp[j];
      vs_s[j] = vsp[j];
    }
  }
  bar_sync_1(kCaConsumers);

  // K tiles: the scores of the span's rows.
  float local_max = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kCaStages;
    mbar_wait(&full[st], (t / kCaStages) & 1);
    const int rows = min(TR, n - t * TR);
    const unsigned char* tile = smem + st * TB;
    for (int r0 = warp * RPW; r0 < rows; r0 += kCaWarps * RPW) {
      const int r = r0 + rsub;
      float acc = 0.f;
      if (r < rows) {
        float kv[16];
        ca_unpack(*reinterpret_cast<const int4*>(tile + r * DH + sub * 16), kv);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0 && r < rows) {
        const int j = t * TR + r;
        const float s = acc * (ks_s[j] * scale);
        probs[j] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // The span's maximum, then every rank's: the global m over all real rows.
  local_max = ca_warp_max(local_max);
  if (lane == 0) wmax[warp] = local_max;
  bar_sync_1(kCaConsumers);
  float m = wmax[0];
#pragma unroll
  for (int k = 1; k < kCaWarps; ++k) m = fmaxf(m, wmax[k]);
  if (clustered) {
    cluster_wait();  // every partner's barriers are initialised
    if (tid < n_cl && tid != rank)
      store_to_peer(cluster_addr(maxima + rank, tid), m, cluster_addr(max_bar, tid));
    mbar_wait(max_bar, 0);
    for (int p = 0; p < n_cl; ++p) {
      if (p != rank) m = fmaxf(m, maxima[p]);
    }
  }

  // Probabilities bf16(e_j * vs_j) in place of the scores, and the span's
  // part of the denominator.
  float lsum = 0.f;
  for (int j = tid; j < n; j += kCaConsumers) {
    const float e = expf(probs[j] - m);
    lsum += e;
    probs[j] = __bfloat162float(__float2bfloat16(e * vs_s[j]));
  }
  lsum = ca_warp_sum(lsum);
  if (lane == 0) wsum[warp] = lsum;
  bar_sync_1(kCaConsumers);

  // V tiles: the probabilities times the rows.
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int i = n_tiles + t;
    const int st = i % kCaStages;
    mbar_wait(&full[st], (i / kCaStages) & 1);
    const int rows = min(TR, n - t * TR);
    const unsigned char* tile = smem + st * TB;
    for (int r = warp * RPW + rsub; r < rows; r += kCaWarps * RPW) {
      const float p = probs[t * TR + r];
      float vv[16];
      ca_unpack(*reinterpret_cast<const int4*>(tile + r * DH + sub * 16), vv);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += p * vv[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Fold the warp's RPW row groups (lanes with the same sub), then the warps
  // in warp order.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (rsub == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[warp * DH + sub * 16 + e] = acc[e];
  }
  bar_sync_1(kCaConsumers);
  float o = 0.f;
  if (tid < DH) {
#pragma unroll
    for (int k = 0; k < kCaWarps; ++k) o += red[k * DH + tid];
  }
  float den = wsum[0];
#pragma unroll
  for (int k = 1; k < kCaWarps; ++k) den += wsum[k];

  if (!clustered) {
    if (tid < DH) out[(int64_t)bh * DH + tid] = __float2bfloat16(o / den);
    return;
  }
  if (rank != 0) {  // this block's partial to rank 0, which waits for it before it leaves
    if (tid < DH)
      store_to_peer(cluster_addr(recv + rank * L::kPart + tid, 0), o, cluster_addr(part_bar, 0));
    if (tid == 0)
      store_to_peer(cluster_addr(recv + rank * L::kPart + DH, 0), den,
                    cluster_addr(part_bar, 0));
    return;
  }
  // Rank 0: every rank's partial in rank order, then the division.
  mbar_wait(part_bar, 0);
  if (tid < DH) {
    for (int p = 1; p < n_cl; ++p) {
      o += recv[p * L::kPart + tid];
      den += recv[p * L::kPart + DH];
    }
    out[(int64_t)bh * DH + tid] = __float2bfloat16(o / den);
  }
}

// Shared memory beyond the 48 KB default for ca_decode_attend_kernel<DH> on
// the current card: the attribute is the device's, so it is set once for
// each device, and kept in a set under a lock (engines launch from threads
// of their own).
template <int DH, int TB>
cudaError_t ca_opt_in() {
  static std::mutex lock;
  static std::set<int> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (done.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(ca_decode_attend_kernel<DH, TB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kCaMaxSmem);
  if (err == cudaSuccess) done.insert(dev);
  return err;
}

// Source rows of each cluster rank's span: ceil(s_len / n_cl) rounded up to
// 4 (ops/decode_attn.py:span_rows), so that a span's first row lies on 256
// bytes of the source.
int ca_span(int s_len, int n_cl) { return ((s_len + n_cl - 1) / n_cl + 3) / 4 * 4; }

template <int DH, int TB>
cudaError_t ca_launch(const void* q, const void* k_src, const void* v_src, const void* k_scale,
                      const void* v_scale, void* out, long long bh, int h, int s_len, int n_cl,
                      long long q_sb, long long q_sh, long long kv_sb, long long kv_sh,
                      long long s_sb, long long s_sh, float scale, cudaStream_t stream) {
  cudaError_t err = ca_opt_in<DH, TB>();
  if (err != cudaSuccess) return err;
  const int span = ca_span(s_len, n_cl);
  const int smem = CaLayout<DH, TB>::bytes(span, n_cl);
  if (smem > kCaMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)n_cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bh * n_cl));
  cfg.blockDim = dim3(kCaThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = n_cl > 1 ? 1 : 0;  // a block of one: an ordinary launch
  return cudaLaunchKernelEx(&cfg, ca_decode_attend_kernel<DH, TB>, (const __nv_bfloat16*)q,
                            (const int8_t*)k_src, (const int8_t*)v_src, (const float*)k_scale,
                            (const float*)v_scale, (__nv_bfloat16*)out, h, s_len, n_cl, span,
                            q_sb, q_sh, kv_sb, kv_sh, s_sb, s_sh, scale);
}

// The instance for a cluster of n_cl blocks: F<DH, its tile bytes>(args...).
#define DSM_CA_DISPATCH(F, DH, ...) \
  (n_cl > 1 ? F<DH, kCaTileCluster>(__VA_ARGS__) : F<DH, kCaTileAlone>(__VA_ARGS__))

template <int DH>
long long ca_smem_bytes(int span, int n_cl) {
  return n_cl > 1 ? CaLayout<DH, kCaTileCluster>::bytes(span, n_cl)
                  : CaLayout<DH, kCaTileAlone>::bytes(span, n_cl);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block whose span holds `span` source rows, in
// a cluster of n_cluster blocks.
long long dsm_ca_decode_attend_smem_bytes(int span, int dh, int n_cluster) {
  if (dh == 128) return ca_smem_bytes<128>(span, n_cluster);
  if (dh == 64) return ca_smem_bytes<64>(span, n_cluster);
  return -1;
}

// q (B, H, dh) bf16 through strides; k_src / v_src int8, each (b, h)'s rows
// contiguous and 16-byte aligned; scales f32, each (b, h)'s contiguous; out
// contiguous (B, H, dh) bf16.  The rows of a (b, h) are split over a cluster
// of n_cluster blocks (1 to 8).  Returns a cudaError_t.
int dsm_ca_decode_attend(const void* q, const void* k_src, const void* v_src,
                         const void* k_scale, const void* v_scale, void* out, long long b,
                         int h, int s_len, int dh, long long q_sb, long long q_sh,
                         long long kv_sb, long long kv_sh, long long s_sb, long long s_sh,
                         int n_cluster, float scale, void* stream) {
  const long long bh = b * h;
  const int n_cl = n_cluster;
  if (bh == 0) return (int)cudaSuccess;
  if (s_len < 1 || n_cl < 1 || n_cl > kCaMaxCluster ||
      ((uintptr_t)k_src | (uintptr_t)v_src) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dh == 128) {
    err = DSM_CA_DISPATCH(ca_launch, 128, q, k_src, v_src, k_scale, v_scale, out, bh, h, s_len,
                          n_cl, q_sb, q_sh, kv_sb, kv_sh, s_sb, s_sh, scale, s);
  } else if (dh == 64) {
    err = DSM_CA_DISPATCH(ca_launch, 64, q, k_src, v_src, k_scale, v_scale, out, bh, h, s_len,
                          n_cl, q_sb, q_sh, kv_sb, kv_sh, s_sb, s_sh, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
