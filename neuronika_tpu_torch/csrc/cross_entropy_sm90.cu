// K8, K9 and K10 in bf16 on Hopper: the fused cross-entropy forward and
// its input and weight gradients on wgmma, TMA and thread block clusters.
//
// Replaces, for bf16 operands whose D is a multiple of 8 (TMA's 16-byte
// rows), the kernels of neuronika_tpu/ops/pallas/cross_entropy.py
//   K8  _ce_fwd_kernel  loss_i = lse_i - x_i W_{t_i}^T, lse_i =
//       logsumexp_j x_i W_j^T (any D)
// and, for D at most kMaxCluster kSlice-wide slices (1536),
//   K9  _ce_dx_kernel
//       dx = sum_j cast(g_i (exp(x_i W_j^T - lse_i) - onehot(t_i)_j)) W_j
//   K10 _ce_dw_kernel
//       dW = sum_i cast(g_i (exp(x_i W^T - lse_i) - onehot(t_i)))^T x_i
// with x (N, D), W (V, D) bf16 row-major, targets (N,) int32, lse and the
// row weights g (N,) f32, and cast() the rounding of p g to bf16 before the
// second product, as the TPU kernels round it. A target outside [0, V)
// matches no column. f32 and the other D stay on cross_entropy.cu's
// template; ops/cross_entropy.py::ce_fwd_route and ce_grad_route decide by
// shape alone.
//
// What bounds them: 2 N V D (K8) or 4 N V D (K9, K10) operations against
// (N + V) D bytes; at the GPT train step's N 32768, V 16384, D 1536 the
// tensor cores (989 TFLOP/s). All three run one logits walk
// (produce_logits, consume_logits): a CTA owns kOwn = 128 rows (two
// consumer warpgroups of 64, a producer warpgroup with setmaxnreg) and
// streams the other operand's rows in tiles, S = own . stream^T summed
// over D by SS wgmma, both operands K-major in 64-column
// 128-byte-swizzled panels that one producer thread keeps in flight by
// TMA through a ring of mbarriers.
//
// K8 (ce_fwd_sm90_kernel) owns x rows and streams W in kFwdStream = 256-row
// vocabulary tiles (m64n256k16: 85 operations a byte from L2, against 64
// at 128 rows). Each consumer thread runs an online softmax over its own
// columns of its two rows, in the exp2 domain, straight on the
// accumulator: no shared memory and no CTA-wide barrier a tile; the
// columns past V (TMA's zero rows) are set to -inf first, and the target's
// logit is picked by its column. The quad's four partials merge by
// shuffles once, after the walk. The trap is L2: one CTA per SM, each
// walking all of V against its own 384 KB x block (D 1536), would hold
// 132 x 384 KB = 50.7 MB of x, more than the 50 MB L2, and each block is
// read again for every tile. So the CTAs of one cluster share an x block,
// each taking a contiguous range of the vocabulary tiles (at most
// kMaxCluster, the portable cluster size): 16.5 x blocks live at once.
// Each CTA writes its rows' (max, sum, target logit) into rank 0's shared
// memory (st.shared::cluster) and arrives on rank 0's mbarrier; rank 0
// merges them in rank order: the same bits every launch, no second launch
// and no scratch in device memory. The (N, V) logits never leave the SM.
//
// K9 and K10 (ce_grad_sm90_kernel<DX>) have the shape of the flash dk/dv
// walk: one operand's rows are owned (the keys there), the other's
// streamed (the queries), with the lse of each x row known (no online
// softmax); the difference is the depth: D is 1536, so the output is
// sliced. K10 owns W rows and streams x, K9 owns x rows and streams W;
// only which map is which, and the side of the per-row lse, g and target,
// differ.
//
// The design of K9 and K10:
//   * A CTA owns kOwn = 128 rows and one kSlice = 192-column slice of D:
//     its output accumulator is 64 x 192 f32 a warpgroup (96 registers a
//     thread). The ceil(D / 192) slices of one own block are one cluster
//     (8 CTAs at D 1536); the cluster rank is the slice.
//   * The stream rows are walked in tiles of kStream = 128, in rounds of
//     cs tiles (cs the cluster size). In round r, CTA u computes the
//     logits of tile r cs + u over all of D (the shared walk, m64n128k16).
//     It turns them into cast(p g) in registers, as wgmma A fragments (M
//     the own rows, K the stream rows), and writes those to its own shared
//     memory (double-buffered by round parity), in fragment order: the
//     thread of the same index in every CTA holds the same rows of every
//     tile.
//   * One mbarrier a round per CTA, counting one release-arrival from each
//     CTA of the cluster, says that every tile of the round is written.
//     Then each CTA runs out_slice += P_v . stream_v[:, slice] over the
//     round's tiles, half a tile (64 stream rows) a step: RS wgmma with
//     P_v's A fragments read from CTA v's shared memory (ld.shared::cluster
//     straight into registers, the next half's issued while the current
//     half's products run) and the half's slice from the ring, MN-major
//     (the transpose bit), one product per 64-column panel. CTA u takes
//     the tiles in the order u, u + 1, .. (mod cs): at each step every
//     CTA reads a different peer, where one order for all had every CTA
//     read the same peer at once (11.0 against 8.5 ms, 64-row tiles, at
//     the head shape on an H100). A round's wait also proves that every
//     CTA finished reading the buffer the next round overwrites: it read
//     those before it arrived. The logits are computed once, 4 N V D in
//     all.
//   * Each CTA sums its stream tiles in a fixed order: dx and dW are the
//     same bits every launch, with no atomics and no second pass.
//   * Rows past either end arrive as zeros from TMA. K10's stream rows
//     past N get p = 0 from lse +inf and g 0; K9's stream rows past V would
//     read p = exp(-lse), so their columns are masked to p = 0, and its own
//     rows past N get lse +inf and g 0. Own rows past the end and columns
//     past D are masked at the store. The one-hot compares the absolute
//     vocabulary index. K10 loads the stream rows' statistics a round, K9
//     its own rows' once.
// Each CTA reads its own block's panels from L2 once a round: 384 KB of
// the 1.15 MB a round moves at D 1536. Times of K10 on an H100 SXM (700 W)
// at the head shape: multicasting the panels across the cluster (each CTA
// loading 16 of the 128 rows) made K10 slower, 19.6 against 11.0 ms with
// 64-row tiles, as every stage then waited for all 8 CTAs' consumers;
// 128-row tiles halve the own block's share instead (8.6 -> 6.0 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef long long ll;
using bf16 = __nv_bfloat16;

constexpr int kOwn = 128;                // own rows a CTA: two warpgroups
constexpr int kStream = 128;             // stream rows a tile
constexpr int kSlice = 192;              // D columns a CTA accumulates
constexpr int kSlicePanels = kSlice / 64;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kRegsProducer = 24, kRegsConsumer = 240;
constexpr uint32_t kPanel = 64 * 128;    // 64 rows of 64 bf16: 8 KB
// a stage: the logits' own panel and stream panel (128 rows each: 32 KB),
// or half a tile's slice (64 stream rows x 3 panels: 24 KB)
constexpr uint32_t kLogitsBytes = 4 * kPanel, kHalfBytes = 3 * kPanel;
constexpr uint32_t kStage = kLogitsBytes;
constexpr int kStages = 5;
constexpr uint32_t kPTile = kOwn * kStream * 2;   // a tile's cast(p g)
constexpr size_t kSmem = (size_t)kStages * kStage + 2 * kPTile +
                         8 * (2 * kStages + 1) + 3 * 4 * kStream + 1024;
// K8: W rows a vocabulary tile (the wgmma's N: 128 f32 accumulators a
// consumer thread); a stage is the x block's panel and the tile's (48 KB)
constexpr int kFwdStream = 256;
constexpr uint32_t kFwdStage = (2 + kFwdStream / 64) * kPanel;
constexpr int kFwdStages = 4;
constexpr size_t kFwdSmem = (size_t)kFwdStages * kFwdStage +
                            16 * kMaxCluster * kOwn +
                            8 * (2 * kFwdStages + 1) + 1024;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// A fragments of a consumer thread for 64 stream rows: 4 k16 slices of 4
// registers (a tile is two such halves)
typedef uint32_t Frags[4][4];

// this thread's fragments of half h of a tile in the CTA at map address
// `peer` (fragment order: [warpgroup][k16 slice][thread] x 16 bytes)
__device__ __forceinline__ void load_frags(Frags& a, uint32_t peer, int h) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    ld_cluster(a[k], peer + (4 * h + k) * 128 * 16);
}

// out (3 panels of 64 x 64) += P (64 x 64 stream rows) . their slice
__device__ __forceinline__ void slice_product(float (&acc)[kSlicePanels][32],
                                              const Frags& a, uint32_t st) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int p = 0; p < kSlicePanels; ++p)
      wgmma_rs<1>(acc[p], a[k], sw128_desc(st + p * kPanel + k * 2048));
}

// The logits walk that K8, K9 and K10 share: S = own block (kOwn rows) .
// stream tile (NS rows)^T over all of D, 64 columns a stage. A stage holds
// the own block's panel (two 64-row panels, 16 KB) and, right after it,
// the stream tile's NS / 64 panels; `stage` is the ring's stage size.
// The producer thread's part: the kd stages of one tile, from the own rows
// o0 and the stream rows s0 (rows past either end read as zeros).
template <int NS>
__device__ __forceinline__ void produce_logits(
    unsigned char* smem, uint32_t stage, int stages, uint64_t* full,
    uint64_t* empty, int& it, const CUtensorMap* own_map,
    const CUtensorMap* stream_map, int o0, int s0, int kd) {
  for (int k = 0; k < kd; ++k, ++it) {
    const int s = it % stages;
    unsigned char* st = smem + s * stage;
    mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
    mbar_expect_tx(full + s, (2 + NS / 64) * kPanel);
    tma_load_3d(st, own_map, full + s, 64 * k, o0, 0);
#pragma unroll
    for (int h = 0; h < NS / 64; ++h)
      tma_load_3d(st + (2 + h) * kPanel, stream_map, full + s, 64 * k,
                  s0 + 64 * h, 0);
  }
}

// A consumer warpgroup's part: its 64 own rows' logits of the tile in sc
// (64 x NS f32, the wgmma accumulator layout: sc[4 j + e] is row 16 warp +
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2), every stage
// freed once its products are done
template <int NS>
__device__ __forceinline__ void consume_logits(float (&sc)[NS / 2],
                                               uint32_t base, uint32_t stage,
                                               int stages, uint64_t* full,
                                               uint64_t* empty, int& it,
                                               int kd, int wg) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) sc[i] = 0.f;
  for (int k = 0; k < kd; ++k, ++it) {
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    const uint32_t st = base + s * stage;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wgmma_ss<0, 0>(sc, sw128_desc(st + wg * 64 * 128 + 32 * q),
                     sw128_desc(st + 2 * kPanel + 32 * q), k > 0 || q > 0);
    wgmma_commit();
    wgmma_wait<1>();
    keep(sc);
    if (k > 0) mbar_arrive(empty + (it - 1) % stages);
  }
  wgmma_wait<0>();
  keep(sc);
  mbar_arrive(empty + (it - 1) % stages);
}

// DX: K9 (x rows owned, W rows streamed) or K10 (W rows owned, x rows
// streamed); own_map has boxes of 64 x kOwn rows, stream_map of 64 x 64
template <bool DX>
__global__ void __launch_bounds__(kThreads, 1)
    ce_grad_sm90_kernel(const __grid_constant__ CUtensorMap own_map,
                        const __grid_constant__ CUtensorMap stream_map,
                        const int* __restrict__ tgt,
                        const float* __restrict__ lse,
                        const float* __restrict__ g, bf16* __restrict__ out,
                        int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ptile = smem + kStages * kStage;    // [2][kPTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ptile + 2 * kPTile);
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;
  float* s_lse = reinterpret_cast<float*>(ready + 1);  // K10: the stream
  float* s_g = s_lse + kStream;                        // rows of the own
  int* s_t = reinterpret_cast<int*>(s_g + kStream);    // tile
  const int n_own = DX ? N : V, n_stream = DX ? V : N;
  const int cs = (int)gridDim.x;
  const int rank = (int)cluster_rank();
  const int o0 = blockIdx.y * kOwn, d0 = rank * kSlice;
  const int kd = (D + 63) / 64;                        // logits k steps
  const int ntiles = (n_stream + kStream - 1) / kStream;
  const int rounds = (ntiles + cs - 1) / cs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(ready, cs);
    mbar_fence_init();
  }
  cluster_sync_all();   // every CTA's barriers ready before any arrival

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<kRegsProducer>();
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int r = 0; r < rounds; ++r) {
      produce_logits<kStream>(smem, kStage, kStages, full, empty, it,
                              &own_map, &stream_map, o0,
                              (r * cs + rank) * kStream, kd);
      // then the slices of the round's tiles, half a tile (64 stream rows)
      // a stage: the (rank + i / 2)-th tile's half i % 2
      for (int i = 0; i < 2 * cs; ++i, ++it) {
        const int s = it % kStages;
        unsigned char* st = smem + s * kStage;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        const int row = (r * cs + (rank + i / 2) % cs) * kStream +
                        64 * (i % 2);
        mbar_expect_tx(full + s, kHalfBytes);
#pragma unroll
        for (int p = 0; p < kSlicePanels; ++p)
          tma_load_3d(st + p * kPanel, &stream_map, full + s, d0 + 64 * p,
                      row, 0);
      }
    }
    return;
  }
  regs_inc<kRegsConsumer>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t base = smem_u32(smem);
  // K9: the lse, g and target of this thread's own rows (those of orow
  // below), loaded once (rows past N: p = 0)
  float r_lse[2] = {0.f, 0.f}, r_g[2] = {0.f, 0.f};
  int r_t[2] = {-1, -1};
  if constexpr (DX) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = o0 + wg * 64 + warp * 16 + lane / 4 + 8 * x;
      const bool in = i < N;
      r_lse[x] = in ? lse[i] : INFINITY;
      r_g[x] = in ? g[i] : 0.f;
      r_t[x] = in ? tgt[i] : -1;
    }
  }
  float acc[kSlicePanels][32];
#pragma unroll
  for (int p = 0; p < kSlicePanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  int it = 0;
  for (int r = 0; r < rounds; ++r) {
    const int s0 = (r * cs + rank) * kStream;
    if (!DX && threadIdx.x < kStream) {   // read after the logits' barrier
      const int i = s0 + threadIdx.x;
      const bool in = i < N;
      s_lse[threadIdx.x] = in ? lse[i] : INFINITY;
      s_g[threadIdx.x] = in ? g[i] : 0.f;
      s_t[threadIdx.x] = in ? tgt[i] : -1;
    }
    // logits of the own stream tile: S (64 own rows x 128 stream rows)
    // over all of D
    float sc[64];
    consume_logits<kStream>(sc, base, kStage, kStages, full, empty, it, kd,
                            wg);
    if constexpr (!DX) named_sync(1, kConsumers);   // statistics written
    // cast(p g) as A fragments: sc[4 j + e] is own row orow + 8 (e / 2),
    // stream row s0 + 8 j + 2 (lane % 4) + e % 2; k16 slice k of the
    // stream rows is register group own_a[k]. K10 keys p by the stream
    // row's statistics and compares its target with the own (vocabulary)
    // row; K9 by the own row's, comparing its target with the stream row,
    // and stream rows past V (TMA's zeros, whose p would be exp(-lse))
    // are masked to 0.
    const int orow = o0 + wg * 64 + warp * 16 + lane / 4;
    uint32_t own_a[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = 8 * k + 2 * q, x = q & 1, j = orow + 8 * x;
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * k + 8 * (q >> 1) + 2 * (lane % 4) + e;
          if constexpr (DX) {
            const int col = s0 + c;
            pv[e] = col < V ? (expf(sc[idx + e] - r_lse[x]) -
                               (r_t[x] == col ? 1.f : 0.f)) * r_g[x]
                            : 0.f;
          } else {
            pv[e] = (expf(sc[idx + e] - s_lse[c]) -
                     (s_t[c] == j ? 1.f : 0.f)) * s_g[c];
          }
        }
        own_a[k][q] = pack_bf16(pv[0], pv[1]);
      }
    const uint32_t frag_off =
        (uint32_t)((r & 1) * kPTile + (wg * 8 * 128 + tid) * 16);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      *reinterpret_cast<uint4*>(ptile + frag_off + k * 128 * 16) =
          make_uint4(own_a[k][0], own_a[k][1], own_a[k][2], own_a[k][3]);
    fence_cluster();
    named_sync(1, kConsumers);   // the whole tile written
    if (threadIdx.x < cs) mbar_arrive_cluster(map_rank(ready, threadIdx.x));
    mbar_wait_cluster(ready, r & 1);
    // out_slice += P_v . stream_v[:, slice] over the round's tiles, half a
    // tile (64 stream rows) a step, CTA u in the order u, u + 1, .. (mod
    // cs), so that at each step every CTA reads a different peer; two
    // fragment buffers, the next half's read from its CTA while this
    // half's products run
    Frags a0, a1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) a0[k][q] = own_a[k][q];
    for (int v = 0; v < 2 * cs; v += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = v + h;
        Frags& cur = h ? a1 : a0;
        Frags& nxt = h ? a0 : a1;
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        wgmma_fence();
        slice_product(acc, cur, base + s * kStage);
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int p = 0; p < kSlicePanels; ++p) keep(acc[p]);
        if (u > 0) {
          keep(nxt);   // half u - 1's fragments, free now
          mbar_arrive(empty + (it - 1) % kStages);
        }
        if (u + 1 < 2 * cs)
          load_frags(nxt, map_rank(ptile, (rank + (u + 1) / 2) % cs) +
                              frag_off, (u + 1) % 2);
        ++it;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < kSlicePanels; ++p) keep(acc[p]);
    keep(a0);
    keep(a1);
    mbar_arrive(empty + (it - 1) % kStages);
  }
  // no CTA leaves while a peer may still read its tiles
  named_sync(1, kConsumers);
  if (threadIdx.x < cs) mbar_arrive_cluster(map_rank(ready, threadIdx.x));
  mbar_wait_cluster(ready, rounds & 1);

  // acc[p][4 q + 2 x + e]: own row 16 warp + lane / 4 + 8 x of the
  // warpgroup's 64, column 64 p + 8 q + 2 (lane % 4) + e of the slice
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = o0 + wg * 64 + warp * 16 + lane / 4 + 8 * x;
    if (row >= n_own) continue;
    bf16* dst = out + (ll)row * D;
#pragma unroll
    for (int p = 0; p < kSlicePanels; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = d0 + 64 * p + 8 * q + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[p][4 * q + 2 * x],
                                    acc[p][4 * q + 2 * x + 1]);
      }
  }
}

// K8: x rows owned (kOwn a cluster), W streamed in kFwdStream-row
// vocabulary tiles; CTA `rank` of a cluster of cs walks the tiles
// [rank T / cs, (rank + 1) T / cs) of the T = ceil(V / kFwdStream)
__global__ void __launch_bounds__(kThreads, 1)
    ce_fwd_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const int* __restrict__ tgt, float* __restrict__ loss,
                       float* __restrict__ lse, int N, int V, int D) {
  constexpr int NS = kFwdStream;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // every rank's (m, s, target logit) of the block's rows, in rank 0
  float4* part = reinterpret_cast<float4*>(smem + kFwdStages * kFwdStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kMaxCluster * kOwn);
  uint64_t* empty = full + kFwdStages;
  uint64_t* merged = empty + kFwdStages;
  const int cs = (int)gridDim.x;
  const int rank = (int)cluster_rank();
  const int o0 = blockIdx.y * kOwn;
  const int kd = (D + 63) / 64;
  const int ntiles = (V + NS - 1) / NS;
  const int t0 = rank * ntiles / cs, t1 = (rank + 1) * ntiles / cs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init(merged, cs);
    mbar_fence_init();
  }
  cluster_sync_all();   // rank 0's barrier ready before any arrival

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<kRegsProducer>();
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int t = t0; t < t1; ++t)
      produce_logits<NS>(smem, kFwdStage, kFwdStages, full, empty, it,
                         &x_map, &w_map, o0, t * NS, kd);
    return;
  }
  regs_inc<kRegsConsumer>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t base = smem_u32(smem);
  // this thread's rows (x = 0, 1) of the warpgroup's 64 and, in each tile,
  // its columns 8 j + c + e; the target as a column of the thread's (-1:
  // no target in [0, V), or a row past N)
  const int rl = wg * 64 + warp * 16 + lane / 4, c = 2 * (lane % 4);
  int r_t[2];
  float m[2], s[2], hit[2];   // running max (log2 units), sum, logit
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = o0 + rl + 8 * x;
    const int t = i < N ? tgt[i] : -1;
    r_t[x] = t >= 0 && t < V ? t : -1;
    m[x] = -INFINITY;
    s[x] = 0.f;
    hit[x] = 0.f;
  }
  int it = 0;
  float sc[NS / 2];
  for (int t = t0; t < t1; ++t) {
    consume_logits<NS>(sc, base, kFwdStage, kFwdStages, full, empty, it, kd,
                       wg);
    const int v0 = t * NS + c;    // this thread's first column
    if (t * NS + NS > V) {        // the last tile: TMA's zero rows past V
#pragma unroll                    // would enter as logits 0
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (v0 + 8 * j + (e & 1) >= V) sc[4 * j + e] = -INFINITY;
    }
    // an online softmax over this thread's columns alone, in the exp2
    // domain; the quad's four partials merge once, after the walk
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * x], sc[4 * j + 2 * x + 1]));
      const float m_new = fmaxf(m[x], mx * kLog2e);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      const int tc = r_t[x] - v0;   // the target's offset from v0
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = sc[4 * j + 2 * x + e];
          sum += exp2f(fmaf(v, kLog2e, -mu));
          if (tc == 8 * j + e) hit[x] += v;
        }
      s[x] = s[x] * exp2f(m[x] - mu) + sum;
      m[x] = m_new;
    }
  }
  // the quad's partials (the same bits in all four lanes: each step adds
  // the same two terms), then this CTA's rows into rank 0's `part`
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[x], off);
      const float s_o = __shfl_xor_sync(0xffffffffu, s[x], off);
      const float m_new = fmaxf(m[x], m_o);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      s[x] = s[x] * exp2f(m[x] - mu) + s_o * exp2f(m_o - mu);
      m[x] = m_new;
      hit[x] += __shfl_xor_sync(0xffffffffu, hit[x], off);
    }
    if (lane % 4 == 0)
      st_cluster(map_rank(part + rank * kOwn + rl + 8 * x, 0),
                 make_float4(m[x], s[x], hit[x], 0.f));
  }
  fence_cluster();
  named_sync(1, kConsumers);   // the CTA's rows written
  if (threadIdx.x == 0) mbar_arrive_cluster(map_rank(merged, 0));
  if (rank != 0) return;
  // rank 0: every rank's rows in, merged in rank order (the same bits
  // every launch)
  mbar_wait_cluster(merged, 0);
  if (threadIdx.x >= kOwn || o0 + (int)threadIdx.x >= N) return;
  float mm = -INFINITY;
  for (int r = 0; r < cs; ++r) mm = fmaxf(mm, part[r * kOwn + threadIdx.x].x);
  const float mu = mm == -INFINITY ? 0.f : mm;
  float ss = 0.f, hh = 0.f;
  for (int r = 0; r < cs; ++r) {
    const float4 p = part[r * kOwn + threadIdx.x];
    ss += p.y * exp2f(p.x - mu);
    hh += p.z;
  }
  const float l = (mu + log2f(ss)) * kLn2;
  const int row = o0 + threadIdx.x;
  lse[row] = l;
  loss[row] = l - hh;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K9 (DX) or K10 in bf16: ceil(n_own / kOwn) clusters of ceil(D / kSlice)
// CTAs, own and stream rows as DX says
template <bool DX>
int launch(const void* x, const void* w, const int* tgt, const float* lse,
           const float* g, void* out, int N, int V, int D, void* stream) {
  const int cs = (D + kSlice - 1) / kSlice;
  if (N < 1 || V < 1 || D < 1 || D % 8 || cs > kMaxCluster ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  const void* own = DX ? x : w;
  const void* strm = DX ? w : x;
  const int n_own = DX ? N : V, n_stream = DX ? V : N;
  CUtensorMap own_map, stream_map;
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t od[3] = {(cuuint64_t)D, (cuuint64_t)n_own, 1};
  const cuuint64_t os[2] = {row, row * n_own};
  const cuuint32_t ob[3] = {64, kOwn, 1};
  cudaError_t err = make_map(&own_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, own,
                             od, os, ob);
  const cuuint64_t sd[3] = {(cuuint64_t)D, (cuuint64_t)n_stream, 1};
  const cuuint64_t ss[2] = {row, row * n_stream};
  const cuuint32_t sb[3] = {64, 64, 1};
  if (!err)
    err = make_map(&stream_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, strm, sd,
                   ss, sb);
  if (!err)
    err = cudaFuncSetAttribute(ce_grad_sm90_kernel<DX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (n_own + kOwn - 1) / kOwn);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_grad_sm90_kernel<DX>, own_map,
                           stream_map, tgt, lse, g, static_cast<bf16*>(out),
                           N, V, D);
  if (err) return err;
  return cudaGetLastError();
}

}  // namespace

// K9 and K10 in bf16 (dtype 1; the signatures of nk_ce_dx and nk_ce_dw):
// dx (N, D) or dW (V, D) bf16 from x (N, D) and w (V, D) bf16, tgt (N,)
// int32, lse and g (N,) f32, all contiguous, x, w and the output 16-byte
// aligned; D a multiple of 8 and at most kMaxCluster slices of kSlice.
extern "C" int nk_ce_dx_sm90(int dtype, const void* x, const void* w,
                             const int* tgt, const float* lse, const float* g,
                             void* dx, int N, int V, int D, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  return launch<true>(x, w, tgt, lse, g, dx, N, V, D, stream);
}

extern "C" int nk_ce_dw_sm90(int dtype, const void* x, const void* w,
                             const int* tgt, const float* lse, const float* g,
                             void* dw, int N, int V, int D, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  return launch<false>(x, w, tgt, lse, g, dw, N, V, D, stream);
}

// K8 in bf16 (the signature of nk_ce_fwd): per-row loss and lse (N,) f32
// from x (N, D) and w (V, D) bf16 and tgt (N,) int32, all contiguous, x
// and w 16-byte aligned, D a multiple of 8; ceil(N / kOwn) clusters of
// min(kMaxCluster, ceil(V / kFwdStream)) CTAs
extern "C" int nk_ce_fwd_sm90(int dtype, const void* x, const void* w,
                              const int* tgt, float* loss, float* lse, int N,
                              int V, int D, void* stream) {
  const int blocks = (N + kOwn - 1) / kOwn;
  const int tiles = (V + kFwdStream - 1) / kFwdStream;
  const int cs = tiles < kMaxCluster ? tiles : kMaxCluster;
  if (dtype != 1 || N < 1 || V < 1 || D < 1 || D % 8 || blocks > 65535 ||
      !aligned16(x) || !aligned16(w))
    return cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t xd[3] = {(cuuint64_t)D, (cuuint64_t)N, 1};
  const cuuint64_t xs[2] = {row, row * N};
  const cuuint32_t xb[3] = {64, kOwn, 1};
  cudaError_t err = make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, xd,
                             xs, xb);
  const cuuint64_t wd[3] = {(cuuint64_t)D, (cuuint64_t)V, 1};
  const cuuint64_t ws[2] = {row, row * V};
  const cuuint32_t wb[3] = {64, 64, 1};
  if (!err)
    err = make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, wd, ws, wb);
  if (!err)
    err = cudaFuncSetAttribute(ce_fwd_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kFwdSmem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kFwdSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_fwd_sm90_kernel, x_map, w_map, tgt, loss,
                           lse, N, V, D);
  if (err) return err;
  return cudaGetLastError();
}
