// Flash attention on the packed qkv projection, forward and backward, on
// Hopper.
//
// Replaces four TPU kernels of neuronika_tpu/ops/pallas/attention.py:
//   K1  _fwd_kernel_qkv               -> flash_fwd_kernel_sm90 (bf16),
//                                        flash_fwd_kernel (f32)
//   K2a _bwd_dq_kernel_qkv            -> flash_bwd_dq_kernel_sm90 (bf16),
//                                        flash_bwd_dq_kernel (f32)
//   K2b _bwd_dkv_kernel_qkv           -> flash_bwd_kv_kernel_sm90<FUSED =
//                                        false> (bf16; past 8 q heads per
//                                        kv head flash_bwd_kv_kernel_sm90_
//                                        cluster), flash_bwd_kv_kernel
//                                        <FUSED = false> (f32)
//   K2c _bwd_fused_kernel_qkv and
//   K2d _bwd_fused_kernel_qkv_blocked -> the same two with FUSED = true
// K2c and K2d compute the same function and differ only in how the TPU's
// 16 MB VMEM budget cut the work (whole-S slabs vs q tiles on the grid).
// Hopper has no such budget: every tile here is a few KB of shared memory
// whatever S is, so one kernel stands for both.
//
// Layout contract (that of flash_attention_qkv):
//   qkv  (B, S, W), W = (H + 2 KV) hd, kv-group-major: group g holds the
//        chunks [q_{gG} .. q_{gG+G-1} | k_g | v_g], G = H / KV, so q head h
//        is chunk (h/G)(G+2) + h%G and its k, v are chunks (h/G)(G+2) + G
//        and + G + 1;
//   out  (B, S, H hd) head-major, in qkv's dtype;
//   lse  (B, H, S) f32, base 2: m + log2(l) (m = 0 in "fast" mode);
//   dqkv (B, S, W) in the packed layout: dq, dk and dv are written straight
//        into their chunks (no repack).
// s = q.k * scale * log2(e) (exp2 domain), causal keys col <= row; the
// backward recomputes p = exp2(s - lse), with delta = rowsum(dO . O),
// ds = p (dp - delta) scale, as the TPU kernels do.
//
// What bounds it: at hd 128 and S 2048 attention does about 2 S hd flops
// for every byte of q, k, v it reads, far above the card's ~295 flop/byte,
// so the tensor cores and the softmax's exp2/FMA work are the limit, not
// device memory. Every S x S quantity stays on chip: a CTA holds one side's
// tile and walks the other side tile by tile, only up to (or from) the
// causal edge; the ragged edge of S is masked, no S % block rule.
//
// bf16, the training path (the Hopper kernels, second half of the file):
//   * every product is a wgmma, the only way to the tensor cores' full
//     rate (earlier mma.sync versions reached 6-13% of it at the headline
//     shape, B16 S2048 H12 hd128 causal). Scores
//     stay in the accumulator registers; P and dS are rounded to bf16
//     there, as the TPU kernel rounds them, and feed the next wgmma as its
//     register A operand, with no trip through shared memory;
//   * TMA with mbarriers: a producer thread keeps 64 x 64 swizzled boxes
//     of Q, K, V, dO in flight through a ring (two stages, three for K2a's
//     K/V), so loads overlap the products and no __syncthreads sits
//     between them; a 3-d map over (W, S, B) reads rows past S as zeros;
//   * a CTA is two consumer warpgroups of 64 rows (128 q rows in K1 and
//     K2a, 128 k rows in K2b/K2c) and the producer warpgroup, whose
//     registers setmaxnreg hands to the consumers (240 each);
//   * K1 and K2a launch their q tiles from the last: causal rows longest
//     first. K2a walks 64-row k tiles so that S, dP and its dQ fit in
//     registers, and keeps dQ there for the whole walk: a CTA owns its dq
//     rows, so K2a needs no atomics and gives the same bits every run;
//   * the backward reads (lse, delta) from a pre-pass (bwd_stats_kernel),
//     once per row instead of once per k tile; the split backward runs it
//     once for both K2a and K2b. K2b and K2c run on a persistent grid. The
//     fused dq is summed in a fixed order of k tiles (turn counters, bulk
//     reduce-add by a writer warp), so the fused backward gives the same
//     bits every run.
// f32 keeps the mma.sync/FFMA kernels (first half): wgmma has no f32
// FFMA path, and f32, run with FFMA (not TF32), agrees with the plain
// PyTorch version to 1e-5 of its largest entry. The f32 fused backward also
// sums dq in a fixed k-tile order (turn counters on a persistent grid of
// resident CTAs, plain loads and stores), so it too is bit-identical from
// run to run.
// Head dims and groups: the Hopper kernels take bf16 at hd 64 and 128 at
// any group size, but the fused backward at most 8 q heads per kv head.
// K1 and K2a run a CTA per (q head, batch, q tile) and find the head's k/v
// as h / G. K2b past 8 q heads per kv head splits the group over a
// cluster of 2, 4 or 8 CTAs (kv_walk's CLUSTER): K and V multicast to the
// cluster once, each CTA's partial dK and dV summed by rank 0 in rank
// order over distributed shared memory, so no atomics and the same bits
// every run. Every other shape JAX's kernels take (hd 1 to 256, f32 or
// bf16) runs the first half's kernels,
// which are instantiated at five head-dim tiers (32, 64, 96, 128, 256;
// hd_tier in flash_tiles.cuh) and mask the runtime hd: tiles are loaded
// with zeros past hd, which add nothing to q.k, dO.v or the P V columns,
// and columns past hd are never stored. Element loads replace the 16-byte
// ones where hd breaks their alignment. Their dk/dv walk sums the G heads
// of a kv group in head order inside the CTA, so any G needs no atomics
// and the result stays the same bits every run. At the 256 tier the f32 dq
// walk steps over 32-row k tiles (dq_bk) to stay within shared memory, and
// the dk/dv walk's accumulators spill (dK and dV alone are 256 f32 a
// thread): slow but right, measured in PERF.md.
// Helpers: flash_tiles.cuh (the mma.sync tiles, shared with the
// split-layout kernels of flash_attention.cu), hopper.cuh (PTX for TMA,
// mbarriers, wgmma) and flash_sm90.cuh (the K1, K2a and K2b/K2c walks,
// which the split layout's K5, K6 and K7 run too; PackedTiles below says
// where this layout's tiles and results are). Attention dropout: every
// kernel has a DROPOUT template flag; set, it draws the keep bit of each
// (row, col) from dropout.cuh on every tile (interior tiles included),
// zeroes the dropped p before P V and scales the output by 1 / (1 - rate)
// in K1, and drops dp and the p of dV in K2; unset, the code is that of no
// dropout. Not done yet: K2a's 64-row k tiles at 128 (its registers: S, dP
// and dQ at 64 x 128 would take 192 f32 a thread before the fragments).
// Tried and dropped: the forward's two warpgroups taking turns (each
// issuing S of tile n with P V of tile n - 1, its softmax beside the
// other's products) ran slower than fwd_walk on an H100 SXM at 700 W.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link (see encoder)
#include <math.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 64;   // forward and dq: q rows per CTA (16 per warp)
constexpr int kBK = 64;   // k rows per tile (dk/dv: per CTA, 16 per warp)
constexpr int kBQb = 32;  // dk/dv and fused: q rows per inner tile

// delta = rowsum(dO . O) and the saved lse for the q rows row0 .. row0 +
// nrows - 1 of head h; dO comes from its shared-memory tile
template <typename T>
__device__ __forceinline__ void row_stats(float* delta_s, float* lse_s,
                                          const T* dOs, int ld, const T* o,
                                          const float* lse, int b, int h,
                                          int H, int S, int row0, int nrows,
                                          int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < nrows; rr += kWarps) {
    const int row = row0 + rr;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + ((size_t)b * S + row) * H * hd + (size_t)h * hd;
      for (int d = lane; d < hd; d += 32)
        acc += Ty<T>::f(dOs[rr * ld + d]) * Ty<T>::f(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[rr] = acc;
      lse_s[rr] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
    }
  }
}

// ---------------------------------------------------------------- forward
// grid (ceil(S / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15. HD is
// the head-dim tier, hd <= HD the operands' head dim (hd_tier): the tiles
// hold HD columns, those past hd zero, and only columns below hd are
// stored; so for the rest of this file.
template <typename T, int HD, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int G, int hd,
                     float qscale, int causal, int fast, Dropout drop) {
  constexpr int LD = HD + Ty<T>::kPad;
  constexpr int LDP = kBK + Ty<T>::kPad;
  constexpr int NTS = kBK / 8, NTO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  T* Ps = Vs + kBK * LD;

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int g = h / G;
  const size_t W = (size_t)(H + 2 * (H / G)) * hd;
  const T* base = qkv + (size_t)b * S * W;
  const T* ksrc = base + (size_t)(g * (G + 2) + G) * hd;
  const T* vsrc = ksrc + hd;
  load_tile<T, HD>(Qs, LD, base + (size_t)(g * (G + 2) + h % G) * hd, W, i0,
                   kBQ, S, hd);

  const T* Qw = Qs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LDP;
  const int row[2] = {i0 + warp * 16 + r, i0 + warp * 16 + r + 8};
  // fast mode keeps m at 0: no running max, no rescale
  float m[2] = {fast ? 0.f : kNegInf, fast ? 0.f : kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NTO][4];
  zero(acc);

  const int n_all = (S + kBK - 1) / kBK;
  const int n_kt = causal ? min((i0 + kBQ - 1) / kBK + 1, n_all) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, HD>(Ks, LD, ksrc, W, j0, kBK, S, hd);
    load_tile<T, HD>(Vs, LD, vsrc, W, j0, kBK, S, hd);
    __syncthreads();
    float s[NTS][4];
    zero(s);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + c + (e & 1);
        const int rw = row[e >> 1];
        float v = s[nt][e] * qscale;
        if (col >= S || (causal && col > rw)) v = kNegInf;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2] = {1.f, 1.f}, m_new[2] = {m[0], m[1]};
    if (!fast) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        m_new[x] = fmaxf(m[x], quad_max(mx[x]));
        alpha[x] = exp2f(m[x] - m_new[x]);
      }
    }
    float sum[2] = {0.f, 0.f};
    bool kp[2][2];  // DROPOUT: keep bits of this column pair in both rows
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - m_new[e >> 1]);
        sum[e >> 1] += p;  // l stays unmasked
        if constexpr (DROPOUT) {
          if (e == 0)
            for (int x = 0; x < 2; ++x)
              drop.cols2(b, h, row[x], j0 + nt * 8 + c, kp[x][0], kp[x][1]);
          if (!kp[e >> 1][e & 1]) p = 0.f;
        }
        Pw[(r + 8 * (e >> 1)) * LDP + nt * 8 + c + (e & 1)] = Ty<T>::from(p);
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] = l[x] * alpha[x] + quad_sum(sum[x]);
      m[x] = m_new[x];
    }
    if (!fast) {
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    }
    __syncwarp();
    warp_gemm<T, NTO, kBK, false, true>(acc, Pw, LDP, Vs, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = row[x];
    if (rw >= S) continue;
    const float inv = (DROPOUT ? drop.inv_keep : 1.f) / l[x];
    T* orow = out + ((size_t)b * S + rw) * H * hd + (size_t)h * hd;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + c + e < hd)
          orow[nt * 8 + c + e] = Ty<T>::from(acc[nt][2 * x + e] * inv);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * S + rw] = m[x] + log2f(l[x]);
  }
}

// the dq walk's k rows per tile: 32 in f32 above the 128 tier, where four
// 64-row tiles of 256 f32 columns would pass the 227 KB of shared memory
template <typename T, int HD>
__host__ __device__ constexpr int dq_bk() {
  return sizeof(T) == 4 && HD > 128 ? 32 : kBK;
}

// -------------------------------------------------------- backward: dq only
// grid (ceil(S / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15 and
// walks the k tiles up to the causal edge, as _bwd_dq_kernel_qkv does.
template <typename T, int HD, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        int S, int H, int G, int hd, float scale,
                        float qscale, int causal, Dropout drop) {
  constexpr int BK = dq_bk<T, HD>();
  constexpr int LD = HD + Ty<T>::kPad;
  constexpr int LDP = BK + Ty<T>::kPad;
  constexpr int NTS = BK / 8, NTO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kBQ * LD;
  T* Ks = dOs + kBQ * LD;
  T* Vs = Ks + BK * LD;
  T* dSs = Vs + BK * LD;
  float* lse_s = reinterpret_cast<float*>(dSs + kBQ * LDP);
  float* delta_s = lse_s + kBQ;

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int g = h / G;
  const size_t W = (size_t)(H + 2 * (H / G)) * hd;
  const T* base = qkv + (size_t)b * S * W;
  const size_t qoff = (size_t)(g * (G + 2) + h % G) * hd;
  const T* ksrc = base + (size_t)(g * (G + 2) + G) * hd;
  const T* vsrc = ksrc + hd;
  load_tile<T, HD>(Qs, LD, base + qoff, W, i0, kBQ, S, hd);
  load_tile<T, HD>(dOs, LD, dout + (size_t)b * S * H * hd + (size_t)h * hd,
                   (size_t)H * hd, i0, kBQ, S, hd);
  __syncthreads();
  row_stats<T>(delta_s, lse_s, dOs, LD, o, lse, b, h, H, S, i0, kBQ, hd);

  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* dSw = dSs + warp * 16 * LDP;
  const int lr[2] = {warp * 16 + r, warp * 16 + r + 8};
  float dq[NTO][4];
  zero(dq);

  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min((i0 + kBQ - 1) / BK + 1, n_all) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // row stats written; previous K/V tile read
    load_tile<T, HD>(Ks, LD, ksrc, W, j0, BK, S, hd);
    load_tile<T, HD>(Vs, LD, vsrc, W, j0, BK, S, hd);
    __syncthreads();
    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dp, dOw, LD, Vs, LD, lane);
    bool kp[2][2];  // DROPOUT: keep bits of this column pair in both rows
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + c + (e & 1);
        const int lrow = lr[e >> 1], rw = i0 + lrow;
        float v = s[nt][e] * qscale;
        if (col >= S || rw >= S || (causal && col > rw)) v = kNegInf;
        const float p = exp2f(v - lse_s[lrow]);
        float d = dp[nt][e];
        if constexpr (DROPOUT) {
          if (e == 0)
            for (int x = 0; x < 2; ++x)
              drop.cols2(b, h, i0 + lr[x], j0 + nt * 8 + c, kp[x][0],
                         kp[x][1]);
          d = kp[e >> 1][e & 1] ? d * drop.inv_keep : 0.f;
        }
        const float ds = p * (d - delta_s[lrow]) * scale;
        dSw[(r + 8 * (e >> 1)) * LDP + nt * 8 + c + (e & 1)] = Ty<T>::from(ds);
      }
    __syncwarp();
    warp_gemm<T, NTO, BK, false, true>(dq, dSw, LDP, Ks, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = i0 + lr[x];
    if (rw >= S) continue;
    T* drow = dqkv + ((size_t)b * S + rw) * W + qoff;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + c + e < hd)
          drow[nt * 8 + c + e] = Ty<T>::from(dq[nt][2 * x + e]);
  }
}

// ------------------------------------------- backward: dk/dv (and fused dq)
// Items (k tile kt, kv group g, batch b), kt fastest; warp w owns k rows
// w*16 .. w*16 + 15 of the item's k/v tile and, for each of the G q heads
// of the group, walks the q tiles from the causal edge to S
// (_bwd_dkv_kernel_qkv). FUSED also adds each tile's dS K into the f32 dq
// scratch (_bwd_fused_kernel_qkv and its blocked twin), so one walk yields
// dq, dk and dv. The adds go in k-tile order, as the TPU's grid order sums
// them: the item of k tile kt waits until the turn counter of (b, h, q
// tile) reads kt, stores (kt = 0) or adds its part with plain loads and
// stores, and passes the turn on; so the result is the same bits every
// run. FUSED runs on a persistent grid of CTAs that are all resident, each
// taking its items in order: an item waits only on the one before it, so
// the lowest unfinished item can always run. Without FUSED a CTA takes one
// item.
template <typename T, int HD, bool FUSED, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ dq_acc, int* __restrict__ dq_turn,
                        int B, int S, int H, int G, int hd, float scale,
                        float qscale, int causal, Dropout drop) {
  constexpr int LD = HD + Ty<T>::kPad;
  constexpr int LDP = kBQb + Ty<T>::kPad;
  constexpr int NTS = kBQb / 8, NTO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBK * LD;
  T* Qs = Vs + kBK * LD;
  T* dOs = Qs + kBQb * LD;
  T* PTs = dOs + kBQb * LD;
  T* dSTs = PTs + kBK * LDP;
  float* lse_s = reinterpret_cast<float*>(dSTs + kBK * LDP);
  float* delta_s = lse_s + kBQb;

  const int KV = H / G;
  const int n_kt = (S + kBK - 1) / kBK;
  const int n_items = n_kt * KV * B;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int kt = item % n_kt, g = (item / n_kt) % KV, b = item / (n_kt * KV);
    const int j0 = kt * kBK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = lane >> 2, c = (lane & 3) * 2;
    const size_t W = (size_t)(H + 2 * KV) * hd;
    const size_t HHD = (size_t)H * hd;
    const T* base = qkv + (size_t)b * S * W;
    const size_t koff = (size_t)(g * (G + 2) + G) * hd;
    __syncthreads();  // the previous item's tiles are no longer read
    load_tile<T, HD>(Ks, LD, base + koff, W, j0, kBK, S, hd);
    load_tile<T, HD>(Vs, LD, base + koff + hd, W, j0, kBK, S, hd);

    const T* Kw = Ks + warp * 16 * LD;
    const T* Vw = Vs + warp * 16 * LD;
    T* PTw = PTs + warp * 16 * LDP;
    T* dSTw = dSTs + warp * 16 * LDP;
    const int jr[2] = {j0 + warp * 16 + r, j0 + warp * 16 + r + 8};
    float dk[NTO][4], dv[NTO][4];
    zero(dk);
    zero(dv);

    const int n_it = (S + kBQb - 1) / kBQb;
    const int it0 = causal ? j0 / kBQb : 0;
    for (int mem = 0; mem < G; ++mem) {
      const int h = g * G + mem;
      const T* qsrc = base + (size_t)(g * (G + 2) + mem) * hd;
      const T* dosrc = dout + (size_t)b * S * HHD + (size_t)h * hd;
      for (int it = it0; it < n_it; ++it) {
        const int i0 = it * kBQb;
        __syncthreads();  // the previous q tile is no longer read
        load_tile<T, HD>(Qs, LD, qsrc, W, i0, kBQb, S, hd);
        load_tile<T, HD>(dOs, LD, dosrc, HHD, i0, kBQb, S, hd);
        __syncthreads();
        row_stats<T>(delta_s, lse_s, dOs, LD, o, lse, b, h, H, S, i0, kBQb,
                     hd);
        __syncthreads();
        float sT[NTS][4], dpT[NTS][4];
        zero(sT);
        zero(dpT);
        warp_gemm<T, NTS, HD, false, false>(sT, Kw, LD, Qs, LD, lane);
        warp_gemm<T, NTS, HD, false, false>(dpT, Vw, LD, dOs, LD, lane);
        bool kp[2][2];  // DROPOUT: keep bits of this q row pair at both keys
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int li = nt * 8 + c + (e & 1), i = i0 + li;
            const int j = jr[e >> 1];
            float v = sT[nt][e] * qscale;
            if (i >= S || j >= S || (causal && j > i)) v = kNegInf;
            const float p = exp2f(v - lse_s[li]);
            float pv = p, d = dpT[nt][e];
            if constexpr (DROPOUT) {
              if (e == 0)
                for (int x = 0; x < 2; ++x)
                  drop.rows2(b, h, i0 + nt * 8 + c, jr[x], kp[x][0],
                             kp[x][1]);
              const bool k = kp[e >> 1][e & 1];
              pv = k ? p * drop.inv_keep : 0.f;
              d = k ? d * drop.inv_keep : 0.f;
            }
            const float ds = p * (d - delta_s[li]) * scale;
            const int at = (r + 8 * (e >> 1)) * LDP + li;
            PTw[at] = Ty<T>::from(pv);
            dSTw[at] = Ty<T>::from(ds);
          }
        __syncwarp();
        warp_gemm<T, NTO, kBQb, false, true>(dv, PTw, LDP, dOs, LD, lane);
        warp_gemm<T, NTO, kBQb, false, true>(dk, dSTw, LDP, Qs, LD, lane);
        if (FUSED) {
          // dq[i] += sum_j dS[i][j] K[j]: every warp's dS^T rows are needed,
          // so the CTA syncs; warps split the (kBQb x HD) result into RB row
          // blocks of 16 and CG column groups of CW columns
          __syncthreads();
          constexpr int RB = kBQb / 16, CG = kWarps / RB, CW = HD / CG;
          static_assert(CW % 8 == 0, "a column group is whole n-tiles");
          const int rb = warp % RB, cg = warp / RB;
          float part[CW / 8][4];
          zero(part);
          warp_gemm<T, CW / 8, kBK, true, true>(part, dSTs + rb * 16, LDP,
                                                Ks + cg * CW, LD, lane);
          // this k tile's turn on the q tile's rows of dq
          int* turn = dq_turn + ((size_t)b * H + h) * n_it + it;
          if (threadIdx.x == 0 && kt > 0)
            while (ld_acquire(turn) < kt) __nanosleep(32);
          __syncthreads();
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = i0 + rb * 16 + r + 8 * x;
            if (i >= S) continue;
            float* drow =
                dq_acc + ((size_t)b * S + i) * HHD + (size_t)h * hd + cg * CW;
#pragma unroll
            for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (cg * CW + nt * 8 + c + e >= hd) continue;
                float* at = drow + nt * 8 + c + e;
                float v = part[nt][2 * x + e];
                if (kt > 0) v += __ldcg(at);  // from L2, not a stale L1 line
                *at = v;
              }
          }
          __threadfence();
          __syncthreads();
          if (threadIdx.x == 0) st_release(turn, kt + 1);
        }
      }
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = jr[x];
      if (j >= S) continue;
      T* drow = dqkv + ((size_t)b * S + j) * W + koff;
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nt * 8 + c + e < hd) {
            drow[nt * 8 + c + e] = Ty<T>::from(dk[nt][2 * x + e]);
            drow[hd + nt * 8 + c + e] = Ty<T>::from(dv[nt][2 * x + e]);
          }
    }
  }  // items
}

// the fused backward's f32 dq scratch (B, S, H hd) -> dq chunks of dqkv
template <typename T>
__global__ void dq_store_kernel(const float* __restrict__ dq_acc,
                                T* __restrict__ dqkv, size_t n, int H, int G,
                                int HD) {
  const size_t W = (size_t)(H + 2 * (H / G)) * HD;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = idx % HD;
    const size_t t = idx / HD;
    const int h = t % H;
    const size_t bs = t / H;
    dqkv[bs * W + (size_t)((h / G) * (G + 2) + h % G) * HD + d] =
        Ty<T>::from(dq_acc[idx]);
  }
}

// ===================================================== Hopper, bf16 only
// K1, K2a and K2b/K2c through the walks of flash_sm90.cuh, on wgmma, TMA
// and mbarriers. A CTA is two consumer warpgroups (256 threads, 64
// rows each) and one producer warpgroup, one thread of which keeps TMA
// loads in flight through a ring; setmaxnreg moves registers from the
// producer to the consumers.

// a ROWS x (64 P) tile at (col, row) of batch b, as P panels of ROWS rows,
// each loaded as 64-row boxes; rows past S arrive as zeros. A `mask` other
// than 0 multicasts the boxes to those CTAs of the cluster
template <int ROWS, int P>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int b, uint16_t mask = 0) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int rb = 0; rb < ROWS / 64; ++rb) {
      unsigned char* at = dst + p * panel_bytes(ROWS) + rb * panel_bytes(64);
      if (mask)
        tma_load_3d_mc(at, map, bar, col + 64 * p, row + 64 * rb, b, mask);
      else
        tma_load_3d(at, map, bar, col + 64 * p, row + 64 * rb, b);
    }
}

// ------------------------------------- K2 pre-pass: (lse, delta) per row
// stats (B, H, S_pad) of (lse, rowsum(dO . O)), one warp a row; rows S ..
// S_pad - 1 read (0, 0), so the walk loads whole 64-row tiles of it
template <int HD>
__global__ void bwd_stats_kernel(const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 float2* __restrict__ stats, int B, int H,
                                 int S, int S_pad) {
  const int lane = threadIdx.x % 32;
  const size_t n = (size_t)B * H * S_pad;
  for (size_t rw = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32;
       rw < n; rw += (size_t)gridDim.x * blockDim.x / 32) {
    const int s = rw % S_pad;
    const size_t bh = rw / S_pad;
    const int h = bh % H, b = bh / H;
    float acc = 0.f;
    if (s < S) {
      const size_t at = ((size_t)b * S + s) * H * HD + (size_t)h * HD;
#pragma unroll
      for (int d = 2 * lane; d < HD; d += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + at + d));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
        acc += a.x * g.x + a.y * g.y;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0)
      stats[rw] = s < S ? make_float2(lse[bh * S + s], acc)
                        : make_float2(0.f, 0.f);
  }
}

// The packed layout as a tile policy of the Hopper walks (flash_sm90.cuh):
// q head h is chunk (h / G)(G + 2) + h % G of qkv, its k and v the chunks
// (h / G)(G + 2) + G and + 1; dO is (B, S, H hd); the rows' (lse, delta)
// come from the pre-pass (float2 rows, S padded to 64) by bulk copy.
template <int HD>
struct PackedTiles {
  static constexpr bool kStatsWarp = false;
  static constexpr bool kClamp = false;
  static constexpr bool kFast = true;
  static constexpr int kRegsProducer = 24, kRegsConsumer = 240;
  static constexpr int P = HD / 64;
  const CUtensorMap* qkv;
  const CUtensorMap* dout;
  const float2* pre;  // the pre-pass's (lse, delta) rows
  bf16* dqkv;
  Band band;
  int B, H, G, KV;
  bf16* out = nullptr;       // K1: (B, S, H hd)
  float* lse_out = nullptr;  // K1: (B, H, S)

  __device__ int W() const { return (H + 2 * KV) * HD; }
  __device__ int qcol(int h) const { return ((h / G) * (G + 2) + h % G) * HD; }
  __device__ int kcol(int g) const { return (g * (G + 2) + G) * HD; }
  template <int ROWS>
  __device__ void q_tile(unsigned char* dst, uint64_t* bar, int b, int h,
                         int row) const {
    tma_tile<ROWS, P>(dst, qkv, bar, qcol(h), row, b);
  }
  template <int ROWS>
  __device__ void do_tile(unsigned char* dst, uint64_t* bar, int b, int h,
                          int row) const {
    tma_tile<ROWS, P>(dst, dout, bar, h * HD, row, b);
  }
  // k and v: `mask` multicasts them to those CTAs of the cluster (K2b
  // past 8 q heads a kv head)
  template <int ROWS>
  __device__ void k_tile(unsigned char* dst, uint64_t* bar, int b, int g,
                         int row, uint16_t mask = 0) const {
    tma_tile<ROWS, P>(dst, qkv, bar, kcol(g), row, b, mask);
  }
  template <int ROWS>
  __device__ void v_tile(unsigned char* dst, uint64_t* bar, int b, int g,
                         int row, uint16_t mask = 0) const {
    tma_tile<ROWS, P>(dst, qkv, bar, kcol(g) + HD, row, b, mask);
  }
  // the pre-pass's rows stop at S padded to 64, a multiple of 64 past row0
  __device__ uint32_t stats_tx(int, int, int row0, int n) const {
    const int S_pad = (band.Sq + kBQh - 1) / kBQh * kBQh;
    return min(n, S_pad - row0) * 8;
  }
  // issued by the TMA thread with the stage's tiles
  __device__ void stats(float2* dst, uint64_t* bar, int b, int h, int row0,
                        int n, int) const {
    const int S_pad = (band.Sq + kBQh - 1) / kBQh * kBQh;
    bulk_load(dst, pre + ((size_t)b * H + h) * S_pad + row0,
              stats_tx(b, h, row0, n), bar);
  }
  __device__ void store_o(int b, int h, int row, int col, float lo,
                          float hi) const {
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * band.Sq + row) * H * HD + (size_t)h * HD + col) =
        __floats2bfloat162_rn(lo, hi);
  }
  __device__ void store_lse(int b, int h, int row, float v) const {
    lse_out[((size_t)b * H + h) * band.Sq + row] = v;
  }
  __device__ void store_dq(int b, int h, int row, int col, float lo,
                           float hi) const {
    *reinterpret_cast<__nv_bfloat162*>(
        dqkv + ((size_t)b * band.Sq + row) * W() + qcol(h) + col) =
        __floats2bfloat162_rn(lo, hi);
  }
  __device__ void store_dkv(int b, int g, int row, int col, float k0,
                            float k1, float v0, float v1) const {
    bf16* drow = dqkv + ((size_t)b * band.Sq + row) * W() + kcol(g) + col;
    *reinterpret_cast<__nv_bfloat162*>(drow) = __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<__nv_bfloat162*>(drow + HD) =
        __floats2bfloat162_rn(v0, v1);
  }
};

// ------------------------------------------------------ K1 on Hopper
// grid (H, B, ceil(S / 128)), q tiles from the last: under a causal mask
// the longest rows start first; the walk is fwd_walk (flash_sm90.cuh),
// with K1's fast softmax (m = 0) where `fast` is set
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int S, int H, int G, float qscale, int causal,
                          int fast, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PackedTiles<HD> t{&qkv_map, nullptr, nullptr, nullptr,
                          Band{S, S, causal, 0}, (int)gridDim.y, H, G,
                          H / G, out, lse};
  fwd_walk<HD, DROPOUT>(t, align1024(smem_raw), blockIdx.x, blockIdx.y,
                        (gridDim.z - 1 - blockIdx.z) * kBM, qscale,
                        fast != 0, drop);
}

// ------------------------------------------------------ K2a on Hopper
// grid (H, B, ceil(S / 128)), q tiles from the last (causal rows longest
// first); the walk is dq_walk (flash_sm90.cuh)
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float2* __restrict__ stats,
                             bf16* __restrict__ dqkv, int B, int S, int H,
                             int G, float scale, float qscale, int causal,
                             Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PackedTiles<HD> t{&qkv_map, &do_map, stats, dqkv,
                          Band{S, S, causal, 0}, B, H, G, H / G};
  dq_walk<HD, DROPOUT>(t, align1024(smem_raw), blockIdx.x, blockIdx.y,
                       (gridDim.z - 1 - blockIdx.z) * kBM, scale, qscale,
                       drop);
}

// ------------------------------------ K2 dk/dv walk (and fused dq), Hopper
// a persistent grid over (k tile, batch, kv group) items; the walk is
// kv_walk (flash_sm90.cuh), FUSED = K2c/K2d
template <int HD, bool FUSED, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_kv_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float2* __restrict__ stats,
                             bf16* __restrict__ dqkv,
                             float* __restrict__ dq_acc,
                             int* __restrict__ dq_turn, int B, int S, int H,
                             int G, float scale, float qscale, int causal,
                             Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PackedTiles<HD> t{&qkv_map, &do_map, stats, dqkv,
                          Band{S, S, causal, 0}, B, H, G, H / G};
  kv_walk<HD, FUSED, DROPOUT>(t, align1024(smem_raw), dq_acc, dq_turn, scale,
                              qscale, drop);
}

// ------------------------ K2b dk/dv walk past 8 q heads a kv head, Hopper
// a persistent grid of whole clusters over (k tile, batch, kv group)
// items; each CTA of a cluster walks its share of the group's heads, and
// rank 0 sums the partials in rank order (kv_walk's CLUSTER)
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_kv_kernel_sm90_cluster(
        const __grid_constant__ CUtensorMap qkv_map,
        const __grid_constant__ CUtensorMap do_map,
        const float2* __restrict__ stats, bf16* __restrict__ dqkv, int B,
        int S, int H, int G, float scale, float qscale, int causal,
        Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PackedTiles<HD> t{&qkv_map, &do_map, stats, dqkv,
                          Band{S, S, causal, 0}, B, H, G, H / G};
  kv_walk<HD, false, DROPOUT, PackedTiles<HD>, true>(
      t, align1024(smem_raw), nullptr, nullptr, scale, qscale, drop);
}

// the bf16 fused walk's f32 dq scratch (B, H, ceil(S / 64), 64, LDQ) ->
// the dq chunks of dqkv (B, S, W)
template <int HD, int LDQ>
__global__ void dq_cast_kernel(const float* __restrict__ dq_acc,
                               bf16* __restrict__ dqkv, int B, int S, int H,
                               int G) {
  const int n_qt = (S + kBQh - 1) / kBQh;
  const size_t W = (size_t)(H + 2 * (H / G)) * HD;
  const size_t n = (size_t)B * S * H * HD / 2;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(idx % (HD / 2)) * 2;
    const size_t t = idx / (HD / 2);
    const int h = t % H;
    const size_t bs = t / H;
    const int s = bs % S, b = bs / S;
    const float2 v = *reinterpret_cast<const float2*>(
        dq_acc + (((size_t)b * H + h) * n_qt + s / kBQh) * (kBQh * LDQ) +
        (s % kBQh) * LDQ + d);
    *reinterpret_cast<__nv_bfloat162*>(
        dqkv + bs * W + (size_t)((h / G) * (G + 2) + h % G) * HD + d) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

// ------------------------------------------------------------------- host

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return ((size_t)(kBQ + 2 * kBK) * (HD + Ty<T>::kPad) +
          (size_t)kBQ * (kBK + Ty<T>::kPad)) * sizeof(T);
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  constexpr int BK = dq_bk<T, HD>();
  return ((size_t)(2 * kBQ + 2 * BK) * (HD + Ty<T>::kPad) +
          (size_t)kBQ * (BK + Ty<T>::kPad)) * sizeof(T) +
         2 * kBQ * sizeof(float);
}

template <typename T, int HD>
constexpr size_t kv_smem() {
  return ((size_t)(2 * kBK + 2 * kBQb) * (HD + Ty<T>::kPad) +
          (size_t)2 * kBK * (kBQb + Ty<T>::kPad)) * sizeof(T) +
         2 * kBQb * sizeof(float);
}

struct Args {
  const void* qkv;
  const void* o;
  const void* lse;
  const void* dout;
  void* out;   // forward: out; backward: dqkv
  void* lse_out;
  float* dq_acc;
  void* stats;  // bf16 backward: (B, H, S_pad) (lse, delta) scratch
  int* turn;    // fused: zeroed dq turn counters, one per (b, h, q tile)
  int have_stats;  // bf16 K2a, K2b: the caller ran the pre-pass into stats
  int B, S, H, KV, hd, causal, fast;
  float scale;
  cudaStream_t stream;
  Dropout drop;  // threshold 0: no dropout
  int cluster = 1;  // bf16 K2b: CTAs an item (dkv_plan), 1 up to G 8
};

// above 48 KB a kernel's dynamic shared memory must be allowed explicitly
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD, bool DROP>
cudaError_t fwd(const Args& a) {
  const size_t smem = fwd_smem<T, HD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, HD, DROP>, smem);
  if (err) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, HD, DROP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.S, a.H, a.H / a.KV, a.hd,
      a.scale * kLog2e, a.causal, a.fast, a.drop);
  return cudaGetLastError();
}

template <typename T, int HD, bool DROP>
cudaError_t bwd_dq(const Args& a) {
  const size_t smem = dq_smem<T, HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, HD, DROP>, smem);
  if (err) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_bwd_dq_kernel<T, HD, DROP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.S, a.H, a.H / a.KV, a.hd, a.scale,
      a.scale * kLog2e, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int HD, bool FUSED, bool DROP>
cudaError_t bwd_kv(const Args& a) {
  const size_t smem = kv_smem<T, HD>();
  const auto kernel = flash_bwd_kv_kernel<T, HD, FUSED, DROP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err) return err;
  const long long items = (long long)((a.S + kBK - 1) / kBK) * a.KV * a.B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  long long grid = items;
  if (FUSED) {  // every CTA resident at once: the turns never wait on one
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid = items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  }
  kernel<<<(unsigned)grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.dq_acc, a.turn, a.B, a.S, a.H, a.H / a.KV,
      a.hd, a.scale, a.scale * kLog2e, a.causal, a.drop);
  err = cudaGetLastError();
  if (err || !FUSED) return err;
  const size_t n = (size_t)a.B * a.S * a.H * a.hd;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dq_store_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.dq_acc, static_cast<T*>(a.out), n, a.H, a.H / a.KV, a.hd);
  return cudaGetLastError();
}

// a bf16 (B, S, width) tensor as a 3-d TMA map with 64 x 64 boxes, 128-byte
// swizzle; rows past S (and columns past width) read as zeros
cudaError_t packed_map(CUtensorMap* map, const void* base, int width, int S,
                       int B) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * S * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                  strides, box);
}

template <int HD, bool DROP>
cudaError_t fwd_sm90(const Args& a) {
  CUtensorMap map;
  const int W = (a.H + 2 * a.KV) * HD;
  cudaError_t err = packed_map(&map, a.qkv, W, a.S, a.B);
  if (err) return err;
  const size_t smem = FwdSmem<HD>::kBytes;
  err = allow_smem(flash_fwd_kernel_sm90<HD, DROP>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.S + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_kernel_sm90<HD, DROP><<<grid, kHopperThreads, smem, a.stream>>>(
      map, static_cast<bf16*>(a.out), static_cast<float*>(a.lse_out), a.S,
      a.H, a.H / a.KV, a.scale * kLog2e, a.causal, a.fast, a.drop);
  return cudaGetLastError();
}

// the pre-pass: (lse, delta) rows (B, H, S padded to 64) into a.stats
template <int HD>
cudaError_t bwd_stats(const Args& a) {
  const int n_qt = (a.S + kBQh - 1) / kBQh;
  const size_t rows = (size_t)a.B * a.H * n_qt * kBQh;
  const int sblocks = (int)((rows + 7) / 8 < 8192 ? (rows + 7) / 8 : 8192);
  bwd_stats_kernel<HD><<<sblocks, 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float2*>(a.stats), a.B,
      a.H, a.S, n_qt * kBQh);
  return cudaGetLastError();
}

// K2a on Hopper: the pre-pass unless the caller ran it, then the q tiles
template <int HD, bool DROP>
cudaError_t bwd_dq_sm90(const Args& a) {
  cudaError_t err = a.have_stats ? cudaSuccess : bwd_stats<HD>(a);
  if (err) return err;
  CUtensorMap qkv_map, do_map;
  err = packed_map(&qkv_map, a.qkv, (a.H + 2 * a.KV) * HD, a.S, a.B);
  if (!err) err = packed_map(&do_map, a.dout, a.H * HD, a.S, a.B);
  if (err) return err;
  const size_t smem = DqSmem<HD>::kBytes;
  err = allow_smem(flash_bwd_dq_kernel_sm90<HD, DROP>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.S + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel_sm90<HD, DROP><<<grid, kHopperThreads, smem,
                                       a.stream>>>(
      qkv_map, do_map, static_cast<const float2*>(a.stats),
      static_cast<bf16*>(a.out), a.B, a.S, a.H, a.H / a.KV, a.scale,
      a.scale * kLog2e, a.causal, a.drop);
  return cudaGetLastError();
}

// K2b past 8 q heads a kv head: items of a.cluster CTAs
// (ops/flash_attention.py::dkv_plan) on a persistent grid of as many whole
// clusters as the card holds at once (at most one an item)
template <int HD, bool DROP>
cudaError_t bwd_kv_cluster_sm90(const Args& a, const CUtensorMap& qkv_map,
                                const CUtensorMap& do_map) {
  const auto kernel = flash_bwd_kv_kernel_sm90_cluster<HD, DROP>;
  const size_t smem = KvSmem<HD, false, true>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster);
  cfg.blockDim = dim3(kHopperThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long items =
      (long long)((a.S + kBN - 1) / kBN) * a.B * a.KV;
  const long long clusters = items < fit ? items : fit;
  cfg.gridDim = dim3((unsigned)(clusters * a.cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, qkv_map, do_map,
                           static_cast<const float2*>(a.stats),
                           static_cast<bf16*>(a.out), a.B, a.S, a.H,
                           a.H / a.KV, a.scale, a.scale * kLog2e, a.causal,
                           a.drop);
  if (err) return err;
  return cudaGetLastError();
}

// the pre-pass (unless the caller ran it; the fused walk always runs it),
// then the walk on a persistent grid (of clusters past 8 q heads a kv head)
template <int HD, bool FUSED, bool DROP>
cudaError_t bwd_kv_sm90(const Args& a) {
  cudaError_t err =
      a.have_stats && !FUSED ? cudaSuccess : bwd_stats<HD>(a);
  if (err) return err;
  CUtensorMap qkv_map, do_map;
  err = packed_map(&qkv_map, a.qkv, (a.H + 2 * a.KV) * HD, a.S, a.B);
  if (!err) err = packed_map(&do_map, a.dout, a.H * HD, a.S, a.B);
  if (err) return err;
  if (!FUSED && a.cluster > 1)
    return bwd_kv_cluster_sm90<HD, DROP>(a, qkv_map, do_map);
  const size_t smem = KvSmem<HD, FUSED>::kBytes;
  err = allow_smem(flash_bwd_kv_kernel_sm90<HD, FUSED, DROP>, smem);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const long long items =
      (long long)((a.S + kBN - 1) / kBN) * a.B * a.KV;
  const int grid = (int)(items < sms ? items : sms);
  flash_bwd_kv_kernel_sm90<HD, FUSED, DROP><<<grid, kHopperThreads, smem,
                                              a.stream>>>(
      qkv_map, do_map, static_cast<const float2*>(a.stats),
      static_cast<bf16*>(a.out), a.dq_acc, a.turn, a.B, a.S, a.H,
      a.H / a.KV, a.scale, a.scale * kLog2e, a.causal, a.drop);
  err = cudaGetLastError();
  if (err || !FUSED) return err;
  const size_t n = (size_t)a.B * a.S * a.H * HD / 2;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dq_cast_kernel<HD, KvSmem<HD, true>::LDQ><<<blocks, 256, 0, a.stream>>>(
      a.dq_acc, static_cast<bf16*>(a.out), a.B, a.S, a.H, a.H / a.KV);
  return cudaGetLastError();
}

enum Which { kFwd, kStats, kDq, kDkv, kFused };

// The routes. The caller picks one (ops/flash_attention.py::_sm90_route)
// and passes it as `sm90`, since its scratch layouts depend on it: the
// Hopper kernels, built for bf16 at hd 64 or 128, at any group size but
// for the fused backward's at most 8 q heads per kv head (sm90_takes; a
// launch asking for them elsewhere is refused), or the mma.sync/FFMA
// kernels of the first half, which take every shape (f32 and bf16, hd 1
// to 256, any group), instantiated at the head-dim tiers of hd_tier and
// masking the runtime hd. K1 and K2a run a CTA per q tile of a head
// whatever G; K2b past 8 q heads a kv head splits the group over a
// cluster of `cluster` CTAs (1, 2, 4 or 8, at most G; 1 on every other
// kernel and route), summed in rank order; the mma.sync dk/dv walk sums
// a group's G heads inside the CTA in head order. So no group size needs
// atomics.
constexpr int kFusedMaxG = 8;

bool sm90_takes(int dtype, Which w, const Args& a) {
  return dtype == 1 && (a.hd == 64 || a.hd == 128) &&
         (w != kFused || a.H / a.KV <= kFusedMaxG);
}

bool cluster_ok(int sm90, Which w, const Args& a) {
  const int c = a.cluster;
  if (c == 1) return true;
  return sm90 && w == kDkv && (c == 2 || c == 4 || c == 8) &&
         c <= a.H / a.KV;
}

template <int HD, bool DROP>
cudaError_t dispatch_sm90(Which w, const Args& a) {
  switch (w) {
    case kFwd: return fwd_sm90<HD, DROP>(a);
    case kStats: return bwd_stats<HD>(a);
    case kDq: return bwd_dq_sm90<HD, DROP>(a);
    case kDkv: return bwd_kv_sm90<HD, false, DROP>(a);
    case kFused: return bwd_kv_sm90<HD, true, DROP>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int HD, bool DROP>
cudaError_t dispatch_core(Which w, const Args& a) {
  switch (w) {
    case kFwd: return fwd<T, HD, DROP>(a);
    case kDq: return bwd_dq<T, HD, DROP>(a);
    case kDkv: return bwd_kv<T, HD, false, DROP>(a);
    case kFused: return bwd_kv<T, HD, true, DROP>(a);
    case kStats: break;  // the core kernels form their own row stats
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool DROP>
cudaError_t dispatch_tier(Which w, const Args& a) {
  switch (hd_tier(a.hd)) {
#ifndef NK_FLASH_TIERS_3
    case 32: return dispatch_core<T, 32, DROP>(w, a);
    case 96: return dispatch_core<T, 96, DROP>(w, a);
#endif
    case 64: return dispatch_core<T, 64, DROP>(w, a);
    case 128: return dispatch_core<T, 128, DROP>(w, a);
    case 256: return dispatch_core<T, 256, DROP>(w, a);
  }
  return cudaErrorInvalidValue;
}

template <bool DROP>
cudaError_t dispatch(int dtype, int sm90, Which w, const Args& a) {
  if (sm90) {
    if (!sm90_takes(dtype, w, a)) return cudaErrorInvalidValue;
    return a.hd == 64 ? dispatch_sm90<64, DROP>(w, a)
                      : dispatch_sm90<128, DROP>(w, a);
  }
  if (dtype == 0) return dispatch_tier<float, DROP>(w, a);
  if (dtype == 1) return dispatch_tier<__nv_bfloat16, DROP>(w, a);
  return cudaErrorInvalidValue;
}

int run(int dtype, int sm90, Which w, const Args& a) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.KV < 1 || a.H % a.KV ||
      a.B > 65535 || a.H > 65535 || a.KV > 65535 || a.hd < 1 ||
      a.hd > 256 || !cluster_ok(sm90, w, a))
    return cudaErrorInvalidValue;
  // the pre-pass has no dropout; every other kernel runs its DROPOUT
  // instantiation when the threshold is not 0
  if (a.drop.threshold != 0 && w != kStats)
    return dispatch<true>(dtype, sm90, w, a);
  return dispatch<false>(dtype, sm90, w, a);
}

Dropout dropout_of(unsigned long long seed, unsigned threshold,
                   float inv_keep) {
  return Dropout{(uint32_t)seed, (uint32_t)(seed >> 32), threshold, inv_keep};
}

}  // namespace

// C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16;
// sm90: 1 for the Hopper kernels, 0 for the others (see the routes above);
// hd 1 to 256; any KV dividing H. Attention dropout (dropout.cuh): seed,
// threshold = min(floor(rate 2^32), 2^32 - 1) and inv_keep = 1 / (1 -
// rate); threshold 0 runs without it. Each returns a cudaError_t: 0 when
// the launch was accepted.

// out (B, S, H hd) and lse (B, H, S) f32 from qkv (B, S, W)
extern "C" int nk_flash_fwd_qkv(int dtype, int sm90, const void* qkv,
                                void* out,
                                void* lse, int B, int S, int H, int KV,
                                int hd, float scale, int causal, int fast,
                                unsigned long long seed, unsigned threshold,
                                float inv_keep, void* stream) {
  Args a{qkv, nullptr, nullptr, nullptr, out, lse, nullptr, nullptr, nullptr,
         0, B, S, H, KV, hd, causal, fast, scale,
         static_cast<cudaStream_t>(stream),
         dropout_of(seed, threshold, inv_keep)};
  return run(dtype, sm90, kFwd, a);
}

// the Hopper route only: the backward's pre-pass, stats f32 (B, H, 64
// ceil(S / 64), 2) = (lse, rowsum(dO . O)) per row, rows past S (0, 0); K2a
// and K2b take it with have_stats = 1, so a split backward runs it once
extern "C" int nk_flash_bwd_stats_qkv(int dtype, const void* o,
                                      const void* lse, const void* dout,
                                      void* stats, int B, int S, int H,
                                      int hd, void* stream) {
  Args a{nullptr, o, lse, dout, nullptr, nullptr, nullptr, stats, nullptr,
         0, B, S, H, H, hd, 0, 0, 0.f, static_cast<cudaStream_t>(stream),
         Dropout{}};
  return run(dtype, 1, kStats, a);
}

// the q chunks of dqkv (B, S, W); the Hopper route: stats as above, filled
// here unless have_stats (unused on the other route)
extern "C" int nk_flash_bwd_dq_qkv(int dtype, int sm90, const void* qkv,
                                   const void* o,
                                   const void* lse, const void* dout,
                                   void* stats, int have_stats, void* dqkv,
                                   int B, int S, int H, int KV, int hd,
                                   float scale, int causal,
                                   unsigned long long seed,
                                   unsigned threshold, float inv_keep,
                                   void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr, stats, nullptr,
         have_stats, B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream),
         dropout_of(seed, threshold, inv_keep)};
  return run(dtype, sm90, kDq, a);
}

// the k and v chunks of dqkv (B, S, W); stats as for dq; cluster: the
// Hopper route's CTAs an item (ops/flash_attention.py::dkv_plan: 1 up to
// 8 q heads a kv head, else 2, 4 or 8, at most H / KV), 1 on the other
extern "C" int nk_flash_bwd_dkv_qkv(int dtype, int sm90, const void* qkv,
                                    const void* o, const void* lse,
                                    const void* dout, void* stats,
                                    int have_stats, void* dqkv, int B, int S,
                                    int H, int KV, int hd, float scale,
                                    int causal, unsigned long long seed,
                                    unsigned threshold, float inv_keep,
                                    int cluster, void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr, stats, nullptr,
         have_stats, B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream),
         dropout_of(seed, threshold, inv_keep)};
  a.cluster = cluster;
  return run(dtype, sm90, kDkv, a);
}

// all of dqkv (B, S, W); dq is summed over k tiles in a fixed order, so the
// result is the same bits every run. The Hopper route: stats as above
// (always filled here), dq_acc f32 (B, H, ceil(S / 64), 64, hd + 8) scratch
// and turn, int32 (B, H, ceil(S / 64)) that the caller zeroes. The other
// route: dq_acc f32 (B, S, H hd) scratch and turn, int32 (B, H, ceil(S /
// 32)) that the caller zeroes (stats unused).
extern "C" int nk_flash_bwd_fused_qkv(int dtype, int sm90, const void* qkv,
                                      const void* o, const void* lse,
                                      const void* dout, void* stats,
                                      void* dq_acc, void* turn, void* dqkv,
                                      int B, int S, int H, int KV, int hd,
                                      float scale, int causal,
                                      unsigned long long seed,
                                      unsigned threshold, float inv_keep,
                                      void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, static_cast<float*>(dq_acc),
         stats, static_cast<int*>(turn), 0,
         B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream),
         dropout_of(seed, threshold, inv_keep)};
  return run(dtype, sm90, kFused, a);
}
