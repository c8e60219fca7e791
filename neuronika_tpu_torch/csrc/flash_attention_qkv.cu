// Flash attention on the packed qkv projection, forward and backward, on
// Hopper.
//
// Replaces four TPU kernels of neuronika_tpu/ops/pallas/attention.py:
//   K1  _fwd_kernel_qkv               -> flash_fwd_kernel_sm90 (bf16),
//                                        flash_fwd_kernel (f32)
//   K2a _bwd_dq_kernel_qkv            -> flash_bwd_dq_kernel_sm90 (bf16),
//                                        flash_bwd_dq_kernel (f32)
//   K2b _bwd_dkv_kernel_qkv           -> flash_bwd_kv_kernel_sm90<FUSED =
//                                        false> (bf16), flash_bwd_kv_kernel
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
// Helpers: flash_tiles.cuh (the mma.sync tiles, shared with the
// split-layout kernels of flash_attention.cu) and hopper.cuh (PTX for
// TMA, mbarriers, wgmma). Not done yet: in-kernel dropout, overlapping one
// tile's softmax with the next tile's products inside a warpgroup, and
// K2a's 64-row k tiles at 128 (its registers: S, dP and dQ at 64 x 128
// would take 192 f32 a thread before the fragments).

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link (see encoder)
#include <math.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;   // forward and dq: q rows per CTA (16 per warp)
constexpr int kBK = 64;   // k rows per tile (dk/dv: per CTA, 16 per warp)
constexpr int kBQb = 32;  // dk/dv and fused: q rows per inner tile

// delta = rowsum(dO . O) and the saved lse for the q rows row0 .. row0 +
// nrows - 1 of head h; dO comes from its shared-memory tile
template <typename T, int HD>
__device__ __forceinline__ void row_stats(float* delta_s, float* lse_s,
                                          const T* dOs, int ld, const T* o,
                                          const float* lse, int b, int h,
                                          int H, int S, int row0, int nrows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < nrows; rr += kWarps) {
    const int row = row0 + rr;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + ((size_t)b * S + row) * H * HD + (size_t)h * HD;
      for (int d = lane; d < HD; d += 32)
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
// grid (ceil(S / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int G,
                     float qscale, int causal, int fast) {
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
  const size_t W = (size_t)(H + 2 * (H / G)) * HD;
  const T* base = qkv + (size_t)b * S * W;
  const T* ksrc = base + (size_t)(g * (G + 2) + G) * HD;
  const T* vsrc = ksrc + HD;
  load_tile<T, HD>(Qs, LD, base + (size_t)(g * (G + 2) + h % G) * HD, W, i0,
                   kBQ, S);

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
    load_tile<T, HD>(Ks, LD, ksrc, W, j0, kBK, S);
    load_tile<T, HD>(Vs, LD, vsrc, W, j0, kBK, S);
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
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_new[e >> 1]);
        sum[e >> 1] += p;
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
    const float inv = 1.f / l[x];
    T* orow = out + ((size_t)b * S + rw) * H * HD + (size_t)h * HD;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      orow[nt * 8 + c] = Ty<T>::from(acc[nt][2 * x] * inv);
      orow[nt * 8 + c + 1] = Ty<T>::from(acc[nt][2 * x + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * S + rw] = m[x] + log2f(l[x]);
  }
}

// -------------------------------------------------------- backward: dq only
// grid (ceil(S / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15 and
// walks the k tiles up to the causal edge, as _bwd_dq_kernel_qkv does.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        int S, int H, int G, float scale, float qscale,
                        int causal) {
  constexpr int LD = HD + Ty<T>::kPad;
  constexpr int LDP = kBK + Ty<T>::kPad;
  constexpr int NTS = kBK / 8, NTO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kBQ * LD;
  T* Ks = dOs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  T* dSs = Vs + kBK * LD;
  float* lse_s = reinterpret_cast<float*>(dSs + kBQ * LDP);
  float* delta_s = lse_s + kBQ;

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int g = h / G;
  const size_t W = (size_t)(H + 2 * (H / G)) * HD;
  const T* base = qkv + (size_t)b * S * W;
  const size_t qoff = (size_t)(g * (G + 2) + h % G) * HD;
  const T* ksrc = base + (size_t)(g * (G + 2) + G) * HD;
  const T* vsrc = ksrc + HD;
  load_tile<T, HD>(Qs, LD, base + qoff, W, i0, kBQ, S);
  load_tile<T, HD>(dOs, LD, dout + (size_t)b * S * H * HD + (size_t)h * HD,
                   (size_t)H * HD, i0, kBQ, S);
  __syncthreads();
  row_stats<T, HD>(delta_s, lse_s, dOs, LD, o, lse, b, h, H, S, i0, kBQ);

  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* dSw = dSs + warp * 16 * LDP;
  const int lr[2] = {warp * 16 + r, warp * 16 + r + 8};
  float dq[NTO][4];
  zero(dq);

  const int n_all = (S + kBK - 1) / kBK;
  const int n_kt = causal ? min((i0 + kBQ - 1) / kBK + 1, n_all) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();  // row stats written; previous K/V tile read
    load_tile<T, HD>(Ks, LD, ksrc, W, j0, kBK, S);
    load_tile<T, HD>(Vs, LD, vsrc, W, j0, kBK, S);
    __syncthreads();
    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dp, dOw, LD, Vs, LD, lane);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nt * 8 + c + (e & 1);
        const int lrow = lr[e >> 1], rw = i0 + lrow;
        float v = s[nt][e] * qscale;
        if (col >= S || rw >= S || (causal && col > rw)) v = kNegInf;
        const float p = exp2f(v - lse_s[lrow]);
        const float ds = p * (dp[nt][e] - delta_s[lrow]) * scale;
        dSw[(r + 8 * (e >> 1)) * LDP + nt * 8 + c + (e & 1)] = Ty<T>::from(ds);
      }
    __syncwarp();
    warp_gemm<T, NTO, kBK, false, true>(dq, dSw, LDP, Ks, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = i0 + lr[x];
    if (rw >= S) continue;
    T* drow = dqkv + ((size_t)b * S + rw) * W + qoff;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      drow[nt * 8 + c] = Ty<T>::from(dq[nt][2 * x]);
      drow[nt * 8 + c + 1] = Ty<T>::from(dq[nt][2 * x + 1]);
    }
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
template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ dq_acc, int* __restrict__ dq_turn,
                        int B, int S, int H, int G, float scale, float qscale,
                        int causal) {
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
    const size_t W = (size_t)(H + 2 * KV) * HD;
    const size_t HHD = (size_t)H * HD;
    const T* base = qkv + (size_t)b * S * W;
    const size_t koff = (size_t)(g * (G + 2) + G) * HD;
    __syncthreads();  // the previous item's tiles are no longer read
    load_tile<T, HD>(Ks, LD, base + koff, W, j0, kBK, S);
    load_tile<T, HD>(Vs, LD, base + koff + HD, W, j0, kBK, S);

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
      const T* qsrc = base + (size_t)(g * (G + 2) + mem) * HD;
      const T* dosrc = dout + (size_t)b * S * HHD + (size_t)h * HD;
      for (int it = it0; it < n_it; ++it) {
        const int i0 = it * kBQb;
        __syncthreads();  // the previous q tile is no longer read
        load_tile<T, HD>(Qs, LD, qsrc, W, i0, kBQb, S);
        load_tile<T, HD>(dOs, LD, dosrc, HHD, i0, kBQb, S);
        __syncthreads();
        row_stats<T, HD>(delta_s, lse_s, dOs, LD, o, lse, b, h, H, S, i0,
                         kBQb);
        __syncthreads();
        float sT[NTS][4], dpT[NTS][4];
        zero(sT);
        zero(dpT);
        warp_gemm<T, NTS, HD, false, false>(sT, Kw, LD, Qs, LD, lane);
        warp_gemm<T, NTS, HD, false, false>(dpT, Vw, LD, dOs, LD, lane);
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int li = nt * 8 + c + (e & 1), i = i0 + li;
            const int j = jr[e >> 1];
            float v = sT[nt][e] * qscale;
            if (i >= S || j >= S || (causal && j > i)) v = kNegInf;
            const float p = exp2f(v - lse_s[li]);
            const float ds = p * (dpT[nt][e] - delta_s[li]) * scale;
            const int at = (r + 8 * (e >> 1)) * LDP + li;
            PTw[at] = Ty<T>::from(p);
            dSTw[at] = Ty<T>::from(ds);
          }
        __syncwarp();
        warp_gemm<T, NTO, kBQb, false, true>(dv, PTw, LDP, dOs, LD, lane);
        warp_gemm<T, NTO, kBQb, false, true>(dk, dSTw, LDP, Qs, LD, lane);
        if (FUSED) {
          // dq[i] += sum_j dS[i][j] K[j]: every warp's dS^T rows are needed,
          // so the CTA syncs; warps split the (kBQb x HD) result into RB row
          // blocks of 16 and CG column groups, 32 columns at a time
          __syncthreads();
          constexpr int RB = kBQb / 16, CG = kWarps / RB, CW = HD / CG;
          const int rb = warp % RB, cg = warp / RB;
          float part[CW / 32][4][4];
#pragma unroll
          for (int cc = 0; cc < CW / 32; ++cc) {
            zero(part[cc]);
            warp_gemm<T, 4, kBK, true, true>(part[cc], dSTs + rb * 16, LDP,
                                             Ks + cg * CW + 32 * cc, LD, lane);
          }
          // this k tile's turn on the q tile's rows of dq
          int* turn = dq_turn + ((size_t)b * H + h) * n_it + it;
          if (threadIdx.x == 0 && kt > 0)
            while (ld_acquire(turn) < kt) __nanosleep(32);
          __syncthreads();
#pragma unroll
          for (int cc = 0; cc < CW / 32; ++cc)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int i = i0 + rb * 16 + r + 8 * x;
              if (i >= S) continue;
              float* drow = dq_acc + ((size_t)b * S + i) * HHD +
                            (size_t)h * HD + cg * CW + 32 * cc;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                float2* at = reinterpret_cast<float2*>(drow + nt * 8 + c);
                float2 v = make_float2(part[cc][nt][2 * x],
                                       part[cc][nt][2 * x + 1]);
                if (kt > 0) {  // from L2, not a stale L1 line
                  const float2 was = __ldcg(at);
                  v.x += was.x;
                  v.y += was.y;
                }
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
      for (int nt = 0; nt < NTO; ++nt) {
        drow[nt * 8 + c] = Ty<T>::from(dk[nt][2 * x]);
        drow[nt * 8 + c + 1] = Ty<T>::from(dk[nt][2 * x + 1]);
        drow[HD + nt * 8 + c] = Ty<T>::from(dv[nt][2 * x]);
        drow[HD + nt * 8 + c + 1] = Ty<T>::from(dv[nt][2 * x + 1]);
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
// K1 and the K2 dk/dv walk on wgmma, TMA and mbarriers. A CTA is two
// consumer warpgroups (256 threads, 64 rows each) and one producer
// warpgroup, one thread of which keeps TMA loads in flight through a
// two-stage ring (the other three warps exit at once); setmaxnreg moves
// registers from the producer to the consumers.

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;
constexpr int kHopperThreads = kConsumers + 128;
constexpr int kStages = 2;
// setmaxnreg moves registers only within the CTA's launch allotment (384
// threads x 168): the producer warpgroup gives up 144 a thread, which the
// consumers take (128 x 24 + 256 x 240 = 384 x 168)
constexpr int kRegsProducer = 24, kRegsConsumer = 240;
constexpr int kBM = 128;   // K1: q rows per CTA
constexpr int kBN = 128;   // K1: k rows per tile; K2: k rows per CTA
constexpr int kBQh = 64;   // K2: q rows per step of the walk

// bytes of a rows x 64 bf16 panel (one 128-byte swizzled row each)
__host__ __device__ constexpr uint32_t panel_bytes(int rows) {
  return (uint32_t)rows * 128;
}

// a ROWS x (64 P) tile at (col, row) of batch b, as P panels of ROWS rows,
// each loaded as 64-row boxes; rows past S arrive as zeros
template <int ROWS, int P>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int b) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int rb = 0; rb < ROWS / 64; ++rb)
      tma_load_3d(dst + p * panel_bytes(ROWS) + rb * panel_bytes(64), map,
                  bar, col + 64 * p, row + 64 * rb, b);
}

// K-major descriptor of the k16 slice k of a tile whose panels hold ROWS
// rows, starting `row_off` rows in
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int row_off,
                                           int k) {
  return sw128_desc(base + (k / 4) * panel_bytes(ROWS) +
                    panel_bytes(row_off) + (k % 4) * 32);
}

// MN-major descriptor of the k16 slice k (rows 16 k ..) of panel p
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int p, int k) {
  return sw128_desc(base + p * panel_bytes(ROWS) + k * panel_bytes(16));
}

// the A fragments of an accumulator's 16-column slices, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&d)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[k][q] = pack_bf16(d[8 * k + 2 * q], d[8 * k + 2 * q + 1]);
}

template <int HD>
struct FwdSmem {
  static constexpr int P = HD / 64;
  static constexpr uint32_t kQ = P * panel_bytes(kBM);
  static constexpr uint32_t kKV = P * panel_bytes(kBN);
  static constexpr uint32_t kOffK = kQ;
  static constexpr uint32_t kOffV = kOffK + kStages * kKV;
  static constexpr uint32_t kOffBar = kOffV + kStages * kKV;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 3 * kStages) + 1024;
};

// ------------------------------------------------------ K1 on Hopper
// grid (H, B, ceil(S / 128)), q tiles from the last: under a causal mask
// the longest rows start first. Consumer warpgroup w owns q rows i0 + 64 w
// .. + 63. Per k tile: S = Q K^T (wgmma, both operands K-major from the
// TMA tiles), the softmax on the accumulator registers (exp2 domain; fast
// mode keeps m = 0), P rounded to bf16 into A fragments, O += P V (wgmma,
// A from registers, V MN-major). The producer loads Q once and K, V
// through the ring, K and V on separate barriers so that S starts before
// V has landed.
template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int S, int H, int G, float qscale, int causal,
                          int fast) {
  using Sm = FwdSmem<HD>;
  constexpr int P = Sm::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + Sm::kOffK;
  unsigned char* Vs = smem + Sm::kOffV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int g = h / G;
  const int n_all = (S + kBN - 1) / kBN;
  const int n_kt = causal ? min((i0 + kBM - 1) / kBN + 1, n_all) : n_all;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers) {
      const int kcol = (g * (G + 2) + G) * HD;
      mbar_expect_tx(q_full, Sm::kQ);
      tma_tile<kBM, P>(Qs, &qkv_map, q_full, (g * (G + 2) + h % G) * HD, i0,
                       b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + s, Sm::kKV);
        tma_tile<kBN, P>(Ks + s * Sm::kKV, &qkv_map, k_full + s, kcol,
                         kt * kBN, b);
        mbar_expect_tx(v_full + s, Sm::kKV);
        tma_tile<kBN, P>(Vs + s * Sm::kKV, &qkv_map, v_full + s, kcol + HD,
                         kt * kBN, b);
      }
    }
  } else {  // consumer warpgroups
    regs_inc<kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int c = (lane & 3) * 2;
    const int row0 = i0 + wg * 64 + warp * 16 + (lane >> 2);
    const int row[2] = {row0, row0 + 8};
    float m[2] = {fast ? 0.f : kNegInf, fast ? 0.f : kNegInf};
    float l[2] = {0.f, 0.f};
    float o[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs);
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, ph = (kt / kStages) & 1;
      const int j0 = kt * kBN;
      const uint32_t k_addr = smem_u32(Ks + s * Sm::kKV);
      const uint32_t v_addr = smem_u32(Vs + s * Sm::kKV);
      float sc[kBN / 2];
      mbar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor<kBM>(q_addr, wg * 64, k),
                       kmajor<kBN>(k_addr, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);

      // the mask is needed only past S or across the diagonal of this
      // warpgroup's rows
      const bool edge =
          j0 + kBN > S || (causal && j0 + kBN - 1 > i0 + wg * 64);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int x = (i >> 1) & 1;
        const int col = j0 + 8 * (i / 4) + c + (i & 1);
        float v = sc[i] * qscale;
        if (edge && (col >= S || (causal && col > row[x]))) v = kNegInf;
        sc[i] = v;
        mx[x] = fmaxf(mx[x], v);
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
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int x = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m_new[x]);
        sum[x] += sc[i];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l[x] = l[x] * alpha[x] + quad_sum(sum[x]);
        m[x] = m_new[x];
      }
      if (!fast) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      }
      uint32_t pa[kBN / 16][4];
      to_a_frags<kBN>(pa, sc);

      mbar_wait(v_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBN / 16; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
          wgmma_rs<1>(o[p], pa[k], mnmajor<kBN>(v_addr, p, k));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) keep(o[p]);
      keep(pa);
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= S) continue;
      const float inv = 1.f / l[x];
      bf16* orow = out + ((size_t)b * S + row[x]) * H * HD + (size_t)h * HD;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * p + 8 * j + c) =
              __floats2bfloat162_rn(o[p][4 * j + 2 * x] * inv,
                                    o[p][4 * j + 2 * x + 1] * inv);
      if ((lane & 3) == 0)
        lse[((size_t)b * H + h) * S + row[x]] = m[x] + log2f(l[x]);
    }
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

constexpr int kBKd = 64;     // K2a: k rows per step of the walk
constexpr int kDqStages = 3;  // K2a: depth of the K/V ring

template <int HD>
struct DqSmem {
  static constexpr int P = HD / 64;
  static constexpr uint32_t kQ = P * panel_bytes(kBM);
  static constexpr uint32_t kKV = P * panel_bytes(kBKd);
  static constexpr uint32_t kOffDO = kQ;
  static constexpr uint32_t kOffK = 2 * kQ;
  static constexpr uint32_t kOffV = kOffK + kDqStages * kKV;
  static constexpr uint32_t kOffStats = kOffV + kDqStages * kKV;
  static constexpr uint32_t kOffBar = kOffStats + kBM * 8;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kDqStages) + 1024;
};

// ------------------------------------------------------ K2a on Hopper
// grid (H, B, ceil(S / 128)), q tiles from the last (causal rows longest
// first). Consumer warpgroup w owns q rows i0 + 64 w .. + 63 and keeps
// their dQ (64 x HD f32) in registers for the whole walk: the CTA owns its
// dq rows, so there is nothing to add across CTAs and the result is the
// same bits every run. The producer loads Q, dO and the rows' (lse, delta)
// once and K, V through a ring of kDqStages 64-row stages. Per k tile: S =
// Q K^T and dP = dO V^T (wgmma, all four operands K-major from the TMA
// tiles), p = exp2(S scale log2e - lse) and dS = p (dP - delta) scale on
// the accumulator registers, rounded to bf16 into A fragments as the TPU
// kernel rounds ds, then dQ += dS K (wgmma, A from registers, K MN-major,
// as K1's P V). 64-row k tiles keep S, dP and dQ (32 + 32 + 64 P f32 a
// thread) within the consumers' 240 registers.
template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float2* __restrict__ stats,
                             bf16* __restrict__ dqkv, int S, int H, int G,
                             float scale, float qscale, int causal) {
  using Sm = DqSmem<HD>;
  constexpr int P = Sm::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + Sm::kOffDO;
  unsigned char* Ks = smem + Sm::kOffK;
  unsigned char* Vs = smem + Sm::kOffV;
  const float2* stats_s = reinterpret_cast<float2*>(smem + Sm::kOffStats);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int g = h / G;
  const int S_pad = (S + kBQh - 1) / kBQh * kBQh;
  const int n_all = (S + kBKd - 1) / kBKd;
  const int n_kt = causal ? min((i0 + kBM - 1) / kBKd + 1, n_all) : n_all;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers) {
      // stats rows stop at S_pad, a multiple of 64 past i0
      const int nst = min(kBM, S_pad - i0);
      mbar_expect_tx(q_full, 2 * Sm::kQ + nst * 8);
      tma_tile<kBM, P>(Qs, &qkv_map, q_full, (g * (G + 2) + h % G) * HD, i0,
                       b);
      tma_tile<kBM, P>(dOs, &do_map, q_full, h * HD, i0, b);
      bulk_load(smem + Sm::kOffStats,
                stats + ((size_t)b * H + h) * S_pad + i0, nst * 8,
                q_full);
      const int kcol = (g * (G + 2) + G) * HD;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        mbar_wait(empty + s, ((kt / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * Sm::kKV);
        tma_tile<kBKd, P>(Ks + s * Sm::kKV, &qkv_map, full + s, kcol,
                          kt * kBKd, b);
        tma_tile<kBKd, P>(Vs + s * Sm::kKV, &qkv_map, full + s, kcol + HD,
                          kt * kBKd, b);
      }
    }
  } else {  // consumer warpgroups
    regs_inc<kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int c = (lane & 3) * 2;
    const int lrow = wg * 64 + warp * 16 + (lane >> 2);
    const int row[2] = {i0 + lrow, i0 + lrow + 8};
    const int r0 = i0 + wg * 64;  // this warpgroup's first row
    float dq[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs), do_addr = smem_u32(dOs);
    mbar_wait(q_full, 0);
    // rows past S_pad were not loaded: (0, 0) keeps their masked terms 0
    float2 st[2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      st[x] = row[x] < S ? stats_s[lrow + 8 * x] : make_float2(0.f, 0.f);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kDqStages, ph = (kt / kDqStages) & 1;
      const int j0 = kt * kBKd;
      if (causal && j0 > r0 + 63) {  // above this warpgroup's diagonal:
        mbar_arrive(empty + s);      // only the walk's last tile
        continue;
      }
      const uint32_t k_addr = smem_u32(Ks + s * Sm::kKV);
      const uint32_t v_addr = smem_u32(Vs + s * Sm::kKV);
      float sc[32], dp[32];
      mbar_wait(full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor<kBM>(q_addr, wg * 64, k),
                       kmajor<kBKd>(k_addr, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(dp, kmajor<kBM>(do_addr, wg * 64, k),
                       kmajor<kBKd>(v_addr, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      keep(dp);

      // the mask is needed only past S or across this warpgroup's diagonal
      const bool edge = j0 + kBKd > S || r0 + 64 > S ||
                        (causal && j0 + kBKd - 1 > r0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1;
        const int col = j0 + 8 * (i / 4) + c + (i & 1);
        const bool out =
            edge && (col >= S || row[x] >= S || (causal && col > row[x]));
        const float p = out ? 0.f : exp2f(sc[i] * qscale - st[x].x);
        sc[i] = p * (dp[i] - st[x].y) * scale;
      }
      uint32_t ds[kBKd / 16][4];
      to_a_frags<kBKd>(ds, sc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBKd / 16; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
          wgmma_rs<1>(dq[p], ds[k], mnmajor<kBKd>(k_addr, p, k));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) keep(dq[p]);
      keep(ds);
      mbar_arrive(empty + s);
    }

    const size_t W = (size_t)(H + 2 * (H / G)) * HD;
    const size_t qoff = (size_t)(g * (G + 2) + h % G) * HD;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= S) continue;
      bf16* drow = dqkv + ((size_t)b * S + row[x]) * W + qoff;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(drow + 64 * p + 8 * j + c) =
              __floats2bfloat162_rn(dq[p][4 * j + 2 * x],
                                    dq[p][4 * j + 2 * x + 1]);
    }
  }
}

template <int HD, bool FUSED>
struct KvSmem {
  static constexpr int P = HD / 64;
  static constexpr int LDQ = HD + 8;  // f32 dq rows, padded against conflicts
  static constexpr uint32_t kKV = P * panel_bytes(kBN);
  static constexpr uint32_t kQ = P * panel_bytes(kBQh);
  static constexpr uint32_t kOffV = kKV;
  static constexpr uint32_t kOffQ = 2 * kKV;
  static constexpr uint32_t kOffDO = kOffQ + kStages * kQ;
  static constexpr uint32_t kOffDS = kOffDO + kStages * kQ;
  static constexpr uint32_t kOffStats = kOffDS + panel_bytes(kBN);
  static constexpr uint32_t kOffDQ = kOffStats + kStages * kBQh * 8;
  static constexpr uint32_t kOffBar =
      kOffDQ + (FUSED ? 2 * kBQh * LDQ * 4 : 0);
  static constexpr size_t kBytes = kOffBar + 8 * (6 + 2 * kStages) + 1024;
};

// ------------------------------------ K2 dk/dv walk (and fused dq), Hopper
// A persistent grid (at most one CTA an SM) walks items (k tile kt, batch
// b, kv group g), item i on CTA i % grid. Consumer warpgroup w owns k rows
// j0 + 64 w .. + 63 with dK and dV in registers; for each of the group's G
// heads the walk takes 64-row q tiles over the causal part: S^T = K Q^T
// and dP^T = V dO^T (wgmma from shared memory), P^T = exp2(S^T - lse) and
// dS^T = P^T (dP^T - delta) scale on the registers, rounded to bf16 into A
// fragments; dV += P^T dO and dK += dS^T Q (wgmma, A from registers, dO
// and Q MN-major).
// FUSED stages dS^T in shared memory (swizzled), computes dQ = dS K
// (warpgroup w: columns 64 w ..) and stages it as f32 in one of two
// buffers. A writer warp of the producer warpgroup adds each staged tile
// into the f32 dq scratch, one bulk copy a tile, in k-tile order: the CTA
// of k tile kt waits until the turn counter of (b, h, q tile) reads kt,
// stores (kt = 0) or reduce-adds the tile and, once it has landed, passes
// the turn on. The consumers only wait for a free buffer, so the chain of
// turns runs beside the products. FUSED takes the items (b, g)-major and
// walks q from the last tile down: k tile kt then trails kt - 1 by one q
// tile, and the few (b, g) in flight keep their scratch in L2. Without
// the chain, K2b takes them kt-major (the longest causal walks first) and
// walks q up from the causal edge.
// No deadlock: an item waits only on the item before it (same b, g, k tile
// kt - 1), and each CTA takes its items in order, so the lowest unfinished
// item can always run.
template <int HD, bool FUSED>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_kv_kernel_sm90(const __grid_constant__ CUtensorMap qkv_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float2* __restrict__ stats,
                             bf16* __restrict__ dqkv,
                             float* __restrict__ dq_acc,
                             int* __restrict__ dq_turn, int B, int S, int H,
                             int G, float scale, float qscale, int causal) {
  using Sm = KvSmem<HD, FUSED>;
  constexpr int P = Sm::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Sm::kOffV;
  unsigned char* Qs = smem + Sm::kOffQ;
  unsigned char* dOs = smem + Sm::kOffDO;
  unsigned char* dSt = smem + Sm::kOffDS;
  float2* stats_s = reinterpret_cast<float2*>(smem + Sm::kOffStats);
  float* dq_s = reinterpret_cast<float*>(smem + Sm::kOffDQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;  // FUSED: the two dq buffers
  uint64_t* dq_empty = dq_full + 2;

  const int KV = H / G;
  const int n_kt = (S + kBN - 1) / kBN, n_qt = (S + kBQh - 1) / kBQh;
  const int S_pad = n_qt * kBQh;
  const int n_items = n_kt * B * KV;
  const size_t W = (size_t)(H + 2 * KV) * HD;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(dq_full + s, kConsumers);
      mbar_init(dq_empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers) {
      int it = 0, n = 0;
      for (int item = blockIdx.x; item < n_items;
           item += gridDim.x, ++n) {
        const int kt = FUSED ? item % n_kt : item / (B * KV);
        const int bg = FUSED ? item / n_kt : item % (B * KV);
        const int b = bg / KV, g = bg % KV;
        const int kcol = (g * (G + 2) + G) * HD;
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * Sm::kKV);
        tma_tile<kBN, P>(Ks, &qkv_map, kv_full, kcol, kt * kBN, b);
        tma_tile<kBN, P>(Vs, &qkv_map, kv_full, kcol + HD, kt * kBN, b);
        const int qt0 = causal ? kt * kBN / kBQh : 0;
        for (int mem = 0; mem < G; ++mem) {
          const int h = g * G + mem;
          for (int qq = 0, qt = FUSED ? n_qt - 1 : qt0; qq < n_qt - qt0;
               ++qq, ++it, qt += FUSED ? -1 : 1) {
            const int s = it % kStages;
            mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full + s, 2 * Sm::kQ + kBQh * 8);
            tma_tile<kBQh, P>(Qs + s * Sm::kQ, &qkv_map, full + s,
                              (g * (G + 2) + mem) * HD, qt * kBQh, b);
            tma_tile<kBQh, P>(dOs + s * Sm::kQ, &do_map, full + s, h * HD,
                              qt * kBQh, b);
            bulk_load(stats_s + s * kBQh,
                      stats + ((size_t)b * H + h) * S_pad + qt * kBQh,
                      kBQh * 8, full + s);
          }
        }
      }
    } else if (FUSED && threadIdx.x / 32 == kConsumers / 32 + 1) {
      // the dq writer warp. A tile's adds are finished (waited for, turn
      // passed on, buffer freed) once the next tile is staged, so they fly
      // while the consumers compute; and always before the writer waits
      // for a turn, so that it never holds one back while it waits.
      const int lane = threadIdx.x % 32;
      int it = 0, prev_kt = -1;
      int* prev_turn = nullptr;
      auto finish = [&](int buf) {
        bulk_wait();
        __syncwarp();
        if (lane == 0) {
          fence_proxy_async();
          st_release(prev_turn, prev_kt + 1);
          mbar_arrive(dq_empty + buf);
        }
      };
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int kt = FUSED ? item % n_kt : item / (B * KV);
        const int bg = FUSED ? item / n_kt : item % (B * KV);
        const int b = bg / KV, g = bg % KV;
        const int qt0 = causal ? kt * kBN / kBQh : 0;
        for (int mem = 0; mem < G; ++mem) {
          const int h = g * G + mem;
          for (int qq = 0, qt = FUSED ? n_qt - 1 : qt0; qq < n_qt - qt0;
               ++qq, ++it, qt += FUSED ? -1 : 1) {
            const int buf = it % 2, i0 = qt * kBQh;
            int* turn = dq_turn + ((size_t)b * H + h) * n_qt + qt;
            mbar_wait(dq_full + buf, (it / 2) & 1);
            if (prev_turn) finish(buf ^ 1);
            if (lane == 0 && kt > 0)
              while (ld_acquire(turn) < kt) __nanosleep(32);
            __syncwarp();
            fence_proxy_async();
            if (lane == 0) {
              const float* src = dq_s + buf * kBQh * Sm::LDQ;
              float* dst = dq_acc + (((size_t)b * H + h) * n_qt + qt) *
                                        (kBQh * Sm::LDQ);
              if (kt == 0)
                bulk_store(dst, src, kBQh * Sm::LDQ * 4);
              else
                bulk_add_f32(dst, src, kBQh * Sm::LDQ * 4);
            }
            bulk_commit();
            prev_turn = turn;
            prev_kt = kt;
          }
        }
      }
      if (prev_turn) finish((it - 1) % 2);
    }
  } else {  // consumer warpgroups
    regs_inc<kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r = lane >> 2, c = (lane & 3) * 2;
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const int kt = FUSED ? item % n_kt : item / (B * KV);
      const int bg = FUSED ? item / n_kt : item % (B * KV);
      const int b = bg / KV, g = bg % KV;
      const int j0 = kt * kBN;
      const int krow[2] = {j0 + wg * 64 + warp * 16 + r,
                           j0 + wg * 64 + warp * 16 + r + 8};
      float dk[P][32], dv[P][32];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.f;
      mbar_wait(kv_full, n & 1);

      const int qt0 = causal ? j0 / kBQh : 0;
      for (int mem = 0; mem < G; ++mem) {
        const int h = g * G + mem;
        for (int qq = 0, qt = FUSED ? n_qt - 1 : qt0; qq < n_qt - qt0;
             ++qq, ++it, qt += FUSED ? -1 : 1) {
          const int s = it % kStages, ph = (it / kStages) & 1;
          const int i0 = qt * kBQh;
          const uint32_t q_addr = smem_u32(Qs + s * Sm::kQ);
          const uint32_t do_addr = smem_u32(dOs + s * Sm::kQ);
          const float2* st_s = stats_s + s * kBQh;
          float st[32], dpt[32];
          mbar_wait(full + s, ph);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < HD / 16; ++k)
            wgmma_ss<0, 0>(st, kmajor<kBN>(k_addr, wg * 64, k),
                           kmajor<kBQh>(q_addr, 0, k), k > 0);
#pragma unroll
          for (int k = 0; k < HD / 16; ++k)
            wgmma_ss<0, 0>(dpt, kmajor<kBN>(v_addr, wg * 64, k),
                           kmajor<kBQh>(do_addr, 0, k), k > 0);
          wgmma_commit();
          wgmma_wait<0>();
          keep(st);
          keep(dpt);

          const bool edge = i0 + kBQh > S || j0 + kBN > S ||
                            (causal && j0 + wg * 64 + 63 > i0);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int li = 8 * (i / 4) + c + (i & 1);
            const int x = (i >> 1) & 1;
            const float2 ld = st_s[li];
            float v = st[i] * qscale;
            if (edge && (i0 + li >= S || krow[x] >= S ||
                         (causal && krow[x] > i0 + li)))
              v = kNegInf;
            const float p = exp2f(v - ld.x);
            st[i] = p;
            dpt[i] = p * (dpt[i] - ld.y) * scale;
          }
          uint32_t pt[4][4], dst[4][4];
          to_a_frags<kBQh>(pt, st);
          to_a_frags<kBQh>(dst, dpt);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kBQh / 16; ++k)
#pragma unroll
            for (int p = 0; p < P; ++p) {
              wgmma_rs<1>(dv[p], pt[k], mnmajor<kBQh>(do_addr, p, k));
              wgmma_rs<1>(dk[p], dst[k], mnmajor<kBQh>(q_addr, p, k));
            }
          wgmma_commit();
          if constexpr (!FUSED) {
            wgmma_wait<0>();
            keep(pt);
            keep(dst);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              keep(dk[p]);
              keep(dv[p]);
            }
            mbar_arrive(empty + s);
          } else {
            // dS^T (128 k rows x 64 q) into the swizzled tile: fragment q of
            // slice k holds rows +8 (q & 1), columns 16 k + 8 (q >> 1) + c
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int R = wg * 64 + warp * 16 + r + 8 * (q & 1);
                const int C = 16 * k + 8 * (q >> 1) + c;
                *reinterpret_cast<uint32_t*>(
                    dSt + R * 128 + (((C >> 3) ^ (R & 7)) << 4) + (C & 7) * 2) =
                    dst[k][q];
              }
            fence_async_smem();
            named_sync(1, kConsumers);  // all of dS^T is staged
            wgmma_wait<0>();            // dV, dK done: the q stage is free
            keep(pt);
            keep(dst);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              keep(dk[p]);
              keep(dv[p]);
            }
            mbar_arrive(empty + s);
            const int buf = it % 2;
            if (wg < P) {
              float dq[32];
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < kBN / 16; ++k)
                wgmma_ss<1, 1>(dq, mnmajor<kBN>(smem_u32(dSt), 0, k),
                               mnmajor<kBN>(k_addr, wg, k), k > 0);
              wgmma_commit();
              float* dq_b = dq_s + buf * kBQh * Sm::LDQ;
              mbar_wait(dq_empty + buf, ((it / 2) & 1) ^ 1);
              wgmma_wait<0>();
              keep(dq);
#pragma unroll
              for (int i = 0; i < 32; i += 2) {
                const int rr = warp * 16 + r + 8 * ((i >> 1) & 1);
                *reinterpret_cast<float2*>(
                    dq_b + rr * Sm::LDQ + wg * 64 + 8 * (i / 4) + c) =
                    make_float2(dq[i], dq[i + 1]);
              }
              fence_async_smem();
            }
            mbar_arrive(dq_full + buf);
            named_sync(1, kConsumers);  // both have read dS^T
          }
        }
      }
      mbar_arrive(kv_empty);

      const size_t koff = (size_t)(g * (G + 2) + G) * HD;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (krow[x] >= S) continue;
        bf16* drow = dqkv + ((size_t)b * S + krow[x]) * W + koff;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * p + 8 * j + c, i = 4 * j + 2 * x;
            *reinterpret_cast<__nv_bfloat162*>(drow + col) =
                __floats2bfloat162_rn(dk[p][i], dk[p][i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(drow + HD + col) =
                __floats2bfloat162_rn(dv[p][i], dv[p][i + 1]);
          }
      }
    }
  }
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
  return ((size_t)(2 * kBQ + 2 * kBK) * (HD + Ty<T>::kPad) +
          (size_t)kBQ * (kBK + Ty<T>::kPad)) * sizeof(T) +
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
};

// above 48 KB a kernel's dynamic shared memory must be allowed explicitly
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
cudaError_t fwd(const Args& a) {
  const size_t smem = fwd_smem<T, HD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.S, a.H, a.H / a.KV,
      a.scale * kLog2e, a.causal, a.fast);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dq(const Args& a) {
  const size_t smem = dq_smem<T, HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.S, a.H, a.H / a.KV, a.scale,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int HD, bool FUSED>
cudaError_t bwd_kv(const Args& a) {
  const size_t smem = kv_smem<T, HD>();
  const auto kernel = flash_bwd_kv_kernel<T, HD, FUSED>;
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
      a.scale, a.scale * kLog2e, a.causal);
  err = cudaGetLastError();
  if (err || !FUSED) return err;
  const size_t n = (size_t)a.B * a.S * a.H * HD;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dq_store_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.dq_acc, static_cast<T*>(a.out), n, a.H, a.H / a.KV, HD);
  return cudaGetLastError();
}

// a bf16 (B, S, width) tensor as a 3-d TMA map with 64 x 64 boxes, 128-byte
// swizzle; rows past S (and columns past width) read as zeros
cudaError_t make_map(CUtensorMap* map, const void* base, int width, int S,
                     int B) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * S * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                     strides, box);
}

template <int HD>
cudaError_t fwd_sm90(const Args& a) {
  CUtensorMap map;
  const int W = (a.H + 2 * a.KV) * HD;
  cudaError_t err = make_map(&map, a.qkv, W, a.S, a.B);
  if (err) return err;
  const size_t smem = FwdSmem<HD>::kBytes;
  err = allow_smem(flash_fwd_kernel_sm90<HD>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.S + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_kernel_sm90<HD><<<grid, kHopperThreads, smem, a.stream>>>(
      map, static_cast<bf16*>(a.out), static_cast<float*>(a.lse_out), a.S,
      a.H, a.H / a.KV, a.scale * kLog2e, a.causal, a.fast);
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
template <int HD>
cudaError_t bwd_dq_sm90(const Args& a) {
  cudaError_t err = a.have_stats ? cudaSuccess : bwd_stats<HD>(a);
  if (err) return err;
  CUtensorMap qkv_map, do_map;
  err = make_map(&qkv_map, a.qkv, (a.H + 2 * a.KV) * HD, a.S, a.B);
  if (!err) err = make_map(&do_map, a.dout, a.H * HD, a.S, a.B);
  if (err) return err;
  const size_t smem = DqSmem<HD>::kBytes;
  err = allow_smem(flash_bwd_dq_kernel_sm90<HD>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.S + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel_sm90<HD><<<grid, kHopperThreads, smem, a.stream>>>(
      qkv_map, do_map, static_cast<const float2*>(a.stats),
      static_cast<bf16*>(a.out), a.S, a.H, a.H / a.KV, a.scale,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// the pre-pass (unless the caller ran it; the fused walk always runs it),
// then the walk on a persistent grid
template <int HD, bool FUSED>
cudaError_t bwd_kv_sm90(const Args& a) {
  cudaError_t err =
      a.have_stats && !FUSED ? cudaSuccess : bwd_stats<HD>(a);
  if (err) return err;
  CUtensorMap qkv_map, do_map;
  err = make_map(&qkv_map, a.qkv, (a.H + 2 * a.KV) * HD, a.S, a.B);
  if (!err) err = make_map(&do_map, a.dout, a.H * HD, a.S, a.B);
  if (err) return err;
  const size_t smem = KvSmem<HD, FUSED>::kBytes;
  err = allow_smem(flash_bwd_kv_kernel_sm90<HD, FUSED>, smem);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const long long items =
      (long long)((a.S + kBN - 1) / kBN) * a.B * a.KV;
  const int grid = (int)(items < sms ? items : sms);
  flash_bwd_kv_kernel_sm90<HD, FUSED><<<grid, kHopperThreads, smem,
                                        a.stream>>>(
      qkv_map, do_map, static_cast<const float2*>(a.stats),
      static_cast<bf16*>(a.out), a.dq_acc, a.turn, a.B, a.S, a.H,
      a.H / a.KV, a.scale, a.scale * kLog2e, a.causal);
  err = cudaGetLastError();
  if (err || !FUSED) return err;
  const size_t n = (size_t)a.B * a.S * a.H * HD / 2;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dq_cast_kernel<HD, KvSmem<HD, true>::LDQ><<<blocks, 256, 0, a.stream>>>(
      a.dq_acc, static_cast<bf16*>(a.out), a.B, a.S, a.H, a.H / a.KV);
  return cudaGetLastError();
}

enum Which { kFwd, kStats, kDq, kDkv, kFused };

// bf16 takes the Hopper kernels; f32 keeps the mma.sync/FFMA ones
template <typename T, int HD>
cudaError_t dispatch(Which w, const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    switch (w) {
      case kFwd: return fwd_sm90<HD>(a);
      case kStats: return bwd_stats<HD>(a);
      case kDq: return bwd_dq_sm90<HD>(a);
      case kDkv: return bwd_kv_sm90<HD, false>(a);
      case kFused: return bwd_kv_sm90<HD, true>(a);
    }
  } else {
    switch (w) {
      case kFwd: return fwd<T, HD>(a);
      case kDq: return bwd_dq<T, HD>(a);
      case kDkv: return bwd_kv<T, HD, false>(a);
      case kFused: return bwd_kv<T, HD, true>(a);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(Which w, const Args& a) {
  if (a.hd == 64) return dispatch<T, 64>(w, a);
  if (a.hd == 128) return dispatch<T, 128>(w, a);
  return cudaErrorInvalidValue;
}

int run(int dtype, Which w, const Args& a) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.KV < 1 || a.H % a.KV ||
      a.B > 65535 || a.H > 65535 || a.KV > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_hd<float>(w, a);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(w, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16;
// hd 64 or 128; any KV dividing H. Each returns a cudaError_t: 0 when the
// launch was accepted.

// out (B, S, H hd) and lse (B, H, S) f32 from qkv (B, S, W)
extern "C" int nk_flash_fwd_qkv(int dtype, const void* qkv, void* out,
                                void* lse, int B, int S, int H, int KV,
                                int hd, float scale, int causal, int fast,
                                void* stream) {
  Args a{qkv, nullptr, nullptr, nullptr, out, lse, nullptr, nullptr, nullptr,
         0, B, S, H, KV, hd, causal, fast, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kFwd, a);
}

// bf16 only: the backward's pre-pass, stats f32 (B, H, 64 ceil(S / 64), 2)
// = (lse, rowsum(dO . O)) per row, rows past S (0, 0); K2a and K2b take it
// with have_stats = 1, so a split backward runs it once
extern "C" int nk_flash_bwd_stats_qkv(int dtype, const void* o,
                                      const void* lse, const void* dout,
                                      void* stats, int B, int S, int H,
                                      int hd, void* stream) {
  Args a{nullptr, o, lse, dout, nullptr, nullptr, nullptr, stats, nullptr,
         0, B, S, H, H, hd, 0, 0, 0.f, static_cast<cudaStream_t>(stream)};
  return run(dtype, kStats, a);
}

// the q chunks of dqkv (B, S, W); bf16: stats as above, filled here unless
// have_stats (unused in f32)
extern "C" int nk_flash_bwd_dq_qkv(int dtype, const void* qkv, const void* o,
                                   const void* lse, const void* dout,
                                   void* stats, int have_stats, void* dqkv,
                                   int B, int S, int H, int KV, int hd,
                                   float scale, int causal, void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr, stats, nullptr,
         have_stats, B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kDq, a);
}

// the k and v chunks of dqkv (B, S, W); stats as for dq
extern "C" int nk_flash_bwd_dkv_qkv(int dtype, const void* qkv,
                                    const void* o, const void* lse,
                                    const void* dout, void* stats,
                                    int have_stats, void* dqkv, int B, int S,
                                    int H, int KV, int hd, float scale,
                                    int causal, void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr, stats, nullptr,
         have_stats, B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kDkv, a);
}

// all of dqkv (B, S, W); dq is summed over k tiles in a fixed order, so the
// result is the same bits every run. bf16: stats as above (always filled
// here), dq_acc f32 (B, H, ceil(S / 64), 64, hd + 8) scratch and turn,
// int32 (B, H, ceil(S / 64)) that the caller zeroes. f32: dq_acc f32 (B, S,
// H hd) scratch and turn, int32 (B, H, ceil(S / 32)) that the caller
// zeroes (stats unused).
extern "C" int nk_flash_bwd_fused_qkv(int dtype, const void* qkv,
                                      const void* o, const void* lse,
                                      const void* dout, void* stats,
                                      void* dq_acc, void* turn, void* dqkv,
                                      int B, int S, int H, int KV, int hd,
                                      float scale, int causal, void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, static_cast<float*>(dq_acc),
         stats, static_cast<int*>(turn), 0,
         B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kFused, a);
}
