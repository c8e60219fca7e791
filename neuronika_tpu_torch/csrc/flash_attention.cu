// Flash attention on (B, H, S, hd) q, k, v, forward and backward, on Hopper.
//
// Replaces three TPU kernels of neuronika_tpu/ops/pallas/attention.py:
//   K5 _fwd_kernel      -> split_fwd_kernel_sm90 (bf16),
//                          split_fwd_kernel (f32)
//   K6 _bwd_dq_kernel   -> split_bwd_dq_kernel_sm90 (bf16),
//                          split_bwd_dq_kernel (f32)
//   K7 _bwd_dkv_kernel  -> split_bwd_dkv_kernel_sm90 (bf16),
//                          split_bwd_dkv_kernel (f32)
//
// Contract (that of ops/flash_attention.py's flash_fwd, flash_bwd_dq and
// flash_bwd_dkv):
//   q (B, H, Sq, hd), k and v (B, H, Skv, hd), do (B, H, Sq, hd), hd 1 to
//        256: strided views are read through their (batch, head, row)
//        strides; the last axis has stride 1 and no axis longer than 1 has
//        stride 0; on the Hopper route base and strides are 16-byte
//        aligned (the other route reads elements where they are not);
//   out, dq (B, H, Sq, hd) and dk, dv (B, H, Skv, hd): contiguous, in the
//        inputs' dtype;
//   lse, delta (B, H, Sq) f32, contiguous; lse is base 2 (m + log2(l)).
// s = q.k * scale * log2(e) (exp2 domain). causal keeps keys col <= row
// (Sq == Skv); window (causal only) also drops col <= row - window. The
// backward takes lse and delta = rowsum(dO . O) as inputs and never
// recomputes them (ring attention feeds a global lse and a masked dO), and
// clamps p = exp2(min(s - lse, 0)) as the TPU kernels do.
//
// What bounds it: at hd 128 each (q row, k row) pair costs 4 hd flops in the
// forward, 6 hd in dq and 8 hd in dk/dv, against 2 hd bytes read per row
// once; at S 8192 and a 4096 window that is far above the card's ~295
// flop/byte, so the tensor cores and the softmax's exp2/FMA work are the
// limit. Every S x S quantity stays on chip, and a CTA walks only the
// other side's tiles that meet the causal/window band: tiles above the
// diagonal and tiles wholly below the window are never visited; a tile
// crossing the diagonal, the window's lower edge or the ragged end of S
// evaluates the mask rows >= cols && rows - cols < window (struct Band,
// flash_sm90.cuh), interior tiles skip it.
//
// bf16 (K5, K6, K7) runs the Hopper walks that the packed K1, K2a and
// K2b run (flash_sm90.cuh: wgmma, TMA through mbarrier rings, a producer
// warpgroup, setmaxnreg), through a tile policy of this layout: each
// operand is a 4-d TMA map over (hd, S, H, B) built from its own strides,
// 64 x 64 boxes with 128-byte swizzle, rows past Sq or Skv zero-filled;
// the rows' lse and delta come from their two f32 arrays by plain loads of
// a stats warp of the producer warpgroup (a bulk copy would need
// 16-byte-aligned rows, which a ragged Sq breaks), 0 past Sq. K5: 128 q
// rows a CTA, O in registers over the band's 128-row k tiles, from
// max(0, i0 - window + 1) / 128, K and V through a two-stage ring, P
// rounded to bf16 in registers as the A operand of P V;
// K6: 128 q rows a CTA, dQ in registers over the band's 64-row k tiles;
// K7: 128 k rows a CTA on a persistent grid, dK and dV in registers over
// the band's 64-row q tiles, from the diagonal to the last row whose
// window holds the CTA's last key (K5, K6 and K7 at hd 64, 96 and 128: hd
// 96 as a 64-column and a 32-column panel, flash_sm90.cuh::panels). Each
// CTA owns its output rows: no atomics, the same bits every run.
// f32 (K5, K6, K7), and bf16 off the Hopper route, run mma.sync-shaped
// tiles from shared memory, each warp owning 16 rows of a 64-row tile
// (flash_tiles.cuh), with synchronous tile loads: on FFMA in f32 (wgmma
// has no FFMA path, and f32 is the oracle route), on mma.sync in bf16. p
// and ds are rounded to the input dtype before their products, where the
// TPU kernels round them.
// Attention dropout (dropout.cuh): each kernel has a DROPOUT template flag;
// set, the keep bit of every (q row, key) is drawn on every tile of the
// band, K5 zeroes the dropped p before P V and scales the output by 1 / (1 -
// rate), K6 and K7 drop dp and the p of dV; unset, the code is that of no
// dropout. The mask is keyed by the q head h, as the model repeats k/v over
// a GQA group before this layout.
// Head dims: the Hopper kernels take bf16 at hd 64, 96 (Phi-3-mini's) and
// 128; f32, and bf16 at every other hd from 1 to 256, run the
// mma.sync/FFMA kernels (the
// first half, now in bf16 too), instantiated at the head-dim tiers of
// hd_tier (flash_tiles.cuh) and masking the runtime hd, as the packed
// layout's do (flash_attention_qkv.cu says how). At the 256 tier the f32
// K6 steps over 32-row k tiles (dq_bk) to stay within shared memory.
// Not done yet: GQA without the repeated k/v (K2b's walk over a kv group's
// G heads per k tile carries over).

#include <math.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 64;   // f32 K5 and K6: q rows per CTA (16 per warp)
constexpr int kBK = 64;   // k rows per tile (f32 K7: per CTA, 16 per warp)
constexpr int kBQb = 32;  // f32 K7: q rows per inner tile

struct Strides {  // elements between batches, heads and rows
  long long b, h, s;
};

// K6's k rows per tile: 32 in f32 above the 128 tier, where four 64-row
// tiles of 256 f32 columns would pass the 227 KB of shared memory
template <typename T, int HD>
__host__ __device__ constexpr int dq_bk() {
  return sizeof(T) == 4 && HD > 128 ? 32 : kBK;
}

// ---------------------------------------------------------------- K5, f32
// grid (ceil(Sq / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15.
template <typename T, int HD, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    split_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, int H, int hd, Band band, float qscale,
                     Dropout drop) {
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
  const T* ksrc = k + b * sk.b + h * sk.h;
  const T* vsrc = v + b * sv.b + h * sv.h;
  load_tile<T, HD>(Qs, LD, q + b * sq.b + h * sq.h, sq.s, i0, kBQ, band.Sq,
                   hd);

  const T* Qw = Qs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LDP;
  const int row[2] = {i0 + warp * 16 + r, i0 + warp * 16 + r + 8};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NTO][4];
  zero(acc);

  int kt0, kt1;
  band.k_tiles(i0, kBQ, kBK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, HD>(Ks, LD, ksrc, sk.s, j0, kBK, band.Skv, hd);
    load_tile<T, HD>(Vs, LD, vsrc, sv.s, j0, kBK, band.Skv, hd);
    __syncthreads();
    float s[NTS][4];
    zero(s);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    const bool edge = band.edge(i0, kBQ, j0, kBK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * qscale;
        if (edge && band.masked(row[e >> 1], j0 + nt * 8 + c + (e & 1)))
          x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m_new[x] = fmaxf(m[x], quad_max(mx[x]));
      alpha[x] = exp2f(m[x] - m_new[x]);
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
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    __syncwarp();
    warp_gemm<T, NTO, kBK, false, true>(acc, Pw, LDP, Vs, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = row[x];
    if (rw >= band.Sq) continue;
    const float inv = (DROPOUT ? drop.inv_keep : 1.f) / l[x];
    const size_t at = ((size_t)b * H + h) * band.Sq + rw;
    T* orow = out + at * hd;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + c + e < hd)
          orow[nt * 8 + c + e] = Ty<T>::from(acc[nt][2 * x + e] * inv);
    if ((lane & 3) == 0) lse[at] = m[x] + log2f(l[x]);
  }
}

// lse and delta of q rows row0 .. row0 + n - 1 (0 past Sq) into shared memory
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, size_t base,
                                          int row0, int n, int Sq) {
  for (int rr = threadIdx.x; rr < n; rr += kThreads) {
    const bool in = row0 + rr < Sq;
    lse_s[rr] = in ? lse[base + row0 + rr] : 0.f;
    delta_s[rr] = in ? delta[base + row0 + rr] : 0.f;
  }
}

// ---------------------------------------------------------------- K6, f32
// grid (ceil(Sq / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15 and
// walks the k tiles of the band.
template <typename T, int HD, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    split_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        int H, int hd, Band band, float scale, float qscale,
                        Dropout drop) {
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
  const T* ksrc = k + b * sk.b + h * sk.h;
  const T* vsrc = v + b * sv.b + h * sv.h;
  const size_t rows = ((size_t)b * H + h) * band.Sq;
  load_tile<T, HD>(Qs, LD, q + b * sq.b + h * sq.h, sq.s, i0, kBQ, band.Sq,
                   hd);
  load_tile<T, HD>(dOs, LD, dout + b * sdo.b + h * sdo.h, sdo.s, i0, kBQ,
                   band.Sq, hd);
  load_rows(lse_s, delta_s, lse, delta, rows, i0, kBQ, band.Sq);

  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* dSw = dSs + warp * 16 * LDP;
  const int lr[2] = {warp * 16 + r, warp * 16 + r + 8};
  float dqa[NTO][4];
  zero(dqa);

  int kt0, kt1;
  band.k_tiles(i0, kBQ, BK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // row stats written; previous K/V tile read
    load_tile<T, HD>(Ks, LD, ksrc, sk.s, j0, BK, band.Skv, hd);
    load_tile<T, HD>(Vs, LD, vsrc, sv.s, j0, BK, band.Skv, hd);
    __syncthreads();
    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dp, dOw, LD, Vs, LD, lane);
    const bool edge = band.edge(i0, kBQ, j0, BK);
    bool kp[2][2];  // DROPOUT: keep bits of this column pair in both rows
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lrow = lr[e >> 1];
        float x = s[nt][e] * qscale;
        if (edge && (i0 + lrow >= band.Sq ||
                     band.masked(i0 + lrow, j0 + nt * 8 + c + (e & 1))))
          x = kNegInf;
        // p <= 1 whenever lse covers the row; the clamp keeps a foreign
        // lse (ring attention's future blocks) from overflowing exp2
        const float p = exp2f(fminf(x - lse_s[lrow], 0.f));
        float d = dp[nt][e];
        if constexpr (DROPOUT) {
          if (e == 0)
            for (int y = 0; y < 2; ++y)
              drop.cols2(b, h, i0 + lr[y], j0 + nt * 8 + c, kp[y][0],
                         kp[y][1]);
          d = kp[e >> 1][e & 1] ? d * drop.inv_keep : 0.f;
        }
        const float ds = p * (d - delta_s[lrow]) * scale;
        dSw[(r + 8 * (e >> 1)) * LDP + nt * 8 + c + (e & 1)] = Ty<T>::from(ds);
      }
    __syncwarp();
    warp_gemm<T, NTO, BK, false, true>(dqa, dSw, LDP, Ks, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = i0 + lr[x];
    if (rw >= band.Sq) continue;
    T* drow = dq + (rows + rw) * hd;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + c + e < hd)
          drow[nt * 8 + c + e] = Ty<T>::from(dqa[nt][2 * x + e]);
  }
}

// ---------------------------------------------------------------- K7, f32
// grid (ceil(Skv / kBK), H, B); warp w owns key rows w*16 .. w*16 + 15 of
// the CTA's k/v tile and walks the q tiles of the band, from the diagonal
// to the last row whose window holds the tile's last key.
template <typename T, int HD, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    split_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, int H, int hd, Band band,
                         float scale, float qscale, Dropout drop) {
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

  const int j0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const T* qsrc = q + b * sq.b + h * sq.h;
  const T* dosrc = dout + b * sdo.b + h * sdo.h;
  const size_t rows = ((size_t)b * H + h) * band.Sq;
  load_tile<T, HD>(Ks, LD, k + b * sk.b + h * sk.h, sk.s, j0, kBK, band.Skv,
                   hd);
  load_tile<T, HD>(Vs, LD, v + b * sv.b + h * sv.h, sv.s, j0, kBK, band.Skv,
                   hd);

  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  T* PTw = PTs + warp * 16 * LDP;
  T* dSTw = dSTs + warp * 16 * LDP;
  const int jr[2] = {j0 + warp * 16 + r, j0 + warp * 16 + r + 8};
  float dka[NTO][4], dva[NTO][4];
  zero(dka);
  zero(dva);

  int it0, it1;
  band.q_tiles(j0, kBK, kBQb, &it0, &it1);
  for (int it = it0; it < it1; ++it) {
    const int i0 = it * kBQb;
    __syncthreads();  // the previous q tile is no longer read
    load_tile<T, HD>(Qs, LD, qsrc, sq.s, i0, kBQb, band.Sq, hd);
    load_tile<T, HD>(dOs, LD, dosrc, sdo.s, i0, kBQb, band.Sq, hd);
    load_rows(lse_s, delta_s, lse, delta, rows, i0, kBQb, band.Sq);
    __syncthreads();
    float sT[NTS][4], dpT[NTS][4];
    zero(sT);
    zero(dpT);
    warp_gemm<T, NTS, HD, false, false>(sT, Kw, LD, Qs, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dpT, Vw, LD, dOs, LD, lane);
    const bool edge = band.edge(i0, kBQb, j0, kBK);
    bool kp[2][2];  // DROPOUT: keep bits of this q row pair at both keys
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = nt * 8 + c + (e & 1), i = i0 + li;
        float x = sT[nt][e] * qscale;
        if (edge && (i >= band.Sq || band.masked(i, jr[e >> 1]))) x = kNegInf;
        const float p = exp2f(fminf(x - lse_s[li], 0.f));  // see K6
        float pv = p, d = dpT[nt][e];
        if constexpr (DROPOUT) {
          if (e == 0)
            for (int y = 0; y < 2; ++y)
              drop.rows2(b, h, i0 + nt * 8 + c, jr[y], kp[y][0], kp[y][1]);
          const bool keep = kp[e >> 1][e & 1];
          pv = keep ? p * drop.inv_keep : 0.f;
          d = keep ? d * drop.inv_keep : 0.f;
        }
        const float ds = p * (d - delta_s[li]) * scale;
        const int at = (r + 8 * (e >> 1)) * LDP + li;
        PTw[at] = Ty<T>::from(pv);
        dSTw[at] = Ty<T>::from(ds);
      }
    __syncwarp();
    warp_gemm<T, NTO, kBQb, false, true>(dva, PTw, LDP, dOs, LD, lane);
    warp_gemm<T, NTO, kBQb, false, true>(dka, dSTw, LDP, Qs, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = jr[x];
    if (j >= band.Skv) continue;
    const size_t at = (((size_t)b * H + h) * band.Skv + j) * hd;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + c + e < hd) {
          dk[at + nt * 8 + c + e] = Ty<T>::from(dka[nt][2 * x + e]);
          dv[at + nt * 8 + c + e] = Ty<T>::from(dva[nt][2 * x + e]);
        }
  }
}

// --------------------------------------------- K5, K6 and K7, bf16, Hopper
// The split layout as a tile policy of the Hopper walks (flash_sm90.cuh):
// q, k, v and dO each through a 4-d TMA map over (hd, S, H, B); lse and
// delta (B, H, Sq) f32 loaded by the producer warp's 32 lanes; out, dq,
// dk, dv (B, H, S, hd) and the forward's lse (B, H, Sq) contiguous. No GQA
// here: k/v head g serves q head g.
template <int HD>
struct SplitTiles {
  static constexpr bool kStatsWarp = true;
  static constexpr bool kClamp = true;
  static constexpr bool kFast = false;
  // this producer's four maps and stats loads spill at 24 registers; at hd
  // 64 and 96 the consumers can spare 8 (hd 96's dK + dV hold 96 f32 a
  // thread, hd 128's 128; on an H100, 24 / 240 at hd 96 read K6 and K7
  // 3-6% slower without dropout), at hd 128 they cannot
  static constexpr int kRegsProducer = HD == 128 ? 24 : 40;
  static constexpr int kRegsConsumer = HD == 128 ? 240 : 232;
  static constexpr int P = panels(HD);
  const CUtensorMap *q, *k, *v, *dout;
  const float* lse;
  const float* delta;
  bf16 *dq, *dk, *dv;
  Band band;
  int B, H;
  static constexpr int G = 1;
  int KV;
  bf16* out = nullptr;       // K5
  float* lse_out = nullptr;  // K5

  // ROWS x HD of a map at (row, h, b), as P panels of 64-row boxes (at hd
  // 96 the second box's columns 96-127 lie past the map and read as 0)
  template <int ROWS>
  __device__ static void tile(unsigned char* dst, const CUtensorMap* map,
                              uint64_t* bar, int b, int h, int row) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int rb = 0; rb < ROWS / 64; ++rb)
        tma_load_4d(dst + p * panel_bytes(ROWS) + rb * panel_bytes(64), map,
                    bar, 64 * p, row + 64 * rb, h, b);
  }
  template <int ROWS>
  __device__ void q_tile(unsigned char* dst, uint64_t* bar, int b, int h,
                         int row) const {
    tile<ROWS>(dst, q, bar, b, h, row);
  }
  template <int ROWS>
  __device__ void do_tile(unsigned char* dst, uint64_t* bar, int b, int h,
                          int row) const {
    tile<ROWS>(dst, dout, bar, b, h, row);
  }
  template <int ROWS>
  __device__ void k_tile(unsigned char* dst, uint64_t* bar, int b, int g,
                         int row) const {
    tile<ROWS>(dst, k, bar, b, g, row);
  }
  template <int ROWS>
  __device__ void v_tile(unsigned char* dst, uint64_t* bar, int b, int g,
                         int row) const {
    tile<ROWS>(dst, v, bar, b, g, row);
  }
  __device__ uint32_t stats_tx(int, int, int, int) const { return 0; }
  __device__ void stats(float2* dst, uint64_t*, int b, int h, int row0,
                        int n, int lane) const {
    const size_t base = ((size_t)b * H + h) * band.Sq;
    for (int r = lane; r < n; r += 32) {
      const int row = row0 + r;
      dst[r] = row < band.Sq
                   ? make_float2(lse[base + row], delta[base + row])
                   : make_float2(0.f, 0.f);
    }
  }
  __device__ void store_o(int b, int h, int row, int col, float lo,
                          float hi) const {
    *reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * H + h) * band.Sq + row) * HD + col) =
        __floats2bfloat162_rn(lo, hi);
  }
  __device__ void store_lse(int b, int h, int row, float v) const {
    lse_out[((size_t)b * H + h) * band.Sq + row] = v;
  }
  __device__ void store_dq(int b, int h, int row, int col, float lo,
                           float hi) const {
    *reinterpret_cast<__nv_bfloat162*>(
        dq + (((size_t)b * H + h) * band.Sq + row) * HD + col) =
        __floats2bfloat162_rn(lo, hi);
  }
  __device__ void store_dkv(int b, int g, int row, int col, float k0,
                            float k1, float v0, float v1) const {
    const size_t at = (((size_t)b * H + g) * band.Skv + row) * HD + col;
    *reinterpret_cast<__nv_bfloat162*>(dk + at) =
        __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<__nv_bfloat162*>(dv + at) =
        __floats2bfloat162_rn(v0, v1);
  }
};

// K5: grid (H, B, ceil(Sq / 128)), q tiles from the last (the longest
// walks first under a causal band); the walk is fwd_walk. The forward has
// no dO: its policy holds no map for it.
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_fwd_kernel_sm90(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int B, int H, Band band, float qscale,
                          Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitTiles<HD> t{&q_map, &k_map, &v_map, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, band, B, H, H, out, lse};
  fwd_walk<HD, DROPOUT>(t, align1024(smem_raw), blockIdx.x, blockIdx.y,
                        (gridDim.z - 1 - blockIdx.z) * kBM, qscale, false,
                        drop);
}

// K6: grid (H, B, ceil(Sq / 128)), q tiles from the last (the longest
// walks first under a causal band); the walk is dq_walk
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int B, int H, Band band,
                             float scale, float qscale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitTiles<HD> t{&q_map, &k_map, &v_map, &do_map, lse, delta, dq,
                         nullptr, nullptr, band, B, H, H};
  dq_walk<HD, DROPOUT>(t, align1024(smem_raw), blockIdx.x, blockIdx.y,
                       (gridDim.z - 1 - blockIdx.z) * kBM, scale, qscale,
                       drop);
}

// K7: a persistent grid over (k tile, batch, head) items, k-tile-major
// (the longest walks first); the walk is kv_walk
template <int HD, bool DROPOUT>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int B, int H, Band band, float scale,
                              float qscale, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitTiles<HD> t{&q_map, &k_map, &v_map, &do_map, lse, delta,
                         nullptr, dk, dv, band, B, H, H};
  kv_walk<HD, false, DROPOUT>(t, align1024(smem_raw), nullptr, nullptr,
                              scale, qscale, drop);
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
constexpr size_t dkv_smem() {
  return ((size_t)(2 * kBK + 2 * kBQb) * (HD + Ty<T>::kPad) +
          (size_t)2 * kBK * (kBQb + Ty<T>::kPad)) * sizeof(T) +
         2 * kBQb * sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out, *dk, *dv;  // forward: out; dq: out; dk/dv: dk, dv
  float* lse_out;
  Strides sq, sk, sv, sdo;
  int B, H, hd;
  Band band;
  float scale;
  cudaStream_t stream;
  Dropout drop;  // threshold 0: no dropout
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
  cudaError_t err = allow_smem(split_fwd_kernel<T, HD, DROP>, smem);
  if (err) return err;
  const dim3 grid((a.band.Sq + kBQ - 1) / kBQ, a.H, a.B);
  split_fwd_kernel<T, HD, DROP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse_out, a.sq,
      a.sk, a.sv, a.H, a.hd, a.band, a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

template <typename T, int HD, bool DROP>
cudaError_t bwd_dq(const Args& a) {
  const size_t smem = dq_smem<T, HD>();
  cudaError_t err = allow_smem(split_bwd_dq_kernel<T, HD, DROP>, smem);
  if (err) return err;
  const dim3 grid((a.band.Sq + kBQ - 1) / kBQ, a.H, a.B);
  split_bwd_dq_kernel<T, HD, DROP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.out), a.sq, a.sk, a.sv, a.sdo, a.H, a.hd,
      a.band, a.scale, a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

template <typename T, int HD, bool DROP>
cudaError_t bwd_dkv(const Args& a) {
  const size_t smem = dkv_smem<T, HD>();
  cudaError_t err = allow_smem(split_bwd_dkv_kernel<T, HD, DROP>, smem);
  if (err) return err;
  const dim3 grid((a.band.Skv + kBK - 1) / kBK, a.H, a.B);
  split_bwd_dkv_kernel<T, HD, DROP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.sv, a.sdo, a.H, a.hd, a.band, a.scale, a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

// a bf16 (B, H, S, hd) operand, read through its (batch, head, row)
// strides, as a 4-d TMA map over (hd, S, H, B) with 64 x 64 boxes; an axis
// of length 1 never steps, so its stride is set to a valid one
cudaError_t split_map(CUtensorMap* map, const void* base, Strides st, int B,
                      int H, int S, int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1)
      strides[i] = i ? strides[i - 1] * dims[i] : (cuuint64_t)hd * 2;
    if (strides[i] == 0) return cudaErrorInvalidValue;
  }
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                  strides, box);
}

// the maps of q, k, v and (n = 4, the backward) do
cudaError_t split_maps(CUtensorMap* m, const Args& a, int n = 4) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const Strides st[4] = {a.sq, a.sk, a.sv, a.sdo};
  const int S[4] = {a.band.Sq, a.band.Skv, a.band.Skv, a.band.Sq};
  for (int i = 0; i < n; ++i) {
    const cudaError_t err =
        split_map(&m[i], base[i], st[i], a.B, a.H, S[i], a.hd);
    if (err) return err;
  }
  return cudaSuccess;
}

template <int HD, bool DROP>
cudaError_t fwd_sm90(const Args& a) {
  CUtensorMap m[3];
  cudaError_t err = split_maps(m, a, 3);
  if (err) return err;
  const size_t smem = FwdSmem<HD>::kBytes;
  err = allow_smem(split_fwd_kernel_sm90<HD, DROP>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.band.Sq + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  split_fwd_kernel_sm90<HD, DROP><<<grid, kHopperThreads, smem, a.stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(a.out), a.lse_out, a.B, a.H,
      a.band, a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

template <int HD, bool DROP>
cudaError_t bwd_dq_sm90(const Args& a) {
  CUtensorMap m[4];
  cudaError_t err = split_maps(m, a);
  if (err) return err;
  const size_t smem = DqSmem<HD>::kBytes;
  err = allow_smem(split_bwd_dq_kernel_sm90<HD, DROP>, smem);
  if (err) return err;
  const dim3 grid(a.H, a.B, (a.band.Sq + kBM - 1) / kBM);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  split_bwd_dq_kernel_sm90<HD, DROP><<<grid, kHopperThreads, smem,
                                       a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse_in, a.delta, static_cast<bf16*>(a.out),
      a.B, a.H, a.band, a.scale, a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

template <int HD, bool DROP>
cudaError_t bwd_dkv_sm90(const Args& a) {
  CUtensorMap m[4];
  cudaError_t err = split_maps(m, a);
  if (err) return err;
  const size_t smem = KvSmem<HD, false>::kBytes;
  err = allow_smem(split_bwd_dkv_kernel_sm90<HD, DROP>, smem);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const long long items =
      (long long)((a.band.Skv + kBN - 1) / kBN) * a.B * a.H;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  split_bwd_dkv_kernel_sm90<HD, DROP><<<grid, kHopperThreads, smem,
                                        a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse_in, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B, a.H, a.band, a.scale,
      a.scale * kLog2e, a.drop);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

// The routes. The caller picks one (ops/flash_attention.py::_sm90_route)
// and passes it as `sm90`, since its operand alignment depends on it: the
// Hopper kernels, built for bf16 at hd 64, 96 and 128 (a launch asking for
// them elsewhere is refused), or the mma.sync/FFMA kernels, which take f32
// and bf16 at any hd from 1 to 256, instantiated at the head-dim tiers of
// hd_tier and masking the runtime hd
template <int HD, bool DROP>
cudaError_t dispatch_sm90(Which w, const Args& a) {
  if (w == kFwd) return fwd_sm90<HD, DROP>(a);
  if (w == kDq) return bwd_dq_sm90<HD, DROP>(a);
  if (w == kDkv) return bwd_dkv_sm90<HD, DROP>(a);
  return cudaErrorInvalidValue;
}

template <typename T, int HD, bool DROP>
cudaError_t dispatch_core(Which w, const Args& a) {
  if (w == kFwd) return fwd<T, HD, DROP>(a);
  if (w == kDq) return bwd_dq<T, HD, DROP>(a);
  if (w == kDkv) return bwd_dkv<T, HD, DROP>(a);
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
    if (dtype != 1) return cudaErrorInvalidValue;
    switch (a.hd) {
      case 64: return dispatch_sm90<64, DROP>(w, a);
      case 96: return dispatch_sm90<96, DROP>(w, a);
      case 128: return dispatch_sm90<128, DROP>(w, a);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch_tier<float, DROP>(w, a);
  if (dtype == 1) return dispatch_tier<__nv_bfloat16, DROP>(w, a);
  return cudaErrorInvalidValue;
}

int run(int dtype, int sm90, Which w, const Args& a) {
  const Band& n = a.band;
  if (a.B < 1 || a.H < 1 || n.Sq < 1 || n.Skv < 1 || a.B > 65535 ||
      a.H > 65535 || n.window < 0 || (n.causal && n.Sq != n.Skv) ||
      (n.window && !n.causal) || a.hd < 1 || a.hd > 256)
    return cudaErrorInvalidValue;
  // the DROPOUT instantiations when the threshold is not 0
  if (a.drop.threshold != 0) return dispatch<true>(dtype, sm90, w, a);
  return dispatch<false>(dtype, sm90, w, a);
}

Strides strides_of(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

Dropout dropout_of(unsigned long long seed, unsigned threshold,
                   float inv_keep) {
  return Dropout{(uint32_t)seed, (uint32_t)(seed >> 32), threshold, inv_keep};
}

}  // namespace

// C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16;
// sm90: 1 for the Hopper kernels, 0 for the others (see the routes above);
// hd 1 to 256. `strides` holds (batch, head, row) strides in elements: q, k, v
// for the forward, then do for the backward. Attention dropout
// (dropout.cuh): seed, threshold = min(floor(rate 2^32), 2^32 - 1) and
// inv_keep = 1 / (1 - rate); threshold 0 runs without it. Each returns a
// cudaError_t: 0 when the launch was accepted.

// out (B, H, Sq, hd) and lse (B, H, Sq) f32
extern "C" int nk_flash_fwd(int dtype, int sm90, const void* q,
                            const void* k, const void* v, void* out, void* lse,
                            const long long* strides, int B, int H, int Sq,
                            int Skv, int hd, float scale, int causal,
                            int window, unsigned long long seed,
                            unsigned threshold, float inv_keep,
                            void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.lse_out = static_cast<float*>(lse);
  a.sq = strides_of(strides, 0);
  a.sk = strides_of(strides, 1);
  a.sv = strides_of(strides, 2);
  a.B = B; a.H = H; a.hd = hd;
  a.band = Band{Sq, Skv, causal, window};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  a.drop = dropout_of(seed, threshold, inv_keep);
  return run(dtype, sm90, kFwd, a);
}

// dq (B, H, Sq, hd) from lse and delta (B, H, Sq) f32
extern "C" int nk_flash_bwd_dq(int dtype, int sm90, const void* q,
                               const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               const long long* strides, int B, int H, int Sq,
                               int Skv, int hd, float scale, int causal,
                               int window, unsigned long long seed,
                               unsigned threshold, float inv_keep,
                               void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.out = dq;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.sq = strides_of(strides, 0);
  a.sk = strides_of(strides, 1);
  a.sv = strides_of(strides, 2);
  a.sdo = strides_of(strides, 3);
  a.B = B; a.H = H; a.hd = hd;
  a.band = Band{Sq, Skv, causal, window};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  a.drop = dropout_of(seed, threshold, inv_keep);
  return run(dtype, sm90, kDq, a);
}

// dk and dv (B, H, Skv, hd) from lse and delta (B, H, Sq) f32
extern "C" int nk_flash_bwd_dkv(int dtype, int sm90, const void* q,
                                const void* k, const void* v,
                                const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, const long long* strides, int B,
                                int H, int Sq, int Skv, int hd, float scale,
                                int causal, int window,
                                unsigned long long seed, unsigned threshold,
                                float inv_keep, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dk = dk; a.dv = dv;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.sq = strides_of(strides, 0);
  a.sk = strides_of(strides, 1);
  a.sv = strides_of(strides, 2);
  a.sdo = strides_of(strides, 3);
  a.B = B; a.H = H; a.hd = hd;
  a.band = Band{Sq, Skv, causal, window};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  a.drop = dropout_of(seed, threshold, inv_keep);
  return run(dtype, sm90, kDkv, a);
}
