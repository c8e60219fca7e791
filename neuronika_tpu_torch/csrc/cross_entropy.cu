// Fused linear cross-entropy on Hopper: K8, K9 and K10.
//
// Replaces three kernels of neuronika_tpu/ops/pallas/cross_entropy.py:
//   K8  _ce_fwd_kernel  per-row loss = lse - target logit, and lse, of
//                       softmax(x W^T)                          -> nk_ce_fwd
//   K9  _ce_dx_kernel   dx = sum_j cast(p g) W_j                -> nk_ce_dx
//   K10 _ce_dw_kernel   dW = sum_i cast(p g)^T x_i              -> nk_ce_dw
// with x (N, D), W (V, D) row-major in one dtype, targets (N,) int32, lse
// and the row weights g (N,) f32, p = exp(logit - lse) - onehot(target)
// and cast() the rounding of p g to the operands' dtype, as the TPU kernels
// round it before their second product. The (N, V) logits never reach
// device memory: each kernel recomputes its logits tile by tile.
//
// What bounds it: 2 N V D operations for the forward and 4 N V D for each
// gradient, against (N + V) D bytes of operands; at the GPT train step's
// N 32768, V 16384, D 1536 that is thousands of operations a byte, so the
// tensor cores are the limit (989 TFLOP/s bf16; 67 TFLOP/s FFMA for f32).
//
// The design. Every kernel runs the same logits tile: a CTA owns 64 rows of
// one operand ("own") and walks the other ("stream") in tiles of 128 rows;
// the 64 x 128 tile O . S^T is summed over D in steps of 128 bytes of each
// row, the operand tiles brought into shared memory by cp.async in a
// three-stage ring, one barrier a step; 8 warps in a 4 x 2 grid each own a
// 16 x 64 block in the m16n8 accumulator layout (bf16: mma.sync m16n8k16
// with f32 accumulators, fragments through ldmatrix from rows padded
// against bank conflicts; f32: the same layout on FFMA, flash_tiles.cuh).
//   * K8 owns x rows and streams W: an online max and sum per row, the
//     target logit picked by its column, combined across the two warp
//     columns through a few floats of shared memory; one pass over W.
//   * K9 owns x rows and streams W; K10 owns W rows and streams x. Both
//     then need, for each own row, a D-wide f32 accumulator of sum over
//     stream rows of cast(p g) times that stream row: dx_i or dW_j. That is
//     the hard part: 64 rows x D = 1536 is 384 KB, more than the registers
//     and shared memory of an SM. Each CTA therefore holds the accumulator
//     of a slice of at most 512 columns of D in registers (128 floats a
//     thread), and grid.y runs ceil(D / 512) slices. The slices of one own
//     block run as a thread block cluster (Hopper) and share the logits:
//     each computes one stream tile's logits and cast(p g) in turn, and
//     each reads the others' from their shared memory (distributed shared
//     memory), so the logits are computed once, 4 N V D in all, not once
//     per slice ((slices + 1) 2 N V D, 2x at D 1536, which is what a
//     launch with more slices than a portable cluster holds still pays).
//     The tile's cast(p g) goes through shared memory anyway, since the
//     second product needs all 128 stream columns of a row in the warp
//     that owns the row's accumulator; the stream rows' d-slice comes in
//     chunks of 128 bytes of each row, through a ring like the logits
//     operands'. K9 and K10 are one template: only which operand is owned,
//     and which side the per-row lse, g and target belong to, differ.
//   * A CTA owns its output rows and sums its stream tiles in order: dx and
//     dW are deterministic, with no atomics and no second pass.
//   * Ragged N, V and D are masked in the loads (cp.async zero-fills a
//     chunk past the edge where D is a multiple of a chunk and the bases
//     are aligned; element loads otherwise); no divisibility rule.
// bf16 K8 with D a multiple of 8, and bf16 K9 and K10 with D a multiple
// of 8 and at most 1536, run the Hopper kernels of cross_entropy_sm90.cu
// instead (wgmma, TMA, thread block clusters; ops/cross_entropy.py::
// ce_fwd_route, ce_grad_route); this template serves f32 K8-K10 and bf16
// at other D.
// Not done yet: a persistent schedule.

#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
typedef long long ll;
typedef __nv_bfloat16 bf16;

constexpr int kCeWarps = 8, kCeThreads = kCeWarps * 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kBO = 64;             // own rows a CTA: 16 a warp row
constexpr int kBS = 128;            // stream rows a tile: 64 a warp column
constexpr int kNT1 = kBS / 2 / 8;   // n8 tiles of a warp's logits block
constexpr int kStages = 3;          // cp.async ring depth

// Per dtype: E elements in 16 bytes; W = 8E elements (128 bytes) of a row a
// stage, both the logits' k step and a gradient chunk (each warp column
// taking half of the chunk); LD the padded row of a staged tile; NC chunks
// a CTA's slice at most, so that the accumulator is 128 floats a thread (a
// 512-column slice for both types).
template <typename T>
struct Ce {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int W = 8 * E;
  static constexpr int LD = W + Ty<T>::kPad;
  static constexpr int LDP = kBS + Ty<T>::kPad;
  static constexpr int NT2 = W / 2 / 8;
  static constexpr int NC = 128 / (NT2 * 4);
};

template <typename T>
struct alignas(16) Vec {
  T v[Ce<T>::E];
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A row-major (rows, D) operand, read in 16-byte chunks along D; entries
// outside it read as 0.
template <typename T>
struct Rows {
  const T* p;
  int rows, D;
  bool vec;  // D a multiple of E and the base 16-byte aligned

  // NR rows from row0, W columns from k0, into a staged tile (row stride
  // LD): cp.async where vec (a chunk past an edge zero-filled), element
  // loads and a 16-byte store otherwise
  template <int NR>
  __device__ __forceinline__ void stage(T* dst, int row0, int k0) const {
    constexpr int E = Ce<T>::E, CPR = Ce<T>::W / E, LD = Ce<T>::LD;
#pragma unroll
    for (int s = 0; s < NR * CPR / kCeThreads; ++s) {
      const int idx = threadIdx.x + s * kCeThreads;
      const int r = idx / CPR, kc = (idx % CPR) * E;
      const int row = row0 + r, k = k0 + kc;
      T* d = dst + r * LD + kc;
      if (vec) {
        const bool in = row < rows && k < D;
        cp_async16(d, in ? p + (ll)row * D + k : p, in);
      } else {
        Vec<T> c;
#pragma unroll
        for (int i = 0; i < E; ++i)
          c.v[i] = row < rows && k + i < D ? p[(ll)row * D + k + i] : T(0.f);
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(c.v);
      }
    }
  }
};

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; with kTrans each is transposed on the way.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// One warp: acc (16 x 8 NT, m16n8 accumulator layout) += A (16 x K) . B,
// A row-major A[m * lda + k]; B either n-major B[n * ldb + k] (kKN false:
// the logits, both operands rows along D) or k-major B[k * ldb + n] (kKN
// true: the stream rows' d-chunk). bf16 comes out of shared memory through
// ldmatrix (.trans for the k-major B), two n8 tiles an instruction; f32
// runs flash_tiles' FFMA warp GEMM in the same layout.
template <typename T, int NT, int K, bool kKN>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const T* A,
                                     int lda, const T* B, int ldb, int lane) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NT % 2 == 0 && K % 16 == 0, "whole ldmatrix tiles");
    const int l8 = lane % 8, hi = (lane / 8) % 2, q = lane / 16;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4<false>(a, A + (lane % 16) * lda + k0 + q * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        if (kKN)
          ldsm_x4<true>(r, B + (k0 + l8 + hi * 8) * ldb + np * 16 + q * 8);
        else
          ldsm_x4<false>(r, B + (np * 16 + l8 + q * 8) * ldb + k0 + hi * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[2 * np], a, b0);
        mma_bf16(acc[2 * np + 1], a, b1);
      }
    }
  } else {
    warp_gemm<T, NT, K, false, kKN>(acc, A, lda, B, ldb, lane);
  }
}

// Shared memory of the logits tile: a kStages ring of (64 + 128) x LD.
template <typename T>
constexpr size_t logits_smem() {
  return (size_t)kStages * (kBO + kBS) * Ce<T>::LD * sizeof(T);
}

// s (the warp's 16 x 64 block of the tile, m16n8 accumulator layout) =
// O[o0 .. o0 + 63] . S[s0 .. s0 + 127]^T over all of D; ring holds the
// kStages stages of both operands. Starts and ends with a barrier, so the
// ring is free before and after.
template <typename T>
__device__ void logits_tile(float (&s)[kNT1][4], const Rows<T>& O,
                            const Rows<T>& S, int o0, int s0, T* ring) {
  constexpr int W = Ce<T>::W, LD = Ce<T>::LD;
  constexpr int kStage = (kBO + kBS) * LD;     // elements of one stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  zero(s);
  const int nk = (O.D + W - 1) / W;
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      O.template stage<kBO>(ring + st * kStage, o0, st * W);
      S.template stage<kBS>(ring + st * kStage + kBO * LD, s0, st * W);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step kt landed everywhere; step kt - 1's slot free
    const int next = kt + kStages - 1;
    if (next < nk) {
      T* st = ring + (next % kStages) * kStage;
      O.template stage<kBO>(st, o0, next * W);
      S.template stage<kBS>(st + kBO * LD, s0, next * W);
    }
    cp_commit();
    const T* cur = ring + (kt % kStages) * kStage;
    gemm<T, kNT1, W, false>(s, cur + wm * 16 * LD, LD,
                            cur + (kBO + wn * 64) * LD, LD, lane);
  }
  cp_wait<0>();
  __syncthreads();
}

// ----------------------------------------------------------------- K8
// grid ceil(N / 64); warp (wm, wn) holds rows 16 wm + {r, r + 8} of the
// CTA's 64 and vocabulary columns 64 wn .. 64 wn + 63 of each tile.
template <typename T>
__global__ void __launch_bounds__(kCeThreads)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ tgt, float* __restrict__ loss,
                  float* __restrict__ lse, int N, int V, int D, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  __shared__ float red[3][2][kBO];  // tile max, tile sum, target logit
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int i0 = blockIdx.x * kBO;
  const Rows<T> X{x, N, D, vec != 0}, Wt{w, V, D, vec != 0};
  int rl[2], t[2];
  float m[2], l[2], tl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = wm * 16 + r + 8 * h;
    t[h] = i0 + rl[h] < N ? tgt[i0 + rl[h]] : -1;
    m[h] = kNegInf;
    l[h] = 0.f;
    tl[h] = 0.f;
  }
  for (int j0 = 0; j0 < V; j0 += kBS) {
    float s[kNT1][4];
    logits_tile(s, X, Wt, i0, j0, ring);
    float mx[2] = {kNegInf, kNegInf}, hit[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT1; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + wn * 64 + nt * 8 + c + (e & 1), h = e >> 1;
        if (col >= V) s[nt][e] = kNegInf;
        else if (col == t[h]) hit[h] += s[nt][e];
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      hit[h] = quad_sum(hit[h]);
      if ((lane & 3) == 0) {
        red[0][wn][rl[h]] = mx[h];
        red[2][wn][rl[h]] = hit[h];
      }
    }
    __syncthreads();
    float tmax[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tmax[h] = fmaxf(red[0][0][rl[h]], red[0][1][rl[h]]);
#pragma unroll
    for (int nt = 0; nt < kNT1; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[nt][e] - tmax[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = quad_sum(sum[h]);
      if ((lane & 3) == 0) red[1][wn][rl[h]] = sum[h];
    }
    __syncthreads();
    // every thread of a row carries the same running max, sum and target
    // logit; the next tile writes `red` only after logits_tile's barriers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], tmax[h]);
      l[h] = l[h] * expf(m[h] - m_new) +
             (red[1][0][rl[h]] + red[1][1][rl[h]]) * expf(tmax[h] - m_new);
      m[h] = m_new;
      tl[h] += red[2][0][rl[h]] + red[2][1][rl[h]];
    }
  }
  if (wn == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + rl[h];
      if (row >= N) continue;
      const float v = m[h] + logf(l[h]);
      lse[row] = v;
      loss[row] = v - tl[h];
    }
  }
}

// ------------------------------------------------------------ K9, K10
// kDx: K9, own = x rows, stream = W rows (vocabulary). Otherwise K10, own
// = W rows, stream = x rows. grid (ceil(own / 64), slices of D); the slice
// blockIdx.y holds chunks [y nc, y nc + nc) of W columns of D. Warp (wm,
// wn) holds own rows 16 wm + {r, r + 8} and, of every chunk, columns
// wn W / 2 .. (wn + 1) W / 2 - 1.
//
// With cs > 1 the kernel is launched in clusters of cs = grid.y CTAs, the
// slices of one own block, and they share the logits: at each step the
// cluster takes cs stream tiles, CTA rank u computes the logits and
// cast(p g) of the u-th into its Ps, and after a cluster barrier every CTA
// runs its slice's second product over all cs tiles in order, copying the
// others' Ps out of their shared memory (ldmatrix reads only its own CTA's).
// The logits are then computed once, 2 N V D in all. With cs = 1 (no
// cluster; more slices than a portable cluster holds) each CTA computes
// every tile itself.
template <typename T>
constexpr size_t grad_smem() {
  return logits_smem<T>() + ((size_t)kStages * kBS * Ce<T>::LD +
                             2 * kBO * Ce<T>::LDP) * sizeof(T);
}

template <typename T, bool kDx>
__global__ void __launch_bounds__(kCeThreads, 1)
    ce_grad_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ tgt,
                   const float* __restrict__ lse,
                   const float* __restrict__ g, T* __restrict__ out, int N,
                   int V, int D, int nc, int cs, int vec) {
  typedef Ce<T> C;
  constexpr int W = C::W, LD = C::LD, LDP = C::LDP, NT2 = C::NT2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* Ds = ring + kStages * (kBO + kBS) * LD;
  T* Ps = Ds + kStages * kBS * LD;   // this CTA's tile
  T* Pl = Ps + kBO * LDP;            // another CTA's, copied here
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cs > 1 ? (int)cluster.block_rank() : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int n_own = kDx ? N : V, n_str = kDx ? V : N;
  const Rows<T> O{kDx ? x : w, n_own, D, vec != 0};
  const Rows<T> S{kDx ? w : x, n_str, D, vec != 0};
  const int o0 = blockIdx.x * kBO;
  const int d0 = blockIdx.y * nc * W;
  const int nch = min(nc, (D - d0 + W - 1) / W);

  // K9: the row statistics belong to the own rows
  int ol[2], t_o[2];
  float lse_o[2], g_o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ol[h] = wm * 16 + r + 8 * h;
    const int i = o0 + ol[h];
    const bool ok = kDx && i < N;
    t_o[h] = ok ? tgt[i] : -1;
    lse_o[h] = ok ? lse[i] : 0.f;
    g_o[h] = ok ? g[i] : 0.f;
  }

  float acc[C::NC][NT2][4];
#pragma unroll
  for (int q = 0; q < C::NC; ++q) zero(acc[q]);

  const int ntiles = (n_str + kBS - 1) / kBS;
  for (int t0 = 0; t0 < ntiles; t0 += cs) {
    if (t0 + rank < ntiles) {
      const int s0 = (t0 + rank) * kBS;
      float s[kNT1][4];
      logits_tile(s, O, S, o0, s0, ring);
      // cast(p g) of the tile into Ps (own row, stream column)
#pragma unroll
      for (int nt = 0; nt < kNT1; ++nt) {
        const int sl = wn * 64 + nt * 8 + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int st = s0 + sl + e;    // stream index
            float v = 0.f;
            if (st < n_str) {
              if (kDx) {
                v = (expf(s[nt][2 * h + e] - lse_o[h]) -
                     (st == t_o[h] ? 1.f : 0.f)) * g_o[h];
              } else {
                const int j = o0 + ol[h];   // vocabulary index
                v = (expf(s[nt][2 * h + e] - __ldg(lse + st)) -
                     (__ldg(tgt + st) == j ? 1.f : 0.f)) * __ldg(g + st);
              }
            }
            pv[e] = v;
          }
          T* dst = Ps + ol[h] * LDP + sl;
          dst[0] = Ty<T>::from(pv[0]);
          dst[1] = Ty<T>::from(pv[1]);
        }
      }
    }
    if (cs > 1) cluster.sync();   // every CTA's Ps of this step complete
    for (int u = 0; u < cs && t0 + u < ntiles; ++u) {
      const int s0 = (t0 + u) * kBS;
      // the first gradient chunks start on their way
#pragma unroll
      for (int q = 0; q < kStages - 1; ++q) {
        if (q < nch)
          S.template stage<kBS>(Ds + q * kBS * LD, s0, d0 + q * W);
        cp_commit();
      }
      const T* P = Ps;
      if (u != rank) {
        const uint4* src =
            reinterpret_cast<const uint4*>(cluster.map_shared_rank(Ps, u));
        for (int i = threadIdx.x; i < kBO * LDP * (int)sizeof(T) / 16;
             i += kCeThreads)
          reinterpret_cast<uint4*>(Pl)[i] = src[i];
        P = Pl;
      }
      // acc[q] += P (64 x 128) . chunk q of the stream rows (128 x W)
#pragma unroll
      for (int q = 0; q < C::NC; ++q) {
        if (q < nch) {
          cp_wait<kStages - 2>();
          __syncthreads();  // chunk q and P visible; chunk q - 1's slot free
          const int next = q + kStages - 1;
          if (next < nch)
            S.template stage<kBS>(Ds + (next % kStages) * kBS * LD, s0,
                                  d0 + next * W);
          cp_commit();
          gemm<T, NT2, kBS, true>(acc[q], P + wm * 16 * LDP, LDP,
                                  Ds + (q % kStages) * kBS * LD + wn * (W / 2),
                                  LD, lane);
        }
      }
      __syncthreads();  // Pl and the chunk ring free for the next tile
    }
    if (cs > 1) cluster.sync();   // no CTA still reads a Ps of this step
  }

#pragma unroll
  for (int q = 0; q < C::NC; ++q) {
    if (q >= nch) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = o0 + ol[h];
      if (row >= n_own) continue;
      T* orow = out + (ll)row * D;
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = d0 + q * W + wn * (W / 2) + nt * 8 + c + e;
          if (col < D) orow[col] = Ty<T>::from(acc[q][nt][2 * h + e]);
        }
    }
  }
}

// cp.async needs D a multiple of a chunk and aligned bases
template <typename T>
int vec_ok(const void* x, const void* w, int D) {
  return D % Ce<T>::E == 0 && aligned16(x) && aligned16(w);
}

// above 48 KB a kernel's dynamic shared memory must be allowed explicitly
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const int* tgt, float* loss,
                float* lse, int N, int V, int D, cudaStream_t s) {
  constexpr size_t smem = logits_smem<T>();
  cudaError_t err = allow_smem(ce_fwd_kernel<T>, smem);
  if (err) return err;
  const int blocks = (N + kBO - 1) / kBO;
  ce_fwd_kernel<T><<<blocks, kCeThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), tgt, loss, lse, N,
      V, D, vec_ok<T>(x, w, D));
  return cudaGetLastError();
}

template <typename T, bool kDx>
cudaError_t grad(const void* x, const void* w, const int* tgt,
                 const float* lse, const float* g, void* out, int N, int V,
                 int D, cudaStream_t s) {
  constexpr size_t smem = grad_smem<T>();
  cudaError_t err = allow_smem(ce_grad_kernel<T, kDx>, smem);
  if (err) return err;
  // the fewest slices of at most NC chunks, balanced
  const int chunks = (D + Ce<T>::W - 1) / Ce<T>::W;
  const int slices = (chunks + Ce<T>::NC - 1) / Ce<T>::NC;
  const int nc = (chunks + slices - 1) / slices;
  const dim3 grid(((kDx ? N : V) + kBO - 1) / kBO, (chunks + nc - 1) / nc);
  // the slices of an own block share their logits as one cluster, up to
  // the portable cluster size
  const int cs = grid.y <= kMaxCluster ? (int)grid.y : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kCeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_grad_kernel<T, kDx>,
                           static_cast<const T*>(x), static_cast<const T*>(w),
                           tgt, lse, g, static_cast<T*>(out), N, V, D, nc, cs,
                           vec_ok<T>(x, w, D));
  if (err) return err;
  return cudaGetLastError();
}

bool shape_ok(int N, int V, int D) { return N > 0 && V > 0 && D > 0; }

}  // namespace

// dtype 0: f32, 1: bf16 (x and w alike). x (N, D), w (V, D), tgt (N,)
// int32, all contiguous. K8: loss and lse (N,) f32.
extern "C" int nk_ce_fwd(int dtype, const void* x, const void* w,
                         const int* tgt, float* loss, float* lse, int N,
                         int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, tgt, loss, lse, N, V, D, s);
  if (dtype == 1) return fwd<bf16>(x, w, tgt, loss, lse, N, V, D, s);
  return cudaErrorInvalidValue;
}

// K9: dx (N, D) in x's dtype from lse and the row weights g (N,) f32.
extern "C" int nk_ce_dx(int dtype, const void* x, const void* w,
                        const int* tgt, const float* lse, const float* g,
                        void* dx, int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return grad<float, true>(x, w, tgt, lse, g, dx, N, V, D, s);
  if (dtype == 1) return grad<bf16, true>(x, w, tgt, lse, g, dx, N, V, D, s);
  return cudaErrorInvalidValue;
}

// K10: dW (V, D) in w's dtype.
extern "C" int nk_ce_dw(int dtype, const void* x, const void* w,
                        const int* tgt, const float* lse, const float* g,
                        void* dw, int N, int V, int D, void* stream) {
  if (!shape_ok(N, V, D)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grad<float, false>(x, w, tgt, lse, g, dw, N, V, D, s);
  if (dtype == 1)
    return grad<bf16, false>(x, w, tgt, lse, g, dw, N, V, D, s);
  return cudaErrorInvalidValue;
}
