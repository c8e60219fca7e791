// Flash attention on (B, H, S, hd) q, k, v, forward and backward, on Hopper.
//
// Replaces three TPU kernels of neuronika_tpu/ops/pallas/attention.py:
//   K5 _fwd_kernel      -> split_fwd_kernel
//   K6 _bwd_dq_kernel   -> split_bwd_dq_kernel
//   K7 _bwd_dkv_kernel  -> split_bwd_dkv_kernel
//
// Contract (that of ops/flash_attention.py's flash_fwd, flash_bwd_dq and
// flash_bwd_dkv):
//   q (B, H, Sq, hd), k and v (B, H, Skv, hd), do (B, H, Sq, hd): strided
//        views are read through their (batch, head, row) strides; the last
//        axis has stride 1, and base and strides are 16-byte aligned;
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
// limit. The design keeps every S x S quantity on chip:
//   * a CTA holds a 64-row q tile (K5, K6) or a 64-row k/v tile (K7) in
//     shared memory and walks only the other side's tiles that meet the
//     causal/window band: tiles above the diagonal and tiles wholly below
//     the window are never visited; a tile crossing the diagonal, the
//     window's lower edge or the ragged end of S evaluates the mask
//     rows >= cols && rows - cols < window, interior tiles skip it;
//   * every product runs as mma.sync m16n8k16 (bf16 operands, f32
//     accumulation) from shared memory, each warp owning 16 rows
//     (flash_tiles.cuh); p and ds are rounded to the input dtype before
//     their products, where the TPU kernels round them;
//   * the f32 instantiation runs the same tiles with FFMA.
// Not done yet: wgmma, TMA, warp specialisation, GQA without the repeated
// k/v, and in-kernel dropout.

#include <math.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kBQ = 64;   // K5 and K6: q rows per CTA (16 per warp)
constexpr int kBK = 64;   // k rows per tile (K7: per CTA, 16 per warp)
constexpr int kBQb = 32;  // K7: q rows per inner tile

struct Strides {  // elements between batches, heads and rows
  long long b, h, s;
};

struct Band {
  int Sq, Skv, causal, window;

  // key (row i, col j) is masked out
  __device__ bool masked(int i, int j) const {
    return j >= Skv ||
           (causal && (j > i || (window > 0 && i - j >= window)));
  }
  // the rectangle rows [i0, i0 + ni) x cols [j0, j0 + nj) needs the mask
  __device__ bool edge(int i0, int ni, int j0, int nj) const {
    return j0 + nj > Skv || i0 + ni > Sq ||
           (causal && (j0 + nj - 1 > i0 ||
                       (window > 0 && i0 + ni - 1 - j0 >= window)));
  }
  // k tiles [*kt0, *kt1) of size nj meeting q rows [i0, i0 + ni)
  __device__ void k_tiles(int i0, int ni, int nj, int* kt0, int* kt1) const {
    *kt0 = 0;
    *kt1 = (Skv + nj - 1) / nj;
    if (!causal) return;
    const int last = min(i0 + ni, Sq) - 1;
    *kt1 = min(*kt1, last / nj + 1);
    if (window > 0) *kt0 = max(0, i0 - window + 1) / nj;
  }
  // q tiles [*it0, *it1) of size ni meeting key rows [j0, j0 + nj): from
  // the diagonal to the last row whose window still holds key j0 + nj - 1
  __device__ void q_tiles(int j0, int nj, int ni, int* it0, int* it1) const {
    *it0 = 0;
    *it1 = (Sq + ni - 1) / ni;
    if (!causal) return;
    *it0 = j0 / ni;
    if (window > 0) *it1 = min(*it1, (j0 + nj + window - 2) / ni + 1);
  }
};

// ---------------------------------------------------------------- K5
// grid (ceil(Sq / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    split_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, int H, Band band, float qscale) {
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
  load_tile<T, HD>(Qs, LD, q + b * sq.b + h * sq.h, sq.s, i0, kBQ, band.Sq);

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
    load_tile<T, HD>(Ks, LD, ksrc, sk.s, j0, kBK, band.Skv);
    load_tile<T, HD>(Vs, LD, vsrc, sv.s, j0, kBK, band.Skv);
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
    const float inv = 1.f / l[x];
    const size_t at = ((size_t)b * H + h) * band.Sq + rw;
    T* orow = out + at * HD;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      orow[nt * 8 + c] = Ty<T>::from(acc[nt][2 * x] * inv);
      orow[nt * 8 + c + 1] = Ty<T>::from(acc[nt][2 * x + 1] * inv);
    }
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

// ---------------------------------------------------------------- K6
// grid (ceil(Sq / kBQ), H, B); warp w owns q rows w*16 .. w*16 + 15 and
// walks the k tiles of the band.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    split_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        int H, Band band, float scale, float qscale) {
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
  const T* ksrc = k + b * sk.b + h * sk.h;
  const T* vsrc = v + b * sv.b + h * sv.h;
  const size_t rows = ((size_t)b * H + h) * band.Sq;
  load_tile<T, HD>(Qs, LD, q + b * sq.b + h * sq.h, sq.s, i0, kBQ, band.Sq);
  load_tile<T, HD>(dOs, LD, dout + b * sdo.b + h * sdo.h, sdo.s, i0, kBQ,
                   band.Sq);
  load_rows(lse_s, delta_s, lse, delta, rows, i0, kBQ, band.Sq);

  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* dSw = dSs + warp * 16 * LDP;
  const int lr[2] = {warp * 16 + r, warp * 16 + r + 8};
  float dqa[NTO][4];
  zero(dqa);

  int kt0, kt1;
  band.k_tiles(i0, kBQ, kBK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();  // row stats written; previous K/V tile read
    load_tile<T, HD>(Ks, LD, ksrc, sk.s, j0, kBK, band.Skv);
    load_tile<T, HD>(Vs, LD, vsrc, sv.s, j0, kBK, band.Skv);
    __syncthreads();
    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    warp_gemm<T, NTS, HD, false, false>(s, Qw, LD, Ks, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dp, dOw, LD, Vs, LD, lane);
    const bool edge = band.edge(i0, kBQ, j0, kBK);
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
        const float ds = p * (dp[nt][e] - delta_s[lrow]) * scale;
        dSw[(r + 8 * (e >> 1)) * LDP + nt * 8 + c + (e & 1)] = Ty<T>::from(ds);
      }
    __syncwarp();
    warp_gemm<T, NTO, kBK, false, true>(dqa, dSw, LDP, Ks, LD, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int rw = i0 + lr[x];
    if (rw >= band.Sq) continue;
    T* drow = dq + (rows + rw) * HD;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      drow[nt * 8 + c] = Ty<T>::from(dqa[nt][2 * x]);
      drow[nt * 8 + c + 1] = Ty<T>::from(dqa[nt][2 * x + 1]);
    }
  }
}

// ---------------------------------------------------------------- K7
// grid (ceil(Skv / kBK), H, B); warp w owns key rows w*16 .. w*16 + 15 of
// the CTA's k/v tile and walks the q tiles of the band, from the diagonal
// to the last row whose window holds the tile's last key.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    split_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, int H, Band band,
                         float scale, float qscale) {
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
  load_tile<T, HD>(Ks, LD, k + b * sk.b + h * sk.h, sk.s, j0, kBK, band.Skv);
  load_tile<T, HD>(Vs, LD, v + b * sv.b + h * sv.h, sv.s, j0, kBK, band.Skv);

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
    load_tile<T, HD>(Qs, LD, qsrc, sq.s, i0, kBQb, band.Sq);
    load_tile<T, HD>(dOs, LD, dosrc, sdo.s, i0, kBQb, band.Sq);
    load_rows(lse_s, delta_s, lse, delta, rows, i0, kBQb, band.Sq);
    __syncthreads();
    float sT[NTS][4], dpT[NTS][4];
    zero(sT);
    zero(dpT);
    warp_gemm<T, NTS, HD, false, false>(sT, Kw, LD, Qs, LD, lane);
    warp_gemm<T, NTS, HD, false, false>(dpT, Vw, LD, dOs, LD, lane);
    const bool edge = band.edge(i0, kBQb, j0, kBK);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = nt * 8 + c + (e & 1), i = i0 + li;
        float x = sT[nt][e] * qscale;
        if (edge && (i >= band.Sq || band.masked(i, jr[e >> 1]))) x = kNegInf;
        const float p = exp2f(fminf(x - lse_s[li], 0.f));  // see K6
        const float ds = p * (dpT[nt][e] - delta_s[li]) * scale;
        const int at = (r + 8 * (e >> 1)) * LDP + li;
        PTw[at] = Ty<T>::from(p);
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
    const size_t at = (((size_t)b * H + h) * band.Skv + j) * HD;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      dk[at + nt * 8 + c] = Ty<T>::from(dka[nt][2 * x]);
      dk[at + nt * 8 + c + 1] = Ty<T>::from(dka[nt][2 * x + 1]);
      dv[at + nt * 8 + c] = Ty<T>::from(dva[nt][2 * x]);
      dv[at + nt * 8 + c + 1] = Ty<T>::from(dva[nt][2 * x + 1]);
    }
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
  cudaError_t err = allow_smem(split_fwd_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((a.band.Sq + kBQ - 1) / kBQ, a.H, a.B);
  split_fwd_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse_out, a.sq,
      a.sk, a.sv, a.H, a.band, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dq(const Args& a) {
  const size_t smem = dq_smem<T, HD>();
  cudaError_t err = allow_smem(split_bwd_dq_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((a.band.Sq + kBQ - 1) / kBQ, a.H, a.B);
  split_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.out), a.sq, a.sk, a.sv, a.sdo, a.H, a.band,
      a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dkv(const Args& a) {
  const size_t smem = dkv_smem<T, HD>();
  cudaError_t err = allow_smem(split_bwd_dkv_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((a.band.Skv + kBK - 1) / kBK, a.H, a.B);
  split_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.sv, a.sdo, a.H, a.band, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

template <typename T, int HD>
cudaError_t dispatch(Which w, const Args& a) {
  switch (w) {
    case kFwd: return fwd<T, HD>(a);
    case kDq: return bwd_dq<T, HD>(a);
    case kDkv: return bwd_dkv<T, HD>(a);
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
  const Band& n = a.band;
  if (a.B < 1 || a.H < 1 || n.Sq < 1 || n.Skv < 1 || a.B > 65535 ||
      a.H > 65535 || n.window < 0 || (n.causal && n.Sq != n.Skv) ||
      (n.window && !n.causal))
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_hd<float>(w, a);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(w, a);
  return cudaErrorInvalidValue;
}

Strides strides_of(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16; hd
// 64 or 128. `strides` holds (batch, head, row) strides in elements: q, k, v
// for the forward, then do for the backward. Each returns a cudaError_t: 0
// when the launch was accepted.

// out (B, H, Sq, hd) and lse (B, H, Sq) f32
extern "C" int nk_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, void* out, void* lse,
                            const long long* strides, int B, int H, int Sq,
                            int Skv, int hd, float scale, int causal,
                            int window, void* stream) {
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
  return run(dtype, kFwd, a);
}

// dq (B, H, Sq, hd) from lse and delta (B, H, Sq) f32
extern "C" int nk_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               const long long* strides, int B, int H, int Sq,
                               int Skv, int hd, float scale, int causal,
                               int window, void* stream) {
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
  return run(dtype, kDq, a);
}

// dk and dv (B, H, Skv, hd) from lse and delta (B, H, Sq) f32
extern "C" int nk_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, const long long* strides, int B,
                                int H, int Sq, int Skv, int hd, float scale,
                                int causal, int window, void* stream) {
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
  return run(dtype, kDkv, a);
}
