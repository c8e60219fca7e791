// Flash attention on the packed qkv projection, forward and backward, on
// Hopper.
//
// Replaces four TPU kernels of neuronika_tpu/ops/pallas/attention.py:
//   K1  _fwd_kernel_qkv                 -> flash_fwd_kernel
//   K2a _bwd_dq_kernel_qkv              -> flash_bwd_dq_kernel
//   K2b _bwd_dkv_kernel_qkv             -> flash_bwd_kv_kernel<FUSED=false>
//   K2c _bwd_fused_kernel_qkv and
//   K2d _bwd_fused_kernel_qkv_blocked   -> flash_bwd_kv_kernel<FUSED=true>
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
// backward recomputes p = exp2(s - lse), with delta = rowsum(dO . O) taken
// in-kernel, ds = p (dp - delta) scale, as the TPU kernels do.
//
// What bounds it: at hd 128 and S 2048 attention does about 2 S hd flops
// for every byte of q, k, v it reads, far above the card's ~295 flop/byte,
// so the tensor cores and the softmax's exp2/FMA work are the limit, not
// device memory. The design keeps every S x S quantity on chip:
//   * a CTA holds a 64-row q tile (forward, dq) or a 64-row k/v tile
//     (dk/dv, fused) in shared memory and walks the other side tile by
//     tile, only up to (or from) the causal edge; the ragged edge of S is
//     masked here, no S % block rule;
//   * every product runs on the tensor cores as mma.sync m16n8k16 with bf16
//     operands and f32 accumulation; each warp owns 16 rows and keeps its
//     scores and accumulators in registers in the mma's own layout, so the
//     row max and sum are quad shuffles;
//   * a product whose left operand is a score tile (P V, P^T dO, dS^T Q,
//     dS K) takes it from a warp-private shared-memory tile, rounded to
//     bf16 as the TPU kernel rounds it;
//   * the f32 instantiation runs the same tiles with FFMA (not TF32), so it
//     agrees with the plain PyTorch version to 1e-5.
// The fused backward walks each (batch, kv group, k tile) once for all G
// members, with 5 products per tile (s, dp, dv, dk, dq). dq of one q row
// gets a term from every k tile, which other CTAs hold, so it is summed
// with f32 atomics into a scratch buffer and cast into dqkv by a second
// small kernel: its summation order, and so its last bits, change from run
// to run (the split pair K2a + K2b is deterministic).
// Not done yet: wgmma, TMA, warp specialisation, ldmatrix, a persistent
// schedule that balances the causal triangle, and in-kernel dropout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;   // forward and dq: q rows per CTA (16 per warp)
constexpr int kBK = 64;   // k rows per tile (dk/dv: per CTA, 16 per warp)
constexpr int kBQb = 32;  // dk/dv and fused: q rows per inner tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Ty;

template <>
struct Ty<float> {
  static constexpr int kPad = 4;  // row padding (elements) against bank conflicts
  __device__ static float f(float v) { return v; }
  __device__ static float from(float v) { return v; }
};

template <>
struct Ty<__nv_bfloat16> {
  static constexpr int kPad = 8;
  __device__ static float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc (16 x 8 NT, in the m16n8 accumulator layout) += A (16 x K)
// . B (K x 8 NT), both operands in shared memory.
//   A: A_KM ? A[k * lda + m] : A[m * lda + k]
//   B: B_KN ? B[k * ldb + n] : B[n * ldb + k]
// Accumulator layout: with r = lane / 4 and c = 2 (lane % 4), acc[nt][e]
// is row r + 8 (e / 2), column 8 nt + c + e % 2.
template <typename T, int NT, int K, bool A_KM, bool B_KN>
struct WarpGemm;

template <int NT, int K, bool A_KM, bool B_KN>
struct WarpGemm<__nv_bfloat16, NT, K, A_KM, B_KN> {
  using T = __nv_bfloat16;
  __device__ static uint32_t pa(const T* A, int lda, int m, int k) {
    if (A_KM) return pack2(A[k * lda + m], A[(k + 1) * lda + m]);
    return *reinterpret_cast<const uint32_t*>(A + m * lda + k);
  }
  __device__ static uint32_t pb(const T* B, int ldb, int n, int k) {
    if (B_KN) return pack2(B[k * ldb + n], B[(k + 1) * ldb + n]);
    return *reinterpret_cast<const uint32_t*>(B + n * ldb + k);
  }
  __device__ static void run(float (&acc)[NT][4], const T* A, int lda,
                             const T* B, int ldb, int lane) {
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      a[0] = pa(A, lda, r, k0 + c);
      a[1] = pa(A, lda, r + 8, k0 + c);
      a[2] = pa(A, lda, r, k0 + c + 8);
      a[3] = pa(A, lda, r + 8, k0 + c + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        b[0] = pb(B, ldb, nt * 8 + r, k0 + c);
        b[1] = pb(B, ldb, nt * 8 + r, k0 + c + 8);
        mma_bf16(acc[nt], a, b);
      }
    }
  }
};

template <int NT, int K, bool A_KM, bool B_KN>
struct WarpGemm<float, NT, K, A_KM, B_KN> {
  __device__ static float ga(const float* A, int lda, int m, int k) {
    return A_KM ? A[k * lda + m] : A[m * lda + k];
  }
  __device__ static float gb(const float* B, int ldb, int n, int k) {
    return B_KN ? B[k * ldb + n] : B[n * ldb + k];
  }
  __device__ static void run(float (&acc)[NT][4], const float* A, int lda,
                             const float* B, int ldb, int lane) {
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = ga(A, lda, r, k), a1 = ga(A, lda, r + 8, k);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = gb(B, ldb, nt * 8 + c, k);
        const float b1 = gb(B, ldb, nt * 8 + c + 1, k);
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
};

template <typename T, int NT, int K, bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* A,
                                          int lda, const T* B, int ldb,
                                          int lane) {
  WarpGemm<T, NT, K, A_KM, B_KN>::run(acc, A, lda, B, ldb, lane);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// rows row0 .. row0 + nrows - 1 of an hd-wide column block (row stride rs
// elements) into shared memory (row stride ld); rows at or past S read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t rs, int row0, int nrows,
                                          int S) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / E;
  for (int idx = threadIdx.x; idx < nrows * VPR; idx += kThreads) {
    const int r = idx / VPR, v = idx % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs +
                                                 v * E));
    *reinterpret_cast<uint4*>(dst + r * ld + v * E) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

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
// grid (ceil(S / kBK), KV, B); warp w owns k rows w*16 .. w*16 + 15 of the
// CTA's k/v tile and, for each of the G q heads of the group, walks the q
// tiles from the causal edge to S (_bwd_dkv_kernel_qkv). FUSED also adds
// each tile's dS K into the f32 dq scratch (_bwd_fused_kernel_qkv and its
// blocked twin), so one walk yields dq, dk and dv.
template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ dq_acc, int S, int H, int G,
                        float scale, float qscale, int causal) {
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

  const int j0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const size_t W = (size_t)(H + 2 * (H / G)) * HD;
  const size_t HHD = (size_t)H * HD;
  const T* base = qkv + (size_t)b * S * W;
  const size_t koff = (size_t)(g * (G + 2) + G) * HD;
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
#pragma unroll
        for (int cc = 0; cc < CW; cc += 32) {
          float part[4][4];
          zero(part);
          warp_gemm<T, 4, kBK, true, true>(part, dSTs + rb * 16, LDP,
                                           Ks + cg * CW + cc, LD, lane);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = i0 + rb * 16 + r + 8 * x;
            if (i >= S) continue;
            float* drow = dq_acc + ((size_t)b * S + i) * HHD +
                          (size_t)h * HD + cg * CW + cc;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              atomicAdd(drow + nt * 8 + c, part[nt][2 * x]);
              atomicAdd(drow + nt * 8 + c + 1, part[nt][2 * x + 1]);
            }
          }
        }
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
  cudaError_t err = allow_smem(flash_bwd_kv_kernel<T, HD, FUSED>, smem);
  if (err) return err;
  const dim3 grid((a.S + kBK - 1) / kBK, a.KV, a.B);
  flash_bwd_kv_kernel<T, HD, FUSED><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dout),
      static_cast<T*>(a.out), a.dq_acc, a.S, a.H, a.H / a.KV, a.scale,
      a.scale * kLog2e, a.causal);
  err = cudaGetLastError();
  if (err || !FUSED) return err;
  const size_t n = (size_t)a.B * a.S * a.H * HD;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dq_store_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.dq_acc, static_cast<T*>(a.out), n, a.H, a.H / a.KV, HD);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv, kFused };

template <typename T, int HD>
cudaError_t dispatch(Which w, const Args& a) {
  switch (w) {
    case kFwd: return fwd<T, HD>(a);
    case kDq: return bwd_dq<T, HD>(a);
    case kDkv: return bwd_kv<T, HD, false>(a);
    case kFused: return bwd_kv<T, HD, true>(a);
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
  Args a{qkv, nullptr, nullptr, nullptr, out, lse, nullptr,
         B, S, H, KV, hd, causal, fast, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kFwd, a);
}

// the q chunks of dqkv (B, S, W)
extern "C" int nk_flash_bwd_dq_qkv(int dtype, const void* qkv, const void* o,
                                   const void* lse, const void* dout,
                                   void* dqkv, int B, int S, int H, int KV,
                                   int hd, float scale, int causal,
                                   void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr,
         B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kDq, a);
}

// the k and v chunks of dqkv (B, S, W)
extern "C" int nk_flash_bwd_dkv_qkv(int dtype, const void* qkv,
                                    const void* o, const void* lse,
                                    const void* dout, void* dqkv, int B,
                                    int S, int H, int KV, int hd, float scale,
                                    int causal, void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, nullptr,
         B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kDkv, a);
}

// all of dqkv (B, S, W); dq_acc is f32 (B, S, H hd) scratch that the caller
// zeroes
extern "C" int nk_flash_bwd_fused_qkv(int dtype, const void* qkv,
                                      const void* o, const void* lse,
                                      const void* dout, void* dq_acc,
                                      void* dqkv, int B, int S, int H, int KV,
                                      int hd, float scale, int causal,
                                      void* stream) {
  Args a{qkv, o, lse, dout, dqkv, nullptr, static_cast<float*>(dq_acc),
         B, S, H, KV, hd, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(dtype, kFused, a);
}
