// Device helpers shared by the flash-attention kernels
// (flash_attention_qkv.cu: K1/K2 on the packed qkv layout;
// flash_attention.cu: K5-K7 on the (B, H, S, hd) layout).
//
// A CTA is kWarps warps; each warp owns 16 rows of a tile and keeps its
// scores and accumulators in registers in the layout of mma.sync m16n8k16.
// bf16 products run on the tensor cores with f32 accumulation; the f32
// instantiation runs the same tiles with FFMA (not TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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
// elements) into an HD-wide tile of shared memory (row stride ld), HD the
// head-dim tier (hd <= HD); rows at or past S and columns at or past hd
// read as 0, so the padded columns add nothing to any product. 16-byte
// loads where every row start is 16-byte aligned (hd and rs multiples of
// the vector, an aligned base), else element loads.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t rs, int row0, int nrows,
                                          int S, int hd) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / E;
  const bool vec = hd % E == 0 && rs % E == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int idx = threadIdx.x; idx < nrows * VPR; idx += kThreads) {
    const int r = idx / VPR, v = idx % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const T* row = src + (size_t)(row0 + r) * rs + v * E;
    if (row0 + r < S && v * E < hd) {
      if (vec) {
        val = __ldg(reinterpret_cast<const uint4*>(row));
      } else {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int x = 0; x < E; ++x)
          if (v * E + x < hd) e[x] = row[x];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + v * E) = val;
  }
}

// the head-dim tier of the CUDA-core flash kernels: the smallest of 32,
// 64, 96, 128 and 256 that holds hd (1 <= hd <= 256), 0 above; the
// kernels are instantiated at the tiers and mask the runtime hd. Built
// with NK_FLASH_TIERS_3, only 64, 128 and 256 (tools/torch_diag.py tiers
// times the two builds against each other)
__host__ __device__ constexpr int hd_tier(int hd) {
#ifdef NK_FLASH_TIERS_3
  return hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 256 ? 256 : 0;
#else
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 96 ? 96 : hd <= 128 ? 128
                                                   : hd <= 256 ? 256 : 0;
#endif
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

}  // namespace
