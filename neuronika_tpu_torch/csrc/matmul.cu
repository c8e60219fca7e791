// C = A . B on Hopper, f32 accumulation, C in the operands' dtype.
//
// Replaces K3, neuronika_tpu/ops/pallas/matmul.py::_matmul_kernel: a tiled
// GEMM with an f32 accumulator whose TPU wrapper zero-pads ragged shapes to
// its (8, 128) tiles. Here the kernel takes each operand with a row and a
// column stride, so the transposed views that the VJPs hand it (g . B^T,
// A^T . g) need no copy, and it masks the ragged edge itself: no padding.
//
//   A (M, K): element (m, k) at A[m * sam + k * sak]
//   B (K, N): element (k, n) at B[k * sbk + n * sbn]
//   C (M, N): row-major, contiguous
//
// One CTA computes a 128 x 128 tile of C and walks K in steps of BK. Each
// operand tile is loaded in chunks along whichever of its axes has stride 1
// (16-byte vector loads where the address allows, scalar loads otherwise)
// and stored to shared memory in the layout the inner product reads; the
// next tile is fetched into registers while the current one is multiplied,
// into the other of two shared-memory buffers, so one barrier per step.
//
// What bounds it on the H100:
//   * f32: the products run as FFMA on the CUDA cores, not TF32 on the
//     tensor cores, which would lose the 1e-5 agreement with the plain
//     version; the bound is then 67 TFLOP/s of f32 FMA. 256 threads each
//     hold an 8 x 8 block of C in registers (rows ty*4 + {0..3, 64..67},
//     columns tx*4 + {0..3, 64..67}) and read A and B from shared memory
//     as float4, so each pair of loads feeds 64 FMAs.
//   * bf16: mma.sync m16n8k16 with f32 accumulators (989 TFLOP/s dense
//     bound, far from reached by this simple kernel): 8 warps in a 2 x 4
//     grid, each owning 64 x 32 of the tile, fragments read from shared
//     memory as 32-bit pairs along K (rows padded by 8 elements, so the
//     eight rows a fragment load touches fall in distinct banks).
// Not done yet: wgmma, TMA, ldmatrix, split-K for small M N, a persistent
// schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kThreads = 256;
typedef long long ll;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// n contiguous-or-strided elements p[i * fs], i < n (n <= E), into v; the
// rest read as 0. One 16-byte load when the whole chunk is in range,
// contiguous and aligned.
template <typename T, int E>
__device__ __forceinline__ void load_chunk(T (&v)[E], const T* p, ll fs,
                                           int n, bool vec) {
  if (vec && n == E) {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = i < n ? p[i * fs] : T(0.f);
}

// Which axis of an operand tile is loaded in chunks: the one with stride 1
// (the other when neither is). `fast_row` says whether it is the tile's
// row axis (m for A, n for B) rather than k.
struct Chunking {
  bool fast_row;
  bool vec;   // 16-byte loads allowed: base aligned, slow stride a multiple
};

template <typename T>
__device__ __forceinline__ Chunking chunking(const T* base, ll s_row, ll s_k) {
  constexpr int E = 16 / sizeof(T);
  Chunking c;
  c.fast_row = s_k != 1 && s_row == 1;
  const ll slow = c.fast_row ? s_k : s_row;
  c.vec = (c.fast_row ? s_row : s_k) == 1 && aligned16(base) && slow % E == 0;
  return c;
}

// ------------------------------------------------------------------ f32
constexpr int kBK32 = 8;
constexpr int kLD32 = kBM + 4;  // k-major rows of 128 floats, padded

// Load the (128 rows x 8 k) tile of an operand at (row0, k0) into
// registers: 256 chunks of 4, one per thread. Returns them with the
// chunk's origin so `store32` can place them.
struct Tile32 {
  alignas(16) float v[4];
  int row, k;   // origin of the chunk within the tile
};

__device__ __forceinline__ Tile32 load32(const float* X, ll s_row, ll s_k,
                                         int nrow, int K, int row0, int k0,
                                         Chunking ch) {
  Tile32 t;
  const int tid = threadIdx.x;
  if (ch.fast_row) {          // 32 chunks of 4 rows for each of 8 k
    t.row = (tid % 32) * 4;
    t.k = tid / 32;
  } else {                    // 2 chunks of 4 k for each of 128 rows
    t.row = tid / 2;
    t.k = (tid % 2) * 4;
  }
  const int gr = row0 + t.row, gk = k0 + t.k;
  const ll fs = ch.fast_row ? s_row : s_k;
  int n = 0;
  if (ch.fast_row)
    n = gk < K ? min(4, nrow - gr) : 0;
  else
    n = gr < nrow ? min(4, K - gk) : 0;
  n = max(n, 0);
  load_chunk<float, 4>(t.v, X + (ll)gr * s_row + (ll)gk * s_k, fs, n,
                       ch.vec);
  return t;
}

// Store into the k-major shared tile S[k][row].
__device__ __forceinline__ void store32(float* S, const Tile32& t,
                                        bool fast_row) {
  if (fast_row) {
    *reinterpret_cast<float4*>(S + t.k * kLD32 + t.row) =
        make_float4(t.v[0], t.v[1], t.v[2], t.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) S[(t.k + i) * kLD32 + t.row] = t.v[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int M, int N, int K, ll sam, ll sak,
                 ll sbk, ll sbn) {
  __shared__ __align__(16) float As[2][kBK32 * kLD32];
  __shared__ __align__(16) float Bs[2][kBK32 * kLD32];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const Chunking ca = chunking(A, sam, sak), cb = chunking(B, sbn, sbk);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + kBK32 - 1) / kBK32;
  Tile32 ta, tb;
  if (nk > 0) {
    ta = load32(A, sam, sak, M, K, m0, 0, ca);
    tb = load32(B, sbn, sbk, N, K, n0, 0, cb);
    store32(As[0], ta, ca.fast_row);
    store32(Bs[0], tb, cb.fast_row);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ta = load32(A, sam, sak, M, K, m0, (kt + 1) * kBK32, ca);
      tb = load32(B, sbn, sbk, N, K, n0, (kt + 1) * kBK32, cb);
    }
    const float* as = As[buf];
    const float* bs = Bs[buf];
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLD32 + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * kLD32 + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kLD32 + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * kLD32 + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store32(As[buf ^ 1], ta, ca.fast_row);
      store32(Bs[buf ^ 1], tb, cb.fast_row);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 4 + (i % 4) + (i / 4) * 64;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 4 + (j % 4) + (j / 4) * 64;
      if (col < N) C[(ll)row * N + col] = acc[i][j];
    }
  }
}

// ----------------------------------------------------------------- bf16
typedef __nv_bfloat16 bf16;
constexpr int kBK16 = 32;
constexpr int kLD16 = kBK16 + 8;  // row-major [row][k], padded

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The (128 rows x 32 k) tile of an operand: 512 chunks of 8, two a thread.
struct Tile16 {
  alignas(16) bf16 v[2][8];
  int row[2], k[2];
};

__device__ __forceinline__ Tile16 load16(const bf16* X, ll s_row, ll s_k,
                                         int nrow, int K, int row0, int k0,
                                         Chunking ch) {
  Tile16 t;
  const ll fs = ch.fast_row ? s_row : s_k;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = threadIdx.x + e * kThreads;
    if (ch.fast_row) {        // 16 chunks of 8 rows for each of 32 k
      t.row[e] = (c % 16) * 8;
      t.k[e] = c / 16;
    } else {                  // 4 chunks of 8 k for each of 128 rows
      t.row[e] = c / 4;
      t.k[e] = (c % 4) * 8;
    }
    const int gr = row0 + t.row[e], gk = k0 + t.k[e];
    int n;
    if (ch.fast_row)
      n = gk < K ? min(8, nrow - gr) : 0;
    else
      n = gr < nrow ? min(8, K - gk) : 0;
    n = max(n, 0);
    load_chunk<bf16, 8>(t.v[e], X + (ll)gr * s_row + (ll)gk * s_k, fs, n,
                        ch.vec);
  }
  return t;
}

// Store into the row-major shared tile S[row][k].
__device__ __forceinline__ void store16(bf16* S, const Tile16& t,
                                        bool fast_row) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (fast_row) {
#pragma unroll
      for (int i = 0; i < 8; ++i) S[(t.row[e] + i) * kLD16 + t.k[e]] = t.v[e][i];
    } else {
      *reinterpret_cast<uint4*>(S + t.row[e] * kLD16 + t.k[e]) =
          *reinterpret_cast<const uint4*>(t.v[e]);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
    hgemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 bf16* __restrict__ C, int M, int N, int K, ll sam, ll sak,
                 ll sbk, ll sbn) {
  __shared__ __align__(16) bf16 As[2][kBM * kLD16];
  __shared__ __align__(16) bf16 Bs[2][kBN * kLD16];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const Chunking ca = chunking(A, sam, sak), cb = chunking(B, sbn, sbk);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + kBK16 - 1) / kBK16;
  Tile16 ta, tb;
  if (nk > 0) {
    ta = load16(A, sam, sak, M, K, m0, 0, ca);
    tb = load16(B, sbn, sbk, N, K, n0, 0, cb);
    store16(As[0], ta, ca.fast_row);
    store16(Bs[0], tb, cb.fast_row);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ta = load16(A, sam, sak, M, K, m0, (kt + 1) * kBK16, ca);
      tb = load16(B, sbn, sbk, N, K, n0, (kt + 1) * kBK16, cb);
    }
    const bf16* as = As[buf] + wm * kLD16;
    const bf16* bs = Bs[buf] + wn * kLD16;
#pragma unroll
    for (int k0 = 0; k0 < kBK16; k0 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* p = bs + (nt * 8 + r) * kLD16 + k0 + c;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p = as + (mt * 16 + r) * kLD16 + k0 + c;
        const uint32_t a[4] = {ld32(p), ld32(p + 8 * kLD16), ld32(p + 8),
                               ld32(p + 8 * kLD16 + 8)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
    if (more) {
      store16(As[buf ^ 1], ta, ca.fast_row);
      store16(Bs[buf ^ 1], tb, cb.fast_row);
    }
    __syncthreads();
  }
  // accumulator layout: acc[mt][nt][e] is row mt*16 + r + 8 (e / 2),
  // column nt*8 + c + e % 2 of the warp's 64 x 32 block
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + wm + mt * 16 + r + 8 * e2;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + nt * 8 + c + e;
          if (col < N)
            C[(ll)row * N + col] = __float2bfloat16(acc[mt][nt][e2 * 2 + e]);
        }
    }
}

}  // namespace

// dtype 0: f32, 1: bf16. C (M, N) contiguous; A, B strided (in elements).
extern "C" int nk_matmul(int dtype, const void* a, const void* b, void* c,
                         int M, int N, int K, ll sam, ll sak, ll sbk, ll sbn,
                         void* stream) {
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sgemm_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K, sam, sak, sbk, sbn);
  else if (dtype == 1)
    hgemm_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<bf16*>(c), M, N, K, sam, sak, sbk, sbn);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
