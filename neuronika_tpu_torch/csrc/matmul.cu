// K3: C = A . B on Hopper, f32 accumulation, C in the operands' dtype.
//
// Replaces neuronika_tpu/ops/pallas/matmul.py::_matmul_kernel: a tiled
// GEMM with an f32 accumulator whose TPU wrapper zero-pads ragged shapes to
// its (8, 128) tiles. Here every edge is masked (TMA reads rows and columns
// past an operand's extent as zeros; the epilogue stores only rows < M,
// columns < N): no padding of C.
//
//   A (M, K): element (m, k) at A[m * sam + k * sak]
//   B (K, N): element (k, n) at B[k * sbk + n * sbn]
//   C (M, N): row-major, contiguous
//
// What bounds it on the H100: the products. At the define-by-run model's
// shapes (M 1024, N and K 128-16384) a product does 2 MNK operations on
// 4 (MK + KN + MN) bytes or fewer, far above the card's ~300 operations a
// byte, so the limit is the rate of f32-accurate multiply-adds: FFMA's 67
// TFLOP/s, or the tensor cores by 3xTF32 (below), 495 / 3 = 165 TFLOP/s.
//
// The design: one warp-specialised kernel for both dtypes (k3_gemm_kernel).
//   * A CTA computes 128 x 128 tiles of C: two consumer warpgroups of 64
//     rows run wgmma (m64n128) into f32 registers; one thread of the
//     producer warpgroup keeps a ring of 3 (f32) or 4 (bf16) stages of TMA
//     loads in flight on mbarriers, 128 bytes of k a stage (32 f32, 64
//     bf16), so loads overlap the products and no __syncthreads sits in the
//     walk; setmaxnreg gives the producer's registers to the consumers.
//   * The grid is persistent (one CTA an SM, work items in a fixed order),
//     and a product whose 128 x 128 tiles do not fill the SMs is split
//     along K (split-K): each split writes its f32 partial sums, and a
//     second small kernel (k3_reduce_kernel) adds them in split order, so
//     the result is the same bits every run.
//   * bf16: one m64n128k16 wgmma a k16 slice, operands K-major in shared
//     memory. An operand TMA can read in place (K-major, 16-byte aligned
//     base and row stride) goes straight to the ring; any other (a
//     transposed view, a ragged row stride) is first copied K-major by
//     k3_pack_kernel, whose time counts in K3's.
//   * f32: 3xTF32. TF32 wgmma reads only K-major operands and ignores the
//     low 13 mantissa bits, so k3_pack_kernel writes each operand K-major
//     as two planes: hi = tf32(x) and lo = tf32(x - hi), both rounded to
//     nearest (cvt.rna). The kernel accumulates a_lo b_hi + a_hi b_lo +
//     a_hi b_hi (m64n128k8 each); a_lo b_lo, ~2^-22 of a term, is dropped.
//     The tensor cores' own f32 accumulation is not IEEE round-to-nearest,
//     and its error grows with the number of wgmmas summed into one
//     accumulator, so each 32-deep k step sums into a fresh register tile
//     that is added to the running sum by FADD (two such tiles alternate,
//     so one k step's adds overlap the next one's wgmmas).
// Not done yet: MN-major bf16 operands read in place (the transpose bits)
// rather than copied; a TMA-store epilogue; stream-K; 2-CTA clusters
// sharing a B tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef long long ll;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128;      // C tile
constexpr int kConsumers = 256;          // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;
// setmaxnreg within the CTA's allotment (384 threads x 168): the producer
// warpgroup gives up 144 a thread to the consumers (128 x 24 + 256 x 240)
constexpr int kRegsProducer = 24, kRegsConsumer = 240;
constexpr uint32_t kTile = 128 * 128;    // bytes of one 128-row plane

template <typename T>
struct Gemm;

template <>
struct Gemm<float> {                     // 3xTF32
  static constexpr int kPlanes = 2;      // hi, lo
  static constexpr int kBK = 32;         // k per stage: one 128-byte row
  static constexpr int kStages = 3;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <>
struct Gemm<bf16> {
  static constexpr int kPlanes = 1;
  static constexpr int kBK = 64;
  static constexpr int kStages = 4;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <typename T>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return 2 * Gemm<T>::kPlanes * kTile;   // A's planes, then B's
}

template <typename T>
__host__ __device__ constexpr size_t gemm_smem() {
  return (size_t)Gemm<T>::kStages * stage_bytes<T>() +
         16 * Gemm<T>::kStages + 1024;
}

// work item -> (tile row, tile column, split); splits slowest, then tile
// columns, so the CTAs of a wave share B tiles in L2
struct Item {
  int m0, n0, k0, k1;   // C tile origin; k steps [k0, k1)
};

__device__ __forceinline__ Item item_at(int item, int tiles_m, int tiles,
                                        int splits, int nk) {
  const int sp = item / tiles, t = item % tiles;
  Item w;
  w.m0 = (t % tiles_m) * kBM;
  w.n0 = (t / tiles_m) * kBN;
  w.k0 = (int)((ll)sp * nk / splits);
  w.k1 = (int)((ll)(sp + 1) * nk / splits);
  return w;
}

template <int N>
__device__ __forceinline__ void add_to(float (&sum)[N], const float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += d[i];
}

// C tile (or, with splits, split sp's f32 partial) from the accumulator:
// acc[4 j + 2 x + e] is row 16 warp + lane / 4 + 8 x of the warpgroup's
// 64, column 8 j + 2 (lane % 4) + e
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[64], T* c,
                                           float* ws, int M, int N,
                                           int row0, int col0, int sp,
                                           int splits) {
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = row0 + 8 * x;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = acc[4 * j + 2 * x], v1 = acc[4 * j + 2 * x + 1];
      if (col >= N) continue;
      const size_t at = (size_t)row * N + col;
      if (splits > 1) {
        float* dst = ws + (size_t)sp * M * N + at;
        if (pair) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      } else if constexpr (sizeof(T) == 4) {
        if (pair) {
          *reinterpret_cast<float2*>(c + at) = make_float2(v0, v1);
        } else {
          c[at] = v0;
          if (col + 1 < N) c[at + 1] = v1;
        }
      } else {
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(c + at) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          c[at] = __float2bfloat16(v0);
          if (col + 1 < N) c[at + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// One k step (128 bytes of k) of the warpgroup's 64 x 128 product from
// stage `st`: 4 k slices, each one bf16 wgmma or three TF32 ones.
// `accumulate` = 0 overwrites d with the step's sum.
template <typename T>
__device__ __forceinline__ void issue_step(float (&d)[64], uint32_t st,
                                           int wg, int accumulate) {
  constexpr int PL = Gemm<T>::kPlanes;
  const uint32_t a = st + wg * 64 * 128, b = st + PL * kTile;
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (PL == 2) {
      const uint64_t a_hi = sw128_desc(a + 32 * k);
      const uint64_t a_lo = sw128_desc(a + kTile + 32 * k);
      const uint64_t b_hi = sw128_desc(b + 32 * k);
      const uint64_t b_lo = sw128_desc(b + kTile + 32 * k);
      wgmma_tf32(d, a_lo, b_hi, accumulate || k > 0);
      wgmma_tf32(d, a_hi, b_lo, 1);
      wgmma_tf32(d, a_hi, b_hi, 1);
    } else {
      wgmma_ss<0, 0>(d, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                     accumulate || k > 0);
    }
  }
  wgmma_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    k3_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   T* __restrict__ c, float* __restrict__ ws, int M, int N,
                   int K, int splits) {
  using G = Gemm<T>;
  constexpr int PL = G::kPlanes, ST = G::kStages;
  constexpr uint32_t kStage = stage_bytes<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * kStage);
  uint64_t* empty = full + ST;

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles = tiles_m * ((N + kBN - 1) / kBN);
  const int n_items = tiles * splits;
  const int nk = (K + G::kBK - 1) / G::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
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
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item w = item_at(item, tiles_m, tiles, splits, nk);
        for (int kt = w.k0; kt < w.k1; ++kt, ++it) {
          const int s = it % ST;
          unsigned char* st = smem + s * kStage;
          mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(full + s, kStage);
#pragma unroll
          for (int p = 0; p < PL; ++p) {
            tma_load_3d(st + p * kTile, &a_map, full + s, kt * G::kBK, w.m0,
                        p);
            tma_load_3d(st + (PL + p) * kTile, &b_map, full + s, kt * G::kBK,
                        w.n0, p);
          }
        }
      }
    }
  } else {  // consumer warpgroups
    regs_inc<kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint32_t base = smem_u32(smem);
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item w = item_at(item, tiles_m, tiles, splits, nk);
      const int n = w.k1 - w.k0, it0 = it;
      float sum[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      // k step j of this item sits in stage (it0 + j) % ST
      auto wait_full = [&](int j) {
        const int s = (it0 + j) % ST;
        mbar_wait(full + s, ((it0 + j) / ST) & 1);
        return base + s * kStage;
      };
      auto release = [&](int j) { mbar_arrive(empty + (it0 + j) % ST); };
      if constexpr (PL == 2) {
        // two register tiles alternate: step j sums into ta (j even) or
        // tb (j odd) and is added to `sum` once step j + 1 is in flight
        float ta[64], tb[64];
        for (int j = 0; j < n; j += 2) {
          issue_step<T>(ta, wait_full(j), wg, 0);
          if (j > 0) {
            wgmma_wait<1>();
            keep(ta);
            keep(tb);
            add_to(sum, tb);
            release(j - 1);
          }
          if (j + 1 < n) {
            issue_step<T>(tb, wait_full(j + 1), wg, 0);
            wgmma_wait<1>();
            keep(ta);
            keep(tb);
            add_to(sum, ta);
            release(j);
          }
        }
        wgmma_wait<0>();
        keep(ta);
        keep(tb);
        if (n > 0) {
          if (n % 2)
            add_to(sum, ta);
          else
            add_to(sum, tb);
          release(n - 1);
        }
      } else {
        for (int j = 0; j < n; ++j) {
          issue_step<T>(sum, wait_full(j), wg, 1);
          wgmma_wait<1>();
          keep(sum);
          if (j > 0) release(j - 1);
        }
        wgmma_wait<0>();
        keep(sum);
        if (n > 0) release(n - 1);
      }
      it += n;
      store_tile<T>(sum, c, ws, M, N, w.m0 + wg * 64 + warp * 16 + lane / 4,
                    w.n0 + 2 * (lane % 4), item / tiles, splits);
    }
  }
}

// x (R, K) read through strides (s_r, s_k) -> out, K-major (R, Kp) with
// columns K .. Kp - 1 zero; f32: two planes, hi = tf32(x) and lo = tf32(x
// - hi), each rounded to nearest (ties away), as 3xTF32 takes them. A 32 x
// 32 tile goes through shared memory, so both the read (along whichever
// axis is unit-strided) and the write are coalesced. One launch copies
// both operands: the first `blocks` CTAs take A, the rest B.
template <typename T>
struct PackJob {
  const T* x;
  T* out;   // null: the operand is read in place
  int R, K, Kp;
  ll s_r, s_k;
  int blocks;  // 32 x 32 tiles, ceil(R / 32) (Kp / 32); 0 without `out`
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

template <typename T>
__global__ void __launch_bounds__(256)
    k3_pack_kernel(const PackJob<T> ja, const PackJob<T> jb) {
  __shared__ float tile[32][33];
  const bool second = blockIdx.x >= (unsigned)ja.blocks;
  const PackJob<T> j = second ? jb : ja;
  const int t = blockIdx.x - (second ? ja.blocks : 0);
  const int r_tiles = (j.R + 31) / 32;
  const int r0 = (t % r_tiles) * 32, k0 = (t / r_tiles) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const bool r_fast = j.s_k != 1 && j.s_r == 1;
  for (int i = ty; i < 32; i += 8) {
    const int rr = r_fast ? tx : i, kk = r_fast ? i : tx;
    const int gr = r0 + rr, gk = k0 + kk;
    float v = 0.f;
    if (gr < j.R && gk < j.K) {
      if constexpr (sizeof(T) == 4)
        v = j.x[gr * j.s_r + gk * j.s_k];
      else
        v = __bfloat162float(j.x[gr * j.s_r + gk * j.s_k]);
    }
    tile[rr][kk] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int gr = r0 + i;
    if (gr >= j.R) continue;
    const size_t at = (size_t)gr * j.Kp + k0 + tx;
    const float v = tile[i][tx];
    if constexpr (sizeof(T) == 4) {
      const float hi = tf32_rna(v);
      j.out[at] = hi;
      j.out[(size_t)j.R * j.Kp + at] = tf32_rna(v - hi);
    } else {
      j.out[at] = __float2bfloat16(v);
    }
  }
}

// C = the splits' f32 partials (splits, M, N) added in split order
template <typename T>
__global__ void k3_reduce_kernel(const float* __restrict__ ws,
                                 T* __restrict__ c, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[(size_t)sp * n + i];
    if constexpr (sizeof(T) == 4)
      c[i] = s;
    else
      c[i] = __float2bfloat16(s);
  }
}

// The copy job of one operand, R rows (M for A, N for B) by K: none (0
// blocks) when it is read in place
template <typename T>
PackJob<T> pack_job(const T* x, T* pack, int R, int K, ll s_r, ll s_k) {
  const int Kp = (K + Gemm<T>::kBK - 1) / Gemm<T>::kBK * Gemm<T>::kBK;
  const ll blocks = pack ? (ll)((R + 31) / 32) * (Kp / 32) : 0;
  return PackJob<T>{x, pack, R, K, Kp, s_r, s_k,
                    blocks > 0x3fffffff ? -1 : (int)blocks};
}

// The TMA map of one operand as the kernel reads it: K-major, 128-row
// boxes of 128 bytes of k; the copy (planes, R, Kp) or x itself, whose k
// stride is 1 and row stride s_r
template <typename T>
cudaError_t operand_map(CUtensorMap* map, const PackJob<T>& j) {
  using G = Gemm<T>;
  const cuuint64_t dims[3] = {(cuuint64_t)(j.out ? j.Kp : j.K),
                              (cuuint64_t)j.R,
                              (cuuint64_t)(j.out ? G::kPlanes : 1)};
  const cuuint64_t row = (cuuint64_t)(j.out ? j.Kp : j.s_r) * sizeof(T);
  const cuuint64_t strides[2] = {row, row * j.R};
  const cuuint32_t box[3] = {G::kBK, kBM, 1};
  return make_map_3d(map, G::kType, j.out ? (const void*)j.out : j.x, dims,
                     strides, box);
}

// the gemm kernel's shared-memory allowance and the SM count, set and read
// once per device
template <typename T>
cudaError_t prepare(int* sms) {
  static int known[64];  // SMs of each device prepared so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && known[dev]) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(k3_gemm_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gemm_smem<T>());
  if (!err) err = sm_count(sms);
  if (!err && dev < 64) known[dev] = *sms;
  return err;
}

template <typename T>
cudaError_t run(const T* a, const T* b, T* c, int M, int N, int K, ll sam,
                ll sak, ll sbk, ll sbn, T* a_pack, T* b_pack, float* ws,
                int splits, cudaStream_t stream) {
  const PackJob<T> ja = pack_job(a, a_pack, M, K, sam, sak);
  const PackJob<T> jb = pack_job(b, b_pack, N, K, sbn, sbk);
  if (ja.blocks < 0 || jb.blocks < 0) return cudaErrorInvalidValue;
  if (ja.blocks + jb.blocks > 0) {
    k3_pack_kernel<T><<<ja.blocks + jb.blocks, 256, 0, stream>>>(ja, jb);
    const cudaError_t err = cudaGetLastError();
    if (err) return err;
  }
  CUtensorMap a_map, b_map;
  int sms = 0;
  cudaError_t err = operand_map(&a_map, ja);
  if (!err) err = operand_map(&b_map, jb);
  if (!err) err = prepare<T>(&sms);
  if (err) return err;
  const ll items = (ll)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) * splits;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  k3_gemm_kernel<T><<<(int)(items < sms ? items : sms), kThreads,
                      gemm_smem<T>(), stream>>>(a_map, b_map, c, ws, M, N, K,
                                                splits);
  err = cudaGetLastError();
  if (err || splits == 1) return err;
  const size_t n = (size_t)M * N;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  k3_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, c, n, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: f32 (3xTF32), 1: bf16. C (M, N) contiguous; A, B strided (in
// elements). a_pack / b_pack: scratch for the K-major copy of an operand,
// (planes, rows, K rounded up to 32 f32 or 64 bf16), planes 2 in f32 and
// 1 in bf16; null (bf16 only) reads the operand in place, which needs a k
// stride of 1 and a 16-byte aligned base and row stride. splits > 1: ws is
// f32 (splits, M, N) scratch for the split-K partials. K >= 1.
extern "C" int nk_matmul(int dtype, const void* a, const void* b, void* c,
                         int M, int N, int K, ll sam, ll sak, ll sbk, ll sbn,
                         void* a_pack, void* b_pack, void* ws, int splits,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (splits > 1 && !ws))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0) {
    if (!a_pack || !b_pack) return cudaErrorInvalidValue;
    return run<float>(static_cast<const float*>(a),
                      static_cast<const float*>(b), static_cast<float*>(c), M,
                      N, K, sam, sak, sbk, sbn, static_cast<float*>(a_pack),
                      static_cast<float*>(b_pack), w, splits, s);
  }
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                     static_cast<bf16*>(c), M, N, K, sam, sak, sbk, sbn,
                     static_cast<bf16*>(a_pack), static_cast<bf16*>(b_pack),
                     w, splits, s);
  return cudaErrorInvalidValue;
}
