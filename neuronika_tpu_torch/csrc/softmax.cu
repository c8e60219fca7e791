// Row softmax and log-softmax over the last axis on Hopper.
//
// Replaces K4, neuronika_tpu/ops/pallas/softmax.py::_softmax_kernel: for
// each row of a (rows, cols) view, m = max, s = sum exp(x - m), then
// exp(x - m) / s or x - m - log s, in f32, written in x's dtype. The TPU
// kernel holds a block of rows in VMEM; here one CTA of 256 threads owns one
// row and any column count.
//
// What bounds it: each element is read once and written once, with a few
// flops between, so device memory is the limit: 2 * rows * cols * itemsize
// bytes over 3.35 TB/s (4.29 GB and 1.28 ms for the (32768, 16384) f32
// log-softmax of the Var GPT's loss). The design keeps it to one read:
//   * rows of up to 16384 columns are held in registers (64 floats a
//     thread), loaded with 16-byte vector loads where the row allows, so
//     the max, the sum and the output all come from one read of the row;
//   * longer rows take two passes: an online (max, sum) pass, then a pass
//     that re-reads the row and writes the output.
// exp and log are the accurate expf/logf, not the fast intrinsics, so the
// kernel agrees with the plain version to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCached = 64;  // floats of one row a thread holds in registers
typedef long long ll;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements at p into f (one 16-byte load when VEC * sizeof(T) == 16)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&f)[VEC], const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T t[VEC];
    *reinterpret_cast<uint4*>(t) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T t[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) t[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(f[i]);
  }
}

// block-wide max / sum over 256 threads; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncthreads();  // red is free: every thread read the last result
  if (l == 0) red[w] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) v += red[i];
  return v;
}

// Rows of up to kThreads * kCached columns: one read, the row in registers.
template <typename T, bool LOG, int VEC>
__global__ void __launch_bounds__(kThreads)
    softmax_cached_kernel(const T* __restrict__ x, T* __restrict__ y,
                          int cols) {
  constexpr int ITEMS = kCached / VEC;
  __shared__ float red[kThreads / 32];
  const T* xr = x + (ll)blockIdx.x * cols;
  T* yr = y + (ll)blockIdx.x * cols;
  float v[ITEMS][VEC];
  float mx = -INFINITY;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int c0 = (it * kThreads + threadIdx.x) * VEC;
    if (c0 < cols) {
      load_vec<T, VEC>(v[it], xr + c0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) mx = fmaxf(mx, v[it][i]);
    }
  }
  mx = block_max(mx, red);
  float s = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int c0 = (it * kThreads + threadIdx.x) * VEC;
    if (c0 < cols) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float e = expf(v[it][i] - mx);
        s += e;
        if (!LOG) v[it][i] = e;
      }
    }
  }
  s = block_sum(s, red);
  const float shift = LOG ? mx + logf(s) : 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int c0 = (it * kThreads + threadIdx.x) * VEC;
    if (c0 < cols) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = LOG ? v[it][i] - shift : v[it][i] / s;
      store_vec<T, VEC>(yr + c0, o);
    }
  }
}

// (m1, s1) and (m2, s2) -> the pair of the union; -inf max means empty
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn));
  m = mn;
}

// Longer rows: an online (max, sum) pass, then an output pass.
template <typename T, bool LOG, int VEC>
__global__ void __launch_bounds__(kThreads)
    softmax_online_kernel(const T* __restrict__ x, T* __restrict__ y,
                          int cols) {
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  const T* xr = x + (ll)blockIdx.x * cols;
  T* yr = y + (ll)blockIdx.x * cols;
  float m = -INFINITY, s = 0.f;
  for (int c0 = threadIdx.x * VEC; c0 < cols; c0 += kThreads * VEC) {
    float f[VEC];
    load_vec<T, VEC>(f, xr + c0);
    float cm = f[0];
#pragma unroll
    for (int i = 1; i < VEC; ++i) cm = fmaxf(cm, f[i]);
    if (cm == -INFINITY) continue;
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) cs += expf(f[i] - cm);
    merge(m, s, cm, cs);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(~0u, m, o);
    const float s2 = __shfl_xor_sync(~0u, s, o);
    merge(m, s, m2, s2);
  }
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (l == 0) {
    red_m[w] = m;
    red_s[w] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) merge(m, s, red_m[i], red_s[i]);
  const float shift = LOG ? m + logf(s) : 0.f;
  for (int c0 = threadIdx.x * VEC; c0 < cols; c0 += kThreads * VEC) {
    float f[VEC];
    load_vec<T, VEC>(f, xr + c0);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      f[i] = LOG ? f[i] - shift : expf(f[i] - m) / s;
    store_vec<T, VEC>(yr + c0, f);
  }
}

template <typename T, bool LOG, int VEC>
int launch_vec(const void* x, void* y, int rows, int cols, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (cols <= kThreads * kCached)
    softmax_cached_kernel<T, LOG, VEC><<<rows, kThreads, 0, st>>>(xp, yp, cols);
  else
    softmax_online_kernel<T, LOG, VEC><<<rows, kThreads, 0, st>>>(xp, yp, cols);
  return cudaGetLastError();
}

template <typename T, bool LOG>
int launch(const void* x, void* y, int rows, int cols, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = cols % E == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  return vec ? launch_vec<T, LOG, E>(x, y, rows, cols, st)
             : launch_vec<T, LOG, 1>(x, y, rows, cols, st);
}

}  // namespace

// dtype 0: f32, 1: bf16; x and y contiguous (rows, cols); log: 0 softmax,
// 1 log-softmax.
extern "C" int nk_softmax(int dtype, const void* x, void* y, int rows,
                          int cols, int log, void* stream) {
  if (rows < 1 || cols < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return log ? launch<float, true>(x, y, rows, cols, s)
               : launch<float, false>(x, y, rows, cols, s);
  if (dtype == 1)
    return log ? launch<bf16, true>(x, y, rows, cols, s)
               : launch<bf16, false>(x, y, rows, cols, s);
  return cudaErrorInvalidValue;
}
