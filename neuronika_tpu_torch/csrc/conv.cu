// Direct convolutions on Hopper, as implicit GEMMs: K12, K13, K14, K15.
//
// The bf16 K12, K13, K14 and K15 of groups 1 with channels that are
// multiples of 8 moved to csrc/conv_sm90.cu (wgmma fed by TMA im2col
// loads, warp specialised, persistent): every ResNet-18 conv but the stem,
// and its stride-1 dx and dw, 1-d convs whose (k - 1) d is at most 32768
// and 3-d convs whose (k - 1) d is at most 16. ops/conv.py::conv_route
// sends by shape alone what stays here: f32 (conv_ffma), grouped convs,
// channel counts that are not multiples of 8 (the ImageNet stem's Ci = 3)
// and wider taps.
//
// Replaces four kernels of neuronika_tpu/ops/pallas/conv.py:
//   K12 _conv2d_nhwc_kernel  stride-1 NHWC 2-d conv with dilation and groups
//                            (strided convs by s*s phases in JAX; also the
//                            stride-1 input gradient)          -> nk_conv2d
//   K13 _dw_kernel           the conv weight gradient, accumulated over the
//                            batch                            -> nk_conv_dw
//   K14 _conv1d_kernel       stride-1 NWC 1-d conv            -> nk_conv1d
//   K15 _conv3d_kernel       stride-1 NDHWC 3-d conv          -> nk_conv3d
// The TPU kernels are sums of shifted MXU matmuls over flat VMEM windows
// (W padded to 16, wraparound columns cropped, row-block clamps, phases for
// strides). None of that carries over. Here every conv is one GEMM whose A
// operand is never written to memory (an implicit im2col):
//
//   forward (K12, K14, K15), one GEMM per group g:
//     M = output pixels (n, od, oh, ow), N = Co / groups,
//     K = taps * (Ci / groups), the taps (td, th, tw) folded into K;
//     A(m, k) = x[n, od*sd + td*dd, oh*sh + th*dh, ow*sw + tw*dw, g*cig + ci]
//     B(k, n) = w[td, th, tw, ci, g*cog + n]            (w is (taps*cig, Co))
//   weight gradient (K13), groups 1:
//     M = taps * Ci, N = Co, K = output pixels:  dw = A^T . G
//     with A as above and G (pixels, Co) the output gradient.
//
// All ranks run one kernel: a 1-d conv is a 3-d one with D = H = 1 and a
// 2-d one has D = 1. Strides are taken natively (one launch, the output
// rounded once), not by JAX's phase decomposition, whose bf16 phases are
// each rounded and then summed in bf16. Folding the taps into K matters for
// the ImageNet stem: with Ci = 3 a tap alone gives K = 3, while 7*7*3 = 147
// fills the MMA's depth.
//
// What bounds it on the H100: at ResNet's and the bench's shapes the convs
// do 100-300 operations a byte, on the tensor cores' side of the bf16
// ridge (295), so the bound is the bf16 peak (989 TFLOP/s) and for f32 the
// 67 TFLOP/s of FFMA. This first version is a plain tiled GEMM, far from
// those peaks:
//   * a CTA owns a 128 x 128 tile of C and walks K in steps of 32 (bf16:
//     mma.sync m16n8k16, f32 accumulators, 8 warps of 64 x 32) or 8 (f32:
//     FFMA, each thread an 8 x 8 block), double-buffered through shared
//     memory with one barrier a step, as K3 (csrc/matmul.cu) does;
//   * bf16 tiles go into shared memory as 16-byte stores, k-major for an
//     operand whose chunks run along its rows (the weights, K13's two
//     operands), and come out through ldmatrix (.trans for k-major ones):
//     scattering such chunks element by element put 16 threads of a warp
//     on one bank and ran K13 at a third of its present rate;
//   * the im2col addresses cost integer work: in the forward each thread
//     keeps the base address of its A rows for the whole K loop and steps
//     its (tap, ci) position by the K step, dividing only when it crosses
//     a tap; in K13 it steps its pixels (n, od, oh, ow) with carries;
//     16-byte loads where the channels of a tap are a multiple of the
//     chunk, element loads otherwise (the stem's Ci = 3);
//   * K13's output is small (9 * 64 * 64 at ResNet stage 1) against a
//     reduction over every output pixel (200,704 at B64), so the reduction
//     is split over CTAs (blockIdx.z), each writing an f32 partial, and a
//     second pass sums the partials in split order: deterministic.
// Not done here: wgmma, TMA or cp.async stages, a 64-wide N tile for
// Co = 64, a persistent schedule (all in conv_sm90.cu, for what it takes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef long long ll;
typedef __nv_bfloat16 bf16;
constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kGeo = 19;  // ints in the host geometry array

// A VALID conv of rank <= 3 as rank 3 (unit leading dims for lower ranks).
struct Geo {
  int N, D, H, W, Ci;   // input (N, D, H, W, Ci), channels last
  int Do, Ho, Wo, Co;   // output (N, Do, Ho, Wo, Co)
  int kd, kh, kw;
  int sd, sh, sw;
  int dd, dh, dw;
  int groups;
  int cig, cog, taps, M;  // Ci / groups, Co / groups, kd*kh*kw, N*Do*Ho*Wo
};

// Offset in x of the window origin (channel 0) of output pixel (n, od,
// oh, ow).
__device__ __forceinline__ ll origin(const Geo& g, int n, int od, int oh,
                                     int ow) {
  return ((((ll)n * g.D + (ll)od * g.sd) * g.H + (ll)oh * g.sh) * g.W +
          (ll)ow * g.sw) *
         g.Ci;
}

// An output pixel as (n, od, oh, ow), stepped along the pixel order.
struct Pixel {
  int n, od, oh, ow;

  __device__ void set(const Geo& g, int m) {
    ow = m % g.Wo;
    int t = m / g.Wo;
    oh = t % g.Ho;
    t /= g.Ho;
    od = t % g.Do;
    n = t / g.Do;
  }

  // m += step with carries, no division (the loop runs step / Wo + 1
  // times at most)
  __device__ void advance(const Geo& g, int step) {
    ow += step;
    while (ow >= g.Wo) {
      ow -= g.Wo;
      if (++oh == g.Ho) {
        oh = 0;
        if (++od == g.Do) {
          od = 0;
          ++n;
        }
      }
    }
  }

  __device__ ll base(const Geo& g) const { return origin(g, n, od, oh, ow); }
};

__device__ __forceinline__ ll pixel_base(const Geo& g, int m) {
  Pixel p;
  p.set(g, m);
  return p.base(g);
}

// Offset of tap t (td, th, tw) from a window origin.
__device__ __forceinline__ ll tap_offset(const Geo& g, int t) {
  const int tw = t % g.kw;
  const int r = t / g.kw;
  const int th = r % g.kh;
  const int td = r / g.kh;
  return (((ll)td * g.dd * g.H + (ll)th * g.dh) * g.W + (ll)tw * g.dw) * g.Ci;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Per type: K step of the main loop, elements of one 16-byte chunk, and
// chunks a thread loads of each 128 x BK operand tile.
template <typename T>
struct Tr;
template <>
struct Tr<float> {
  static constexpr int BK = 8, E = 4;
};
template <>
struct Tr<bf16> {
  static constexpr int BK = 32, E = 8;
};
template <typename T>
constexpr int kSlots = kBM * Tr<T>::BK / Tr<T>::E / kThreads;

template <typename T>
struct alignas(16) Chunk {
  T v[Tr<T>::E];
};

// Origin (row, k) within the tile of a thread's chunk in slot s: chunks run
// along the row axis (kFastRow) or along k.
template <typename T, bool kFastRow>
__device__ __forceinline__ void chunk_origin(int s, int& row, int& k) {
  constexpr int BK = Tr<T>::BK, E = Tr<T>::E;
  const int c = threadIdx.x + s * kThreads;
  if (kFastRow) {
    row = (c % (kBM / E)) * E;
    k = c / (kBM / E);
  } else {
    row = c / (BK / E);
    k = (c % (BK / E)) * E;
  }
}

template <typename T>
__device__ __forceinline__ void vload(Chunk<T>& c, const T* p) {
  *reinterpret_cast<uint4*>(c.v) = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void zero(Chunk<T>& c) {
#pragma unroll
  for (int i = 0; i < Tr<T>::E; ++i) c.v[i] = T(0.f);
}

// A of the forward: rows are output pixels, chunks run along k = (tap, ci).
template <typename T>
struct FwdA {
  static constexpr bool kFastRow = false;
  static constexpr int E = Tr<T>::E, S = kSlots<T>;
  const T* x;        // offset to the group's first channel
  ll base[S];        // pixel_base of the slot's row
  bool ok[S];        // row < M
  int k, kend;       // this thread's chunk position along K, and K
  int tap, ci;       // k = tap * cig + ci
  ll toff;           // tap_offset(tap)
  bool vec;

  __device__ void init(const Geo& g, const T* x_, int m0, int kbegin,
                       int kend_) {
    x = x_;
    kend = kend_;
    int row = 0, kk = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      chunk_origin<T, false>(s, row, kk);
      const int m = m0 + row;
      ok[s] = m < g.M;
      base[s] = ok[s] ? pixel_base(g, m) : 0;
    }
    k = kbegin + kk;  // the same k offset in every slot
    tap = k / g.cig;
    ci = k - tap * g.cig;
    toff = tap_offset(g, tap);
    vec = g.cig % E == 0 && g.Ci % E == 0 && aligned16(x);
  }

  __device__ void load(const Geo& g, Chunk<T> (&c)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = ok[s] ? max(0, min(E, kend - k)) : 0;
      if (vec && n == E) {
        vload(c[s], x + base[s] + toff + ci);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (i < n) {
            const int kk = k + i;
            const int t = kk / g.cig;
            c[s].v[i] = x[base[s] + tap_offset(g, t) + (kk - t * g.cig)];
          } else {
            c[s].v[i] = T(0.f);
          }
        }
      }
    }
  }

  __device__ void advance(const Geo& g, int bk) {
    k += bk;
    ci += bk;
    if (ci >= g.cig) {
      tap += ci / g.cig;
      ci %= g.cig;
      toff = tap_offset(g, tap);
    }
  }
};

// A of the weight gradient: rows r = (tap, ci), chunks along r; k = pixels.
// Each slot's pixel is stepped by the K step, so the K loop divides only
// in `init`.
template <typename T>
struct DwA {
  static constexpr bool kFastRow = true;
  static constexpr int E = Tr<T>::E, S = kSlots<T>;
  const T* x;
  ll roff;     // tap_offset(tap(r)) + ci(r) of the chunk's first row
  int r, nr;   // first row of the chunk, rows of it that exist
  int k[S], kend;
  Pixel px[S];  // pixel k[s]
  bool vec;

  __device__ void init(const Geo& g, const T* x_, int r0, int kbegin,
                       int kend_) {
    x = x_;
    kend = kend_;
    int row = 0, kk = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      chunk_origin<T, true>(s, row, kk);
      k[s] = kbegin + kk;
      px[s].set(g, k[s]);
    }
    r = r0 + row;  // the same row in every slot
    nr = max(0, min(E, g.taps * g.Ci - r));
    roff = nr ? tap_offset(g, r / g.Ci) + r % g.Ci : 0;
    vec = g.Ci % E == 0 && aligned16(x);
  }

  __device__ void load(const Geo& g, Chunk<T> (&c)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (k[s] >= kend || nr == 0) {
        zero(c[s]);
        continue;
      }
      const ll pb = px[s].base(g);
      if (vec && nr == E) {
        vload(c[s], x + pb + roff);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int rr = r + i;
          c[s].v[i] = i < nr ? x[pb + tap_offset(g, rr / g.Ci) + rr % g.Ci]
                             : T(0.f);
        }
      }
    }
  }

  __device__ void advance(const Geo& g, int bk) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      k[s] += bk;
      px[s].advance(g, bk);
    }
  }
};

// B: a row-major matrix, element (k, n) at p[k * ld + n] for n < nmax;
// chunks run along n. The weights of the forward, the gradient of K13.
template <typename T>
struct MatB {
  static constexpr int E = Tr<T>::E, S = kSlots<T>;
  const T* p;
  ll ld;
  int n, nn;   // first column of the chunk, columns of it that exist
  int k[S], kend;
  bool vec;

  __device__ void init(const T* p_, ll ld_, int nmax, int n0, int kbegin,
                       int kend_) {
    p = p_;
    ld = ld_;
    kend = kend_;
    int row = 0, kk = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      chunk_origin<T, true>(s, row, kk);
      k[s] = kbegin + kk;
    }
    n = n0 + row;
    nn = max(0, min(E, nmax - n));
    vec = ld % E == 0 && aligned16(p);
  }

  __device__ void load(Chunk<T> (&c)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (k[s] >= kend || nn == 0) {
        zero(c[s]);
        continue;
      }
      const T* q = p + (ll)k[s] * ld + n;
      if (vec && nn == E) {
        vload(c[s], q);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) c[s].v[i] = i < nn ? q[i] : T(0.f);
      }
    }
  }

  __device__ void advance(int bk) {
#pragma unroll
    for (int s = 0; s < S; ++s) k[s] += bk;
  }
};

// ------------------------------------------------------------ shared tiles
// f32: k-major S[k][row]. bf16: an operand whose chunks run along k (the
// forward's im2col A) is stored row-major S[row][k], the others k-major
// S[k][row]; every bf16 chunk goes in with one 16-byte store and comes out
// through ldmatrix (.trans for the k-major tiles). Rows are padded so that
// the 8 rows an ldmatrix reads fall in distinct banks.
constexpr int kLD32 = kBM + 4;
constexpr int kLD16 = Tr<bf16>::BK + 8;   // S[row][k]: 80-byte rows
constexpr int kLDT16 = kBM + 8;           // S[k][row]: 272-byte rows
constexpr int kTile16 = kBM * kLD16 > Tr<bf16>::BK * kLDT16
                            ? kBM * kLD16
                            : Tr<bf16>::BK * kLDT16;

template <bool kFastRow>
__device__ __forceinline__ void store_tile(float* S,
                                           const Chunk<float> (&c)[1]) {
  int row, k;
  chunk_origin<float, kFastRow>(0, row, k);
  if (kFastRow) {
    *reinterpret_cast<float4*>(S + k * kLD32 + row) =
        *reinterpret_cast<const float4*>(c[0].v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) S[(k + i) * kLD32 + row] = c[0].v[i];
  }
}

template <bool kFastRow>
__device__ __forceinline__ void store_tile(bf16* S, const Chunk<bf16> (&c)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int row, k;
    chunk_origin<bf16, kFastRow>(s, row, k);
    bf16* p = kFastRow ? S + k * kLDT16 + row : S + row * kLD16 + k;
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(c[s].v);
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// The A fragment of rows m0..m0+15, k0..k0+15 (mma.sync m16n8k16 order:
// rows 0-7 and 8-15 at k 0-7, then at k 8-15).
template <bool kKMajor>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* S,
                                            int m0, int k0) {
  const int l = threadIdx.x % 32, j = l / 8;
  if (kKMajor)
    ldsm_x4<true>(a, S + (k0 + l % 8 + (j / 2) * 8) * kLDT16 + m0 +
                         (j % 2) * 8);
  else
    ldsm_x4<false>(a, S + (m0 + l % 16) * kLD16 + k0 + (l / 16) * 8);
}

// The B fragments of columns n0..n0+15 (two n8 tiles), k0..k0+15, from a
// k-major tile.
__device__ __forceinline__ void load_b_frags(uint32_t (&b0)[2],
                                             uint32_t (&b1)[2], const bf16* S,
                                             int n0, int k0) {
  const int l = threadIdx.x % 32, j = l / 8;
  uint32_t r[4];
  ldsm_x4<true>(r, S + (k0 + l % 8 + (j % 2) * 8) * kLDT16 + n0 + (j / 2) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// --------------------------------------------------------------- one job
// What a CTA computes. Forward: blockIdx.z is the group; the output tile
// is written in T at out[m * Co + z * cog + n]. Weight gradient: blockIdx.z
// is the split of the pixel reduction; the f32 partial goes to
// ws[z][r][co].
template <typename T, bool kDw>
struct Job {
  typedef typename std::conditional<kDw, DwA<T>, FwdA<T>>::type LA;
  typedef typename std::conditional<kDw, float, T>::type OutT;
  LA la;
  MatB<T> lb;
  OutT* C;
  ll ldc;
  int rows, cols, kbegin, kend;

  __device__ void init(const Geo& g, const T* x, const T* b, void* out,
                       int kchunk) {
    const int z = blockIdx.z;
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    if (kDw) {
      kbegin = z * kchunk;
      kend = min(g.M, kbegin + kchunk);
      rows = g.taps * g.Ci;
      cols = g.Co;
      la.init(g, x, m0, kbegin, kend);
      lb.init(b, g.Co, g.Co, n0, kbegin, kend);
      C = static_cast<OutT*>(out) + (ll)z * rows * cols;
      ldc = cols;
    } else {
      kbegin = 0;
      kend = g.taps * g.cig;
      rows = g.M;
      cols = g.cog;
      la.init(g, x + (ll)z * g.cig, m0, kbegin, kend);
      lb.init(b + (ll)z * g.cog, g.Co, g.cog, n0, kbegin, kend);
      C = static_cast<OutT*>(out) + (ll)z * g.cog;
      ldc = g.Co;
    }
  }
};

// ------------------------------------------------------------------ f32
template <bool kDw>
__global__ void __launch_bounds__(kThreads)
    conv_ffma(Geo g, const float* __restrict__ x, const float* __restrict__ b,
              void* out, int kchunk) {
  constexpr int BK = Tr<float>::BK;
  __shared__ __align__(16) float As[2][BK * kLD32];
  __shared__ __align__(16) float Bs[2][BK * kLD32];
  Job<float, kDw> job;
  job.init(g, x, b, out, kchunk);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (job.kend - job.kbegin + BK - 1) / BK;
  Chunk<float> ra[1], rb[1];
  if (nk > 0) {
    job.la.load(g, ra);
    job.lb.load(rb);
    store_tile<Job<float, kDw>::LA::kFastRow>(As[0], ra);
    store_tile<true>(Bs[0], rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      job.la.advance(g, BK);
      job.lb.advance(BK);
      job.la.load(g, ra);
      job.lb.load(rb);
    }
    const float* as = As[buf];
    const float* bs = Bs[buf];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLD32 + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * kLD32 + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kLD32 + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * kLD32 + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {
      store_tile<Job<float, kDw>::LA::kFastRow>(As[buf ^ 1], ra);
      store_tile<true>(Bs[buf ^ 1], rb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 4 + (i % 4) + (i / 4) * 64;
    if (row >= job.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 4 + (j % 4) + (j / 4) * 64;
      if (col < job.cols) put(job.C + (ll)row * job.ldc + col, acc[i][j]);
    }
  }
}

// ----------------------------------------------------------------- bf16
template <bool kDw>
__global__ void __launch_bounds__(kThreads)
    conv_mma(Geo g, const bf16* __restrict__ x, const bf16* __restrict__ b,
             void* out, int kchunk) {
  constexpr int BK = Tr<bf16>::BK;
  constexpr bool kAKMajor = Job<bf16, kDw>::LA::kFastRow;
  __shared__ __align__(16) bf16 As[2][kTile16];
  __shared__ __align__(16) bf16 Bs[2][kTile16];
  Job<bf16, kDw> job;
  job.init(g, x, b, out, kchunk);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int r = lane >> 2, c = (lane & 3) * 2;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (job.kend - job.kbegin + BK - 1) / BK;
  Chunk<bf16> ra[2], rb[2];
  if (nk > 0) {
    job.la.load(g, ra);
    job.lb.load(rb);
    store_tile<Job<bf16, kDw>::LA::kFastRow>(As[0], ra);
    store_tile<true>(Bs[0], rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      job.la.advance(g, BK);
      job.lb.advance(BK);
      job.la.load(g, ra);
      job.lb.load(rb);
    }
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t bf[4][2];
      load_b_frags(bf[0], bf[1], Bs[buf], wn, k0);
      load_b_frags(bf[2], bf[3], Bs[buf], wn + 16, k0);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        load_a_frag<kAKMajor>(a, As[buf], wm + mt * 16, k0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bf[nt]);
      }
    }
    if (more) {
      store_tile<Job<bf16, kDw>::LA::kFastRow>(As[buf ^ 1], ra);
      store_tile<true>(Bs[buf ^ 1], rb);
    }
    __syncthreads();
  }
  // acc[mt][nt][e] is row mt*16 + r + 8 (e / 2), column nt*8 + c + e % 2 of
  // the warp's 64 x 32 block
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + wm + mt * 16 + r + 8 * e2;
      if (row >= job.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + nt * 8 + c + e;
          if (col < job.cols)
            put(job.C + (ll)row * job.ldc + col, acc[mt][nt][e2 * 2 + e]);
        }
    }
}

// K13's second pass: out[i] = sum over z, in order, of ws[z][i].
__global__ void conv_dw_reduce(const float* __restrict__ ws,
                               float* __restrict__ out, ll n, int splits) {
  for (ll i = blockIdx.x * (ll)blockDim.x + threadIdx.x; i < n;
       i += (ll)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * n + i];
    out[i] = s;
  }
}

// geo: N D H W Ci  Do Ho Wo Co  kd kh kw  sd sh sw  dd dh dw  groups.
// Returns false unless every size is positive, the groups divide the
// channels and every output window lies inside the input.
bool parse(const int* a, Geo& g) {
  g = Geo{a[0],  a[1],  a[2],  a[3],  a[4],  a[5],  a[6],  a[7],  a[8], a[9],
          a[10], a[11], a[12], a[13], a[14], a[15], a[16], a[17], a[18]};
  for (int i = 0; i < kGeo; ++i)
    if (a[i] < 1) return false;
  if (g.Ci % g.groups || g.Co % g.groups) return false;
  if ((ll)(g.Do - 1) * g.sd + (ll)g.dd * (g.kd - 1) >= g.D ||
      (ll)(g.Ho - 1) * g.sh + (ll)g.dh * (g.kh - 1) >= g.H ||
      (ll)(g.Wo - 1) * g.sw + (ll)g.dw * (g.kw - 1) >= g.W)
    return false;
  g.cig = g.Ci / g.groups;
  g.cog = g.Co / g.groups;
  g.taps = g.kd * g.kh * g.kw;
  const ll M = (ll)g.N * g.Do * g.Ho * g.Wo;
  const ll K = (ll)g.taps * g.Ci;
  if (M > INT32_MAX || K > INT32_MAX) return false;
  g.M = (int)M;
  return true;
}

int conv_fwd(int dtype, const void* x, const void* w, void* out,
             const int* geo, void* stream) {
  Geo g;
  if (!parse(geo, g) || g.groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.cog + kBN - 1) / kBN, g.groups);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    conv_ffma<false><<<grid, kThreads, 0, s>>>(
        g, static_cast<const float*>(x), static_cast<const float*>(w), out, 0);
  else if (dtype == 1)
    conv_mma<false><<<grid, kThreads, 0, s>>>(
        g, static_cast<const bf16*>(x), static_cast<const bf16*>(w), out, 0);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype 0: f32, 1: bf16. x (N, D, H, W, Ci), w (kd, kh, kw, Ci/groups, Co),
// out (N, Do, Ho, Wo, Co), all contiguous; geo as `parse` reads it.
// K12: a 2-d conv (D = kd = 1), any stride, dilation and groups.
extern "C" int nk_conv2d(int dtype, const void* x, const void* w, void* out,
                         const int* geo, void* stream) {
  if (geo[1] != 1 || geo[9] != 1) return cudaErrorInvalidValue;
  return conv_fwd(dtype, x, w, out, geo, stream);
}

// K14: a stride-1 1-d conv (D = H = 1), groups 1.
extern "C" int nk_conv1d(int dtype, const void* x, const void* w, void* out,
                         const int* geo, void* stream) {
  if (geo[1] != 1 || geo[2] != 1 || geo[9] != 1 || geo[10] != 1 ||
      geo[14] != 1 || geo[18] != 1)
    return cudaErrorInvalidValue;
  return conv_fwd(dtype, x, w, out, geo, stream);
}

// K15: a stride-1 3-d conv, groups 1.
extern "C" int nk_conv3d(int dtype, const void* x, const void* w, void* out,
                         const int* geo, void* stream) {
  if (geo[12] != 1 || geo[13] != 1 || geo[14] != 1 || geo[18] != 1)
    return cudaErrorInvalidValue;
  return conv_fwd(dtype, x, w, out, geo, stream);
}

// K13: dw (kd, kh, kw, Ci, Co) f32 of the conv `geo` (groups 1) from x and
// the output gradient gout (N, Do, Ho, Wo, Co). The pixel reduction is cut
// into `splits` ranges of `kchunk` pixels (a multiple of 32); with more than
// one, each writes its partial to ws (splits, kd*kh*kw*Ci, Co) f32 and a
// second pass sums them into out in split order. With one, ws may be out.
extern "C" int nk_conv_dw(int dtype, const void* x, const void* gout,
                          void* ws, void* out, const int* geo, int splits,
                          int kchunk, void* stream) {
  Geo g;
  if (!parse(geo, g) || g.groups != 1 || splits < 1 || splits > 65535 ||
      kchunk < 1 || kchunk % 32 || (ll)(splits - 1) * kchunk >= g.M ||
      (ll)splits * kchunk < g.M)
    return cudaErrorInvalidValue;
  const int rows = g.taps * g.Ci;
  const dim3 grid((rows + kBM - 1) / kBM, (g.Co + kBN - 1) / kBN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* part = splits > 1 ? ws : out;
  if (dtype == 0)
    conv_ffma<true><<<grid, kThreads, 0, s>>>(
        g, static_cast<const float*>(x), static_cast<const float*>(gout), part,
        kchunk);
  else if (dtype == 1)
    conv_mma<true><<<grid, kThreads, 0, s>>>(
        g, static_cast<const bf16*>(x), static_cast<const bf16*>(gout), part,
        kchunk);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const ll n = (ll)rows * g.Co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  conv_dw_reduce<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                        static_cast<float*>(out), n, splits);
  return cudaGetLastError();
}
