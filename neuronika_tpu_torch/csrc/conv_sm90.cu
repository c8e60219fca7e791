// K12, K13, K14 and K15 in bf16 on Hopper: warp-specialised implicit
// GEMMs on wgmma, with the im2col operand loaded by TMA's im2col mode.
//
// Replaces, for bf16 convs of groups 1 whose channels are multiples of 8
// (TMA's 16-byte strides), four kernels of neuronika_tpu/ops/pallas/
// conv.py:
//   K12 _conv2d_nhwc_kernel  a VALID NHWC 2-d conv, any dilation, stride 1
//                            to 8 (the stride-1 input gradient runs here
//                            too, on the padded gradient) -> nk_conv2d_sm90
//   K13 _dw_kernel           the weight gradient of a stride-1 conv, summed
//                            over the batch, f32     -> nk_conv_dw_sm90
//   K14 _conv1d_kernel       a VALID stride-1 NWC 1-d conv, any dilation
//                            with (k - 1) d <= 32768 (the rank-3 im2col
//                            corner range)             -> nk_conv1d_sm90
//   K15 _conv3d_kernel       a VALID stride-1 NDHWC 3-d conv, any dilation
//                            with (k - 1) d <= 16 (the rank-5 im2col corner
//                            range)                   -> nk_conv3d_sm90
// (The rank-4 corner range bounds K12's (k - 1) d at 128 on each axis.)
// A bf16 2-d conv of groups 1 with fewer than 8 input channels (both
// ResNet stems: Ci = 3 gives TMA a 6-byte row) runs K12 here too, its
// horizontal taps (and the rows of a vertical stride) stacked into
// channels (nk_conv_stack_taps, then nk_conv2d_stacked_sm90; below).
// Every other conv (f32, groups, Ci >= 8 not a multiple of 8, Co not a
// multiple of 8, wider taps) stays on csrc/conv.cu; ops/conv.py::conv_route
// decides by shape alone. The TPU kernels sum shifted MXU matmuls over
// flat VMEM windows; none of that carries over.
//
//   forward (K12, K14, K15): M = output pixels (n, od, oh, ow), N = Co,
//     K = (tap, 64-channel panel) steps; A(m, (t, c)) = x[n, oh sh + th dh,
//     ow sw + tw dw, c], B((t, c), co) = w[th, tw, c, co].
//   weight gradient (K13): M = (tap, 64-channel panel) row blocks, N = Co,
//     K = output pixels; dw = A^T G with A as above and G (pixels, Co).
//
// What bounds them on the H100: at ResNet-18's and the bench's shapes a
// conv does 100-300 operations a byte, so the bf16 peak (989 TFLOP/s).
// The design, matmul.cu's pattern:
//   * A's tile is one TMA im2col load: its base pixels walk the output
//     positions in (n, oh, ow) order across rows and samples (the order of
//     the output and of G's rows), the tap enters as the load's offsets,
//     dilation through them, stride through the map's traversal strides;
//     pixels past the last sample and channels past Ci arrive as zeros.
//     Rows are 64 channels (128 bytes), 128-byte swizzled: K-major for
//     the forward's A, MN-major (the transpose bit) for K13's.
//   * B is read in place, MN-major, by tiled maps: the weights
//     (Co, Ci, taps) for the forward, whose panels past Ci read as zeros
//     as A's channels do; G (Co, pixels) for K13. An operand wider than
//     64 columns is 64-column panels, LBO apart (sw128_desc_mn).
//   * A CTA is two consumer warpgroups (wgmma m64nBNk16 into f32
//     registers) and a producer warpgroup whose one thread keeps a ring of
//     TMA loads in flight on mbarriers (the forward: as many stages as fit
//     beside its output staging, 8 at BN 64, 6 at 128, 4 at 256; K13 6,
//     and 4 at BN 256); setmaxnreg moves the producer's registers to the
//     consumers. The grid is persistent, one CTA an SM, work items in a
//     fixed order, so one item's epilogue overlaps the next one's loads.
//     BN follows Co: 64 at Co <= 64, else 128 (K12, K15) or 256 (K14 at
//     Co > 128, whose tiles reduce only k taps x Ci / 64 steps, 12 at the
//     table shape: 256 columns cut the L2 traffic a product by a quarter
//     against 128, and A is read once where Co <= 256; K13, whose tile
//     count sets how many SMs its one wave of splits fills).
//   * K12, K14 and K15 are one body (fwd_body) over an im2col map of rank
//     4, 3 or 5: K14's over (N, L, C), its base pixels walking (n, ol)
//     across samples and the tap's one offset tw; K15's over (N, D, H, W,
//     C), its base pixels walking (n, od, oh, ow) across planes and
//     samples and the tap's three offsets (tw, th, td); K walks the taps x
//     Ci / 64 panels.
//   * The forward's tile is 128 pixels x BN. Its epilogue stays off the
//     tensor cores' path: each warpgroup writes its 64 rows into 64-column
//     panels in TMA's swizzle (conflict-free bf16x2 stores), one thread
//     stores them by TMA (rows >= M and columns >= Co fall outside the
//     output map and are not written) and the warpgroup goes on to its
//     next tile's products; the staging is reused once the store has read
//     it (128 columns a pass, two passes at BN 256, so 4 stages fit).
//   * K13: a CTA tile is two row blocks (one a warpgroup) x BN, over one
//     split of the pixels (a multiple of 64, so no load crosses into the
//     next split); each split writes an f32 partial and a second pass sums
//     them in split order: the same bits every launch. The splits fill at
//     most one wave of the SMs (ops/conv.py::_dw_plan_sm90).
//   * K12 at Ci < 8, stacked: a pre-pass (conv_stack_taps_kernel) writes
//     xs (N, H2, Wo, Cs), xs[n, r, ow, (i kw + tw) Ci + c] = x[n, r rows +
//     i, ow sw + tw dw, c]: the kw horizontal taps of `rows` input rows
//     (rows = sh where dh is 1, else 1; ops/conv.py::stack_plan) in the
//     channels of one pixel, zeros past rows kw Ci up to Cs, a multiple of
//     8 (a legal TMA row: 48 channels, 96 bytes, at the ImageNet stem,
//     whose two rows of a stride-2 step share a pixel); then the forward
//     body runs the (ceil(kh / rows) x 1) conv of xs at stride (sh / rows,
//     1) and dilation (dh, 1). The horizontal stride and dilation, and a
//     grouped vertical stride, are the pre-pass's: the ImageNet stem's K12
//     walks 4 k steps a tile, not 49 taps or 7 rows. (A k step of
//     ceil(Cs / 16) k16 products in place of 4 measured the same: the
//     step's own cost, not its products, sets the time.) The pre-pass
//     moves bytes only (the stem's x 20.1 MB in, xs 79.1 MB out): a CTA
//     stages the input columns of 64 pixels of xs in shared memory and
//     writes them out as 16-byte chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef long long ll;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;          // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;
constexpr int kRegsProducer = 24, kRegsConsumer = 240;
constexpr uint32_t kPanel = 64 * 128;    // 64 rows of 64 bf16: 8 KB
constexpr int kStep = 64;                // K13: pixels a k step

// A VALID 1-d, 2-d or 3-d conv, channels last (2-d: D = Do = kd = dd =
// 1; 1-d: also H = Ho = kh = dh = 1)
struct Geo {
  int N, D, H, W, Ci, Do, Ho, Wo, Co, kd, kh, kw, sh, sw, dd, dh, dw;
  int P;       // 64-channel panels, ceil(Ci / 64)
  int M;       // output pixels N Do Ho Wo
};

constexpr size_t kSmemMax = 232448;      // a block's shared memory, bytes

template <int BN>
struct FwdCfg {
  static constexpr uint32_t kA = 128 * 128;           // 128 pixels x 64 ch
  static constexpr uint32_t kStage = kA + (BN / 64) * kPanel;
  // the epilogue's staging: each warpgroup's 64 rows, kEpiCols columns a
  // pass (BN, or two passes of 128 at BN 256), as 64-column panels
  static constexpr int kEpiCols = BN < 128 ? BN : 128;
  static constexpr uint32_t kOut = 2 * (kEpiCols / 64) * kPanel;
  // ring of TMA loads: as many stages as fit beside the staging, at most 8
  static constexpr int kFit = (int)((kSmemMax - kOut - 1024 - 16 * 8) /
                                    kStage);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem =
      (size_t)kStages * kStage + kOut + 16 * kStages + 1024;
  static_assert(kSmem <= kSmemMax && kStages >= 4, "shared memory");
};

template <int BN>
struct DwCfg {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr uint32_t kA = 2 * kPanel;          // a row block a wg
  static constexpr uint32_t kStage = kA + (BN / 64) * kPanel;
  static constexpr size_t kSmem =
      (size_t)kStages * kStage + 16 * kStages + 1024;
};

__device__ __forceinline__ void pixel(const Geo& g, int m, int* n, int* od,
                                      int* oh, int* ow) {
  *ow = m % g.Wo;
  int t = m / g.Wo;
  *oh = t % g.Ho;
  t /= g.Ho;
  *od = t % g.Do;
  *n = t / g.Do;
}

// (tap, panel) step or row block j -> its channel origin and tap offsets
__device__ __forceinline__ void tap_of(const Geo& g, int j, int* c0,
                                       uint16_t* ow, uint16_t* oh,
                                       uint16_t* od, int* tap) {
  *tap = j / g.P;
  *c0 = (j - *tap * g.P) * 64;
  const int t = *tap / g.kw, td = t / g.kh;
  *ow = (uint16_t)((*tap - t * g.kw) * g.dw);
  *oh = (uint16_t)((t - td * g.kh) * g.dh);
  *od = (uint16_t)(td * g.dd);
}

template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// ------------------------------------------------------- K12, K14, K15
// RANK 3: x_map is K14's 3-d im2col map; 4: K12's 4-d one; 5: K15's 5-d
// one. o_map: the output (Co, M) as 64 x 64 tiles
template <int BN, int RANK>
__device__ __forceinline__ void fwd_body(const CUtensorMap& x_map,
                                         const CUtensorMap& w_map,
                                         const CUtensorMap& o_map,
                                         const Geo& g) {
  using C = FwdCfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* obuf = smem + kStages * C::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + C::kOut);
  uint64_t* empty = full + kStages;
  const int tiles_n = (g.Co + BN - 1) / BN;
  const int items = (g.M + 127) / 128 * tiles_n;
  const int steps = g.kd * g.kh * g.kw * g.P;
  init_ring<kStages>(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<kRegsProducer>();
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m0 = item / tiles_n * 128, n0 = item % tiles_n * BN;
      int n, od, oh, ow;
      pixel(g, m0, &n, &od, &oh, &ow);
      for (int j = 0; j < steps; ++j, ++it) {
        const int s = it % kStages;
        int c0, tap;
        uint16_t tw, th, td;
        tap_of(g, j, &c0, &tw, &th, &td, &tap);
        unsigned char* st = smem + s * C::kStage;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, C::kStage);
        if constexpr (RANK == 3)
          tma_load_im2col_3d(st, &x_map, full + s, c0, ow, n, tw);
        else if constexpr (RANK == 5)
          tma_load_im2col_5d(st, &x_map, full + s, c0, ow, oh, od, n, tw, th,
                             td);
        else
          tma_load_im2col_4d(st, &x_map, full + s, c0, ow * g.sw, oh * g.sh,
                             n, tw, th);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_3d(st + C::kA + b * kPanel, &w_map, full + s, n0 + 64 * b,
                      c0, tap);
      }
    }
    return;
  }
  // consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile
  regs_inc<kRegsConsumer>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool lead = threadIdx.x % 128 == 0;
  const uint32_t base = smem_u32(smem);
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m0 = item / tiles_n * 128, n0 = item % tiles_n * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < steps; ++j) {
      const int s = (it + j) % kStages;
      mbar_wait(full + s, ((it + j) / kStages) & 1);
      const uint32_t st = base + s * C::kStage;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss<0, 1>(acc, sw128_desc(st + wg * 64 * 128 + 32 * k),
                       sw128_desc_mn(st + C::kA + k * 2048, kPanel),
                       j > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();
      keep(acc);
      if (j > 0) mbar_arrive(empty + (it + j - 1) % kStages);
    }
    wgmma_wait<0>();
    keep(acc);
    mbar_arrive(empty + (it + steps - 1) % kStages);
    it += steps;
    // acc[4 q + 2 x + e]: row 16 warp + lane / 4 + 8 x, column 8 q + 2
    // (lane % 4) + e
    const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
    // this warpgroup's 64 rows, kEpiCols columns a pass, as 64-column
    // panels in TMA's 128-byte swizzle (chunk q of row r at q ^ r % 8:
    // a warp's bf16x2 stores fall on 32 banks); one thread stores them
    constexpr int kCols = C::kEpiCols;
    unsigned char* ob = obuf + wg * (kCols / 64) * kPanel;
#pragma unroll
    for (int h = 0; h < BN / kCols; ++h) {
      if (lead) bulk_wait_read();   // the last store out of ob has read it
      named_sync(1 + wg, 128);
#pragma unroll
      for (int q = 0; q < kCols / 8; ++q)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = r + 8 * x, qq = h * kCols / 8 + q;
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (q / 8) * kPanel + row * 128 +
              (((q % 8) ^ (row % 8)) * 16) + c * 2) =
              __floats2bfloat162_rn(acc[4 * qq + 2 * x],
                                    acc[4 * qq + 2 * x + 1]);
        }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (lead && m0 + 64 * wg < g.M) {
#pragma unroll
        for (int p = 0; p < kCols / 64; ++p)
          if (n0 + h * kCols + 64 * p < g.Co)
            tma_store_2d(&o_map, ob + p * kPanel, n0 + h * kCols + 64 * p,
                         m0 + 64 * wg);
        bulk_commit();
      }
    }
  }
  if (lead) bulk_wait();   // the stores have read shared memory and landed
}

// four entry points over one body, so that a profile tells K12, the
// stacked K12, K14 and K15 apart
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_sm90_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const Geo g) {
  fwd_body<BN, 4>(x_map, w_map, o_map, g);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_sm90_stacked_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                                 const __grid_constant__ CUtensorMap w_map,
                                 const __grid_constant__ CUtensorMap o_map,
                                 const Geo g) {
  fwd_body<BN, 4>(x_map, w_map, o_map, g);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv1d_sm90_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const Geo g) {
  fwd_body<BN, 3>(x_map, w_map, o_map, g);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_sm90_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const Geo g) {
  fwd_body<BN, 5>(x_map, w_map, o_map, g);
}

// ------------------------------------------------------------------ K13
// item = (split, row-block pair, column tile), splits slowest; split sp
// reduces pixels [sp chunk, min(M, (sp + 1) chunk)) into part[sp]
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_sm90_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap g_map,
                        float* __restrict__ part, const Geo g, int splits,
                        int chunk) {
  using C = DwCfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::kStage);
  uint64_t* empty = full + kStages;
  const int blocks = g.kh * g.kw * g.P;            // row blocks of 64
  const int tiles_n = (g.Co + BN - 1) / BN;
  const int tiles = (blocks + 1) / 2 * tiles_n;
  const int items = tiles * splits;
  init_ring<kStages>(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_dec<kRegsProducer>();
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int sp = item / tiles, t = item % tiles;
      const int rb = t / tiles_n * 2, n0 = t % tiles_n * BN;
      const int k0 = sp * chunk, k1 = min(g.M, k0 + chunk);
      int c0[2], tap;
      uint16_t tw[2], th[2], td;
      for (int w = 0; w < 2; ++w)   // a missing second block loads the first
        tap_of(g, min(rb + w, blocks - 1), c0 + w, tw + w, th + w, &td,
               &tap);
      for (int m = k0; m < k1; m += kStep, ++it) {
        const int s = it % kStages;
        int n, od, oh, ow;
        pixel(g, m, &n, &od, &oh, &ow);
        unsigned char* st = smem + s * C::kStage;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, C::kStage);
        for (int w = 0; w < 2; ++w)
          tma_load_im2col_4d(st + w * kPanel, &x_map, full + s, c0[w], ow, oh,
                             n, tw[w], th[w]);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_3d(st + C::kA + b * kPanel, &g_map, full + s, n0 + 64 * b,
                      m, 0);
      }
    }
    return;
  }
  regs_inc<kRegsConsumer>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  const size_t rows = (size_t)g.kh * g.kw * g.Ci;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int sp = item / tiles, t = item % tiles;
    const int rb = t / tiles_n * 2 + wg, n0 = t % tiles_n * BN;
    const int k0 = sp * chunk, k1 = min(g.M, k0 + chunk);
    const int steps = (k1 - k0 + kStep - 1) / kStep;
    const bool mine = rb < blocks;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // a warpgroup without a row block still frees each stage, after its
    // full barrier, so that every stage sees both warpgroups' arrivals
    for (int j = 0; j < steps; ++j) {
      const int s = (it + j) % kStages;
      mbar_wait(full + s, ((it + j) / kStages) & 1);
      if (!mine) {
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t st = base + s * C::kStage;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss<1, 1>(acc, sw128_desc(st + wg * kPanel + k * 2048),
                       sw128_desc_mn(st + C::kA + k * 2048, kPanel),
                       j > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();
      keep(acc);
      if (j > 0) mbar_arrive(empty + (it + j - 1) % kStages);
    }
    if (mine) {
      wgmma_wait<0>();
      keep(acc);
      mbar_arrive(empty + (it + steps - 1) % kStages);
      int c0, tap;
      uint16_t tw, th, td;
      tap_of(g, rb, &c0, &tw, &th, &td, &tap);
      float* dst = part + (size_t)sp * rows * g.Co;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int ch = c0 + warp * 16 + lane / 4 + 8 * x;
        if (ch >= g.Ci) continue;
        float* row = dst + ((size_t)tap * g.Ci + ch) * g.Co;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int col = n0 + 8 * q + 2 * (lane % 4);
          if (col < g.Co)
            *reinterpret_cast<float2*>(row + col) =
                make_float2(acc[4 * q + 2 * x], acc[4 * q + 2 * x + 1]);
        }
      }
    }
    it += steps;
  }
}

// K13's second pass: out[i] = the splits' partials at i, added in split
// order (n4 float4s)
__global__ void conv_sm90_dw_reduce(const float4* __restrict__ ws,
                                    float4* __restrict__ out, ll n4,
                                    int splits) {
  for (ll i = blockIdx.x * (ll)blockDim.x + threadIdx.x; i < n4;
       i += (ll)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = ws[z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// the stacking pre-pass of the stacked K12: xs (N, H2, Wo, Cs) from x (N,
// H, W, Ci). A CTA writes kStackOw pixels of one row (n, r) of xs: it
// stages the input columns they read, from each of `rows` rows, in shared
// memory with coalesced loads (span columns a row), and a table of each
// stacked channel's place in a pixel's window; then each thread writes
// 16-byte chunks of xs from shared memory. A thread a chunk straight from
// device memory spent ~40 instructions an element on its index math.
constexpr int kStackOw = 64;
constexpr int kStackThreads = 128;

__global__ void __launch_bounds__(kStackThreads)
    conv_stack_taps_kernel(const uint16_t* __restrict__ x,
                           uint4* __restrict__ xs, int H, int W, int Ci,
                           int H2, int Wo, int rows, int kw, int sw, int dw,
                           int Cs, int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* off = reinterpret_cast<int*>(smem_raw);  // Cs entries, -1: a zero
  uint16_t* buf = reinterpret_cast<uint16_t*>(smem_raw + 4 * Cs);
  const int blocks_w = (Wo + kStackOw - 1) / kStackOw;
  const int q = blockIdx.x / blocks_w;          // n H2 + r
  const int ow0 = (blockIdx.x - q * blocks_w) * kStackOw;
  const int n = q / H2, r = q - n * H2;
  const int npx = min(kStackOw, Wo - ow0);
  const int run = ((npx - 1) * sw + (kw - 1) * dw + 1) * Ci;
  for (int j = threadIdx.x; j < Cs; j += kStackThreads) {
    const int t = j / Ci, c = j - t * Ci, i = t / kw, tw = t - i * kw;
    off[j] = i < rows ? (i * span + tw * dw) * Ci + c : -1;
  }
  for (int i = 0; i < rows; ++i) {
    const int h = r * rows + i;
    const uint16_t* src = x + (((ll)n * H + h) * W + (ll)ow0 * sw) * Ci;
    for (int k = threadIdx.x; k < run; k += kStackThreads)
      buf[i * span * Ci + k] = h < H ? src[k] : 0;
  }
  __syncthreads();
  const int per = Cs / 8;
  uint4* dst = xs + ((ll)q * Wo + ow0) * per;
  for (int k = threadIdx.x; k < npx * per; k += kStackThreads) {
    const int px = k / per, j0 = (k - px * per) * 8;
    const uint16_t* win = buf + px * sw * Ci;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int o0 = off[j0 + e], o1 = off[j0 + e + 1];
      v[e / 2] = (o0 < 0 ? 0u : win[o0]) |
                 (o1 < 0 ? 0u : (uint32_t)win[o1] << 16);
    }
    dst[k] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// geo: N D H W Ci  Do Ho Wo Co  kd kh kw  sd sh sw  dd dh dw  groups, as
// csrc/conv.cu reads it. Returns false unless the conv is of groups 1,
// every size positive, the channels multiples of 8, every output window
// inside the input, the pixels within int, and by rank: 1-d (rank 3: D,
// H, their outputs and taps 1) of stride 1 with (k - 1) d at most 32768
// (the rank-3 im2col corner range), 2-d (rank 4: D, Do and kd 1) with
// strides at most 8 (TMA's traversal strides) and (k - 1) d at most 128
// (the rank-4 corner range), or 3-d (rank 5) of stride 1 with (k - 1) d at
// most 16 on each axis (the rank-5 corner range).
bool parse(const int* a, Geo& g, int rank) {
  for (int i = 0; i < 19; ++i)
    if (a[i] < 1) return false;
  if (a[18] != 1) return false;
  g = Geo{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10],
          a[11], a[13], a[14], a[15], a[16], a[17], 0, 0};
  const ll corner = rank == 3 ? 32768 : rank == 5 ? 16 : 128;
  if (rank == 3 && (g.D != 1 || g.H != 1 || g.Do != 1 || g.Ho != 1 ||
                    g.kd != 1 || g.kh != 1))
    return false;
  if (rank == 4 && (g.D != 1 || g.Do != 1 || g.kd != 1)) return false;
  if (rank != 4 && (a[12] != 1 || g.sh != 1 || g.sw != 1)) return false;
  if (g.Ci % 8 || g.Co % 8 || g.sh > 8 || g.sw > 8 ||
      (g.kd - 1) * (ll)g.dd > corner || (g.kh - 1) * (ll)g.dh > corner ||
      (g.kw - 1) * (ll)g.dw > corner)
    return false;
  if ((ll)(g.Do - 1) + (ll)g.dd * (g.kd - 1) >= g.D ||
      (ll)(g.Ho - 1) * g.sh + (ll)g.dh * (g.kh - 1) >= g.H ||
      (ll)(g.Wo - 1) * g.sw + (ll)g.dw * (g.kw - 1) >= g.W)
    return false;
  const ll M = (ll)g.N * g.Do * g.Ho * g.Wo;
  if (M > INT32_MAX - 128) return false;
  g.M = (int)M;
  g.P = (g.Ci + 63) / 64;
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// each kernel's shared-memory allowance, set once per device; the SMs
template <auto kernel>
cudaError_t prepare(size_t smem, int* sms) {
  static int known[64];  // SMs of each device prepared so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && known[dev]) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err) err = sm_count(sms);
  if (!err && dev < 64) known[dev] = *sms;
  return err;
}

// the entry point of a rank (only that one is instantiated), or the
// stacked K12's
template <int BN, int RANK, bool STACKED>
constexpr auto fwd_kernel() {
  if constexpr (RANK == 3)
    return conv1d_sm90_fwd_kernel<BN>;
  else if constexpr (RANK == 5)
    return conv3d_sm90_fwd_kernel<BN>;
  else if constexpr (STACKED)
    return conv_sm90_stacked_fwd_kernel<BN>;
  else
    return conv_sm90_fwd_kernel<BN>;
}

template <int BN, int RANK, bool STACKED = false>
cudaError_t fwd(const Geo& g, const bf16* x, const bf16* w, bf16* out,
                cudaStream_t stream) {
  CUtensorMap x_map, w_map, o_map;
  cudaError_t err =
      RANK == 3   ? make_im2col_map_3d(&x_map, x, g.N, g.W, g.Ci, g.kw, g.dw,
                                       64, 128)
      : RANK == 5 ? make_im2col_map_5d(&x_map, x, g.N, g.D, g.H, g.W, g.Ci,
                                       g.kd, g.kh, g.kw, g.dd, g.dh, g.dw, 64,
                                       128)
                  : make_im2col_map(&x_map, x, g.N, g.H, g.W, g.Ci, g.kh,
                                    g.kw, g.dh, g.dw, g.sh, g.sw, 64, 128);
  if (err) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)g.Co, (cuuint64_t)g.Ci,
                              (cuuint64_t)g.kd * g.kh * g.kw};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Co * 2,
                                 (cuuint64_t)g.Co * 2 * g.Ci};
  const cuuint32_t box[3] = {64, 64, 1};
  err = make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, dims, strides,
                 box);
  const cuuint64_t odims[2] = {(cuuint64_t)g.Co, (cuuint64_t)g.M};
  const cuuint64_t ostrides[1] = {(cuuint64_t)g.Co * 2};
  const cuuint32_t obox[2] = {64, 64};
  if (!err)
    err = make_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, odims,
                   ostrides, obox);
  constexpr auto kernel = fwd_kernel<BN, RANK, STACKED>();
  constexpr size_t smem = FwdCfg<BN>::kSmem;
  int sms = 0;
  if (!err) err = prepare<kernel>(smem, &sms);
  if (err) return err;
  const ll items = (ll)((g.M + 127) / 128) * ((g.Co + BN - 1) / BN);
  kernel<<<(int)(items < sms ? items : sms), kThreads, smem, stream>>>(
      x_map, w_map, o_map, g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dw(const Geo& g, const bf16* x, const bf16* gout, float* part,
               int splits, int chunk, cudaStream_t stream) {
  CUtensorMap x_map, g_map;
  cudaError_t err = make_im2col_map(&x_map, x, g.N, g.H, g.W, g.Ci, g.kh,
                                    g.kw, g.dh, g.dw, 1, 1, 64, kStep);
  if (err) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)g.Co, (cuuint64_t)g.M, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Co * 2,
                                 (cuuint64_t)g.Co * 2 * g.M};
  const cuuint32_t box[3] = {64, kStep, 1};
  err = make_map(&g_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, gout, dims,
                 strides, box);
  int sms = 0;
  if (!err) err = prepare<conv_sm90_dw_kernel<BN>>(DwCfg<BN>::kSmem, &sms);
  if (err) return err;
  const ll blocks = (ll)g.kh * g.kw * g.P;
  const ll items = (blocks + 1) / 2 * ((g.Co + BN - 1) / BN) * splits;
  conv_sm90_dw_kernel<BN><<<(int)(items < sms ? items : sms), kThreads,
                            DwCfg<BN>::kSmem, stream>>>(x_map, g_map, part, g,
                                                        splits, chunk);
  return cudaGetLastError();
}

}  // namespace

// K12: x (N, H, W, Ci) * w (kh, kw, Ci, Co) -> out (N, Ho, Wo, Co), all
// contiguous and 16-byte aligned, dtype 1 (bf16: nk_conv2d's signature);
// geo as `parse` reads it.
extern "C" int nk_conv2d_sm90(int dtype, const void* x, const void* w,
                              void* out, const int* geo, void* stream) {
  Geo g;
  if (dtype != 1 || !parse(geo, g, 4) || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return g.Co <= 64 ? fwd<64, 4>(g, xb, wb, ob, s)
                    : fwd<128, 4>(g, xb, wb, ob, s);
}

// the stacked K12's pre-pass: xs (N, H2, Wo, Cs) bf16 from x (N, H, W,
// Ci) bf16, xs[n, r, ow, (i kw + tw) Ci + c] = x[n, r rows + i, ow sw + tw
// dw, c] for i < rows, tw < kw (zero past row H), zeros in channels rows
// kw Ci .. Cs - 1; Cs a multiple of 8 and at least rows kw Ci, every
// window inside the row, xs 16-byte aligned, a CTA's staged columns within
// a block's shared memory. H2 is ops/conv.py::stack_plan's: the rows the
// conv of xs reads and no more (the body's im2col walk takes every row of
// xs as a base row).
extern "C" int nk_conv_stack_taps(const void* x, void* xs, int N, int H,
                                  int W, int Ci, int H2, int Wo, int rows,
                                  int kw, int sw, int dw, int Cs,
                                  void* stream) {
  const ll ctas = (ll)N * H2 * ((Wo + kStackOw - 1) / kStackOw);
  const int span = (kStackOw - 1) * sw + (kw - 1) * dw + 1;
  const size_t smem = 4 * (size_t)Cs + 2 * (size_t)rows * span * Ci;
  if (N < 1 || H < 1 || W < 1 || Ci < 1 || H2 < 1 || Wo < 1 || rows < 1 ||
      kw < 1 || sw < 1 || dw < 1 || Cs < 8 || Cs % 8 ||
      Cs < (ll)rows * kw * Ci ||
      (ll)(Wo - 1) * sw + (ll)(kw - 1) * dw >= W || ctas > INT32_MAX ||
      smem > kSmemMax || !aligned16(xs))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = prepare<conv_stack_taps_kernel>(kSmemMax, &sms);
  if (err) return err;
  conv_stack_taps_kernel<<<(int)ctas, kStackThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint4*>(xs), H, W, Ci, H2,
      Wo, rows, kw, sw, dw, Cs, span);
  return cudaGetLastError();
}

// the stacked K12: the (kq x 1) conv of xs (N, H2, Wo, Cs) by w (kq, 1,
// Cs, Co) -> out (N, Ho, Wo, Co), as nk_conv2d_sm90 with kw, sw and dw 1
// (the pre-pass took them)
extern "C" int nk_conv2d_stacked_sm90(int dtype, const void* x,
                                      const void* w, void* out,
                                      const int* geo, void* stream) {
  Geo g;
  if (dtype != 1 || !parse(geo, g, 4) || g.kw != 1 || g.sw != 1 ||
      g.dw != 1 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return g.Co <= 64 ? fwd<64, 4, true>(g, xb, wb, ob, s)
                    : fwd<128, 4, true>(g, xb, wb, ob, s);
}

// K14: x (N, L, Ci) * w (k, Ci, Co) -> out (N, Lo, Co), stride 1,
// otherwise as nk_conv2d_sm90 (nk_conv1d's signature).
extern "C" int nk_conv1d_sm90(int dtype, const void* x, const void* w,
                              void* out, const int* geo, void* stream) {
  Geo g;
  if (dtype != 1 || !parse(geo, g, 3) || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return g.Co <= 64    ? fwd<64, 3>(g, xb, wb, ob, s)
         : g.Co <= 128 ? fwd<128, 3>(g, xb, wb, ob, s)
                       : fwd<256, 3>(g, xb, wb, ob, s);
}

// K15: x (N, D, H, W, Ci) * w (kd, kh, kw, Ci, Co) -> out (N, Do, Ho, Wo,
// Co), stride 1, otherwise as nk_conv2d_sm90 (nk_conv3d's signature).
extern "C" int nk_conv3d_sm90(int dtype, const void* x, const void* w,
                              void* out, const int* geo, void* stream) {
  Geo g;
  if (dtype != 1 || !parse(geo, g, 5) || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return g.Co <= 64 ? fwd<64, 5>(g, xb, wb, ob, s)
                    : fwd<128, 5>(g, xb, wb, ob, s);
}

// K13: dw (kh, kw, Ci, Co) f32 of the stride-1 conv `geo` from x and the
// output gradient gout (N, Ho, Wo, Co), dtype 1 (bf16: nk_conv_dw's
// signature). The pixels are cut into `splits` ranges of `chunk` (a
// multiple of 64, every range non-empty); with more than one split each
// writes its partial to ws (splits, kh kw Ci, Co) f32 and a second pass
// sums them into out in split order.
extern "C" int nk_conv_dw_sm90(int dtype, const void* x, const void* gout,
                               void* ws, void* out, const int* geo,
                               int splits, int chunk, void* stream) {
  Geo g;
  if (dtype != 1 || !parse(geo, g, 4) || geo[13] != 1 || geo[14] != 1 ||
      splits < 1 || chunk < 1 || chunk % kStep ||
      (ll)(splits - 1) * chunk >= g.M ||
      (ll)splits * chunk < g.M || !aligned16(x) || !aligned16(gout) ||
      !aligned16(out) || (splits > 1 && !aligned16(ws)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(splits > 1 ? ws : out);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gout);
  cudaError_t err =
      g.Co <= 64    ? dw<64>(g, xb, gb, part, splits, chunk, s)
      : g.Co <= 128 ? dw<128>(g, xb, gb, part, splits, chunk, s)
                    : dw<256>(g, xb, gb, part, splits, chunk, s);
  if (err || splits == 1) return err;
  const ll n4 = (ll)g.kh * g.kw * g.Ci * g.Co / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  conv_sm90_dw_reduce<<<blocks, 256, 0, s>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out), n4, splits);
  return cudaGetLastError();
}
