// In-kernel attention dropout, shared by every flash kernel (K1, K2a-d of
// flash_attention_qkv.cu, K5-K7 of flash_attention.cu, and the Hopper walks
// of flash_sm90.cuh).
//
// Replaces attention.py::_tile_keep_mask of the JAX package, which seeds the
// TPU's on-core generator with (seed, b, h, q tile, k tile). Tiles differ
// between the kernels here (64-row mma.sync tiles, 64-row wgmma tiles of a
// 128-row CTA, 32-row inner tiles), so the key is never a tile index: it is
// the absolute position. The keep bit of (b, query head h, row, col) is a
// word of Philox4x32-10 (Salmon et al. 2011, "Parallel random numbers: as
// easy as 1, 2, 3"), keyed by the 64-bit seed, at the counter (col / 2,
// row / 2, h, b): one call covers the 2 x 2 block of (row, col), word
// 2 (row % 2) + col % 2. A thread of the forward and dq accumulators holds
// the column pair (col, col + 1) of a row, one of the transposed dk/dv
// accumulators the row pair (row, row + 1) of a key, so either way one call
// serves two entries. keep <=> word >= threshold, threshold = min(floor(rate
// 2^32), 2^32 - 1) as _tile_keep_mask computes it.
//
// The plain twin, bit for bit, is ops/flash_attention.py::keep_mask (int64
// tensor arithmetic); chip_smoke.py reads each forward kernel's mask back
// and holds it equal to the twin's.
//
// Semantics (attention.py :123-131, :166, :275-280): the softmax statistics
// (m, l, lse) stay unmasked; the forward zeroes the dropped p before P V and
// scales the output by inv_keep = 1 / (1 - rate); the backward takes dp =
// keep ? dp inv_keep : 0 into ds = p (dp - delta) scale, and keep ? p
// inv_keep : 0 into dV. delta = rowsum(dO . O) needs no mask: O carries it.
//
// Cost: a Philox4x32-10 call is 10 rounds of two 32 x 32 -> 64 multiplies
// and a few xors and adds, about 100 integer instructions, 50 for each of
// the two entries it serves, against a handful of float instructions of the
// softmax; the kernels' measured cost is in PERF.md.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32 with 10 rounds on counter c under key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

struct Dropout {
  uint32_t k0, k1;     // the seed's low and high words
  uint32_t threshold;  // an entry is dropped when its word is below this
  float inv_keep;      // 1 / (1 - rate)

  // the words of the 2 x 2 block holding (row, col)
  __device__ __forceinline__ uint4 block(int b, int h, int row,
                                         int col) const {
    return philox4x32_10(make_uint4((uint32_t)col >> 1, (uint32_t)row >> 1,
                                    (uint32_t)h, (uint32_t)b),
                         k0, k1);
  }
  // keep bits of (row, col) and (row, col + 1); col even
  __device__ __forceinline__ void cols2(int b, int h, int row, int col,
                                        bool& k_lo, bool& k_hi) const {
    const uint4 w = block(b, h, row, col);
    k_lo = ((row & 1) ? w.z : w.x) >= threshold;
    k_hi = ((row & 1) ? w.w : w.y) >= threshold;
  }
  // keep bits of (row, col) and (row + 1, col); row even
  __device__ __forceinline__ void rows2(int b, int h, int row, int col,
                                        bool& k_lo, bool& k_hi) const {
    const uint4 w = block(b, h, row, col);
    k_lo = ((col & 1) ? w.y : w.x) >= threshold;
    k_hi = ((col & 1) ? w.w : w.z) >= threshold;
  }
};

}  // namespace
