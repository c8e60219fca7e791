// The Hopper (sm_90a) flash walks, shared by both layouts:
// flash_attention_qkv.cu runs them on the packed qkv projection (K1, K2a,
// K2b, K2c/K2d), flash_attention.cu on (B, H, S, hd) q, k, v (K5, K6, K7).
// Head dims 64 and 128; the forward walk and the dq and dk/dv walks
// without FUSED and CLUSTER also 96 (K5, K6 and K7: see panels below).
// The walks (fwd_walk, dq_walk, kv_walk) are written once; a layout is a
// "tile policy" that says where a tile comes from and where a result goes:
//   kStatsWarp  false when the rows' (lse, delta) arrive by bulk copy with
//             the stage's tiles (a pre-pass wrote them as float2 rows), true
//             when a stats warp of the producer warpgroup loads them from
//             two f32 arrays with plain loads (no alignment rule on Sq);
//   kRegsProducer, kRegsConsumer: setmaxnreg's split of the CTA's 384 x
//             168 registers (128 p + 256 c = 64512);
//   kClamp    p = exp2(min(s - lse, 0)) (the split kernels: a foreign lse,
//             as ring attention feeds, must not overflow) or exp2(s - lse);
//   kFast     the forward may run K1's fast softmax (m = 0);
//   band      the causal / window / Sq != Skv band (struct Band);
//   H, G, KV  q heads, q heads per k/v head, k/v heads;
//   q_tile<ROWS>(dst, bar, b, h, row), do_tile: ROWS x HD of q / dO of
//             head h by TMA (rows past Sq zero-filled); k_tile(dst, bar, b,
//             g, row), v_tile: of k/v head g;
//   stats_tx(b, h, row0, n): bytes of the rows' (lse, delta) that arrive
//             by copy; stats(dst, bar, b, h, row0, n, lane): float2 (lse,
//             delta) of q rows row0 .. row0 + n - 1 into shared memory, 0
//             past Sq;
//   store_o(b, h, row, col, lo, hi), store_lse(b, h, row, v): the
//             forward's bf16 output pair and a row's base-2 lse;
//   store_dq(b, h, row, col, lo, hi), store_dkv(b, g, row, col, dk0, dk1,
//             dv0, dv1): a bf16 pair of an output row.
//
// A CTA is two consumer warpgroups (256 threads, 64 rows each) and one
// producer warpgroup: one thread of its first warp keeps TMA loads in
// flight through mbarrier rings, its second warp is K2c's dq writer, its
// third the stats warp where the policy has one; the rest exit at once.
// setmaxnreg moves registers from the producer to the consumers. Every
// product is a wgmma; the scores stay in the accumulator registers, and P
// and dS are rounded to bf16 there, as the TPU kernels round them, into
// the A fragments of the next wgmma.
//
// Every walk takes a DROPOUT flag: set, each computed tile draws its keep
// bits from dropout.cuh (interior tiles too: the mask-free fast path of the
// band does not skip them); the forward zeroes the dropped p before P V
// and scales the output by 1 / (1 - rate), the dq walk takes dp = keep ? dp
// inv_keep : 0 before dS, and the dk/dv walk feeds keep ? p inv_keep : 0
// to dV; unset, the code is that of no dropout.

#pragma once

#include "dropout.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;
constexpr int kHopperThreads = kConsumers + 128;
constexpr int kStages = 2;
// setmaxnreg moves registers only within the CTA's launch allotment (384
// threads x 168): the producer warpgroup gives up 144 a thread, which the
// consumers take (128 x 24 + 256 x 240 = 384 x 168); a tile policy may
// shift that split (128 x 40 + 256 x 232)
constexpr int kBM = 128;   // K1/K5: q rows per CTA
constexpr int kBN = 128;   // K1/K5: k rows per tile; K2b/K7: k rows per CTA
constexpr int kBQh = 64;   // K2b/K7: q rows per step of the walk
constexpr int kBKd = 64;     // K2a/K6: k rows per step of the walk
constexpr int kDqStages = 3;  // K2a/K6: depth of the K/V ring

// The band of keys each query sees: causal keeps col <= row (Sq == Skv), a
// window > 0 (causal only) also drops col <= row - window; rows past Sq and
// columns past Skv are outside
struct Band {
  int Sq, Skv, causal, window;

  // key (row i, col j) is masked out (rows past Sq not included)
  __device__ bool masked(int i, int j) const {
    return j >= Skv ||
           (causal && (j > i || (window > 0 && i - j >= window)));
  }
  // the keys of row i in the band, [*lo, *hi) (none past Sq)
  __device__ void keys(int i, int* lo, int* hi) const {
    *lo = causal && window > 0 ? max(0, i - window + 1) : 0;
    *hi = i >= Sq ? 0 : causal ? min(i + 1, Skv) : Skv;
  }
  // the rows of key j in the band, [*lo, *hi) (none past Skv)
  __device__ void rows(int j, int* lo, int* hi) const {
    *lo = causal ? j : 0;
    *hi = j >= Skv ? 0 : causal && window > 0 ? min(j + window, Sq) : Sq;
  }
  // the rectangle rows [i0, i0 + ni) x cols [j0, j0 + nj) needs the mask
  __device__ bool edge(int i0, int ni, int j0, int nj) const {
    return j0 + nj > Skv || i0 + ni > Sq ||
           (causal && (j0 + nj - 1 > i0 ||
                       (window > 0 && i0 + ni - 1 - j0 >= window)));
  }
  // the rectangle holds no key of the band
  __device__ bool none(int i0, int ni, int j0, int nj) const {
    return i0 >= Sq || j0 >= Skv ||
           (causal && (j0 > i0 + ni - 1 ||
                       (window > 0 && i0 - (j0 + nj - 1) >= window)));
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

// bytes of a rows x 64 bf16 panel (one 128-byte swizzled row each)
__host__ __device__ constexpr uint32_t panel_bytes(int rows) {
  return (uint32_t)rows * 128;
}

// K-major descriptor of the k16 slice k of a tile whose panels hold ROWS
// rows, starting `row_off` rows in
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int row_off,
                                           int k) {
  return sw128_desc(base + (k / 4) * panel_bytes(ROWS) +
                    panel_bytes(row_off) + (k % 4) * 32);
}

// MN-major descriptor of the k16 slice k (rows 16 k ..) of panel p
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int p, int k) {
  return sw128_desc(base + p * panel_bytes(ROWS) + k * panel_bytes(16));
}

// The head dim in panels: 64 columns each, the last one HD % 64 wide where
// HD is not a multiple of 64 (hd 96: 64 + 32). The forward, dq and dk/dv
// walks take HD 64, 96 and 128 (FUSED and CLUSTER 64 and 128 only; the
// packed layout's dispatch takes 64 and 128). K-major products loop over
// HD / 16 slices, so none reads the zero columns of a narrow panel;
// MN-major products into the head dim run one wgmma a panel at its width,
// an accumulator's narrow panel in the first panel_cols / 2 of its 32
// entries.
__host__ __device__ constexpr int panels(int hd) { return (hd + 63) / 64; }

template <int HD>
__host__ __device__ constexpr int panel_cols(int p) {
  return HD - 64 * p < 64 ? HD - 64 * p : 64;
}

// d (64 rows x panel p's columns) += A (64 x 16, registers) . B (16 rows x
// panel p's columns, MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_panel(float (&d)[32], int p,
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(HD % 64 == 0 || HD % 64 == 32, "panels of 64 or 32 columns");
  if (panel_cols<HD>(p) == 64)
    wgmma_rs<1>(d, a, db);
  else
    wgmma_rs<1>(reinterpret_cast<float(&)[16]>(d), a, db);
}

// keep() of the entries of panel p that its products write
template <int HD>
__device__ __forceinline__ void keep_panel(float (&d)[32], int p) {
  if (panel_cols<HD>(p) == 64)
    keep(d);
  else
    keep(reinterpret_cast<float(&)[16]>(d));
}

// the A fragments of an accumulator's 16-column slices, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&d)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[k][q] = pack_bf16(d[8 * k + 2 * q], d[8 * k + 2 * q + 1]);
}

// the producer warpgroup's warps: the TMA thread's, K2c's dq writer, the
// stats warp; a stage holding q rows completes with the TMA thread's
// arrival and its bytes, and with the stats warp's 32 arrivals if any
constexpr int kTmaWarp = 0, kWriterWarp = 1, kStatsWarpId = 2;

template <class Tiles>
__host__ __device__ constexpr int q_stage_arrivals() {
  return Tiles::kStatsWarp ? 33 : 1;
}

// p of a score e = s scale log2(e) - lse (masked: 0)
template <bool CLAMP>
__device__ __forceinline__ float band_p(bool out, float e) {
  return out ? 0.f : exp2f(CLAMP ? fminf(e, 0.f) : e);
}

template <int HD>
struct FwdSmem {
  static constexpr int P = panels(HD);
  static constexpr uint32_t kQ = P * panel_bytes(kBM);
  static constexpr uint32_t kKV = P * panel_bytes(kBN);
  static constexpr uint32_t kOffK = kQ;
  static constexpr uint32_t kOffV = kOffK + kStages * kKV;
  static constexpr uint32_t kOffBar = kOffV + kStages * kKV;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 3 * kStages) + 1024;
};

// ---------------------------------------------------- the forward (K1, K5)
// One CTA: q rows i0 .. i0 + 127 of head h, batch b; consumer warpgroup w
// owns q rows i0 + 64 w .. + 63. The producer loads Q once and K, V
// through a ring of kStages 128-row stages over the k tiles of the band
// (Band::k_tiles), K and V on separate barriers so that S starts before V
// has landed. Per k tile: S = Q K^T (wgmma, both operands K-major from the
// TMA tiles), the online softmax on the accumulator registers (exp2
// domain), P rounded to bf16 into A fragments, O += P V (wgmma, A from
// registers, V MN-major; at hd 96 m64n64k16 into panel 0 and m64n32k16
// into panel 1, whose O is the first 16 entries of o[1], the only ones
// rescaled and stored). Only edge tiles (Band::edge) evaluate the mask,
// from each row's key interval [lo, hi); a masked score is the finite
// kNegInf, so a row whose first tile holds none of its keys sums p = 1
// there, and alpha = 0 wipes that on its first real key (with -inf it
// would be NaN). A warpgroup whose 64 rows meet no key of a tile waits
// for the tile and frees it, as dq_walk does. `fast` keeps m = 0 (no
// running max, no rescale); it exists only where Tiles::kFast is set
// (K1's fast softmax), so K5's code has no such branch.
template <int HD, bool DROPOUT, class Tiles>
__device__ __forceinline__ void fwd_walk(const Tiles& t, unsigned char* smem,
                                         int h, int b, int i0, float qscale,
                                         bool fast_arg, const Dropout& drop) {
  using Sm = FwdSmem<HD>;
  constexpr int P = Sm::P;
  const bool fast = Tiles::kFast && fast_arg;
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + Sm::kOffK;
  unsigned char* Vs = smem + Sm::kOffV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  const Band& band = t.band;
  int kt0, kt1;
  band.k_tiles(i0, kBM, kBN, &kt0, &kt1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<Tiles::kRegsProducer>();
    if (threadIdx.x == kConsumers) {
      const int g = h / t.G;
      mbar_expect_tx(q_full, Sm::kQ);
      t.template q_tile<kBM>(Qs, q_full, b, h, i0);
      for (int kt = kt0; kt < kt1; ++kt) {
        const int n = kt - kt0, s = n % kStages;
        mbar_wait(empty + s, ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + s, Sm::kKV);
        t.template k_tile<kBN>(Ks + s * Sm::kKV, k_full + s, b, g, kt * kBN);
        mbar_expect_tx(v_full + s, Sm::kKV);
        t.template v_tile<kBN>(Vs + s * Sm::kKV, v_full + s, b, g, kt * kBN);
      }
    }
  } else {  // consumer warpgroups
    regs_inc<Tiles::kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int c = (lane & 3) * 2;
    const int r0 = i0 + wg * 64;  // this warpgroup's first row
    const int row[2] = {r0 + warp * 16 + (lane >> 2),
                        r0 + warp * 16 + (lane >> 2) + 8};
    // the keys of each row's band, [lo, hi), fixed for the whole walk
    int lo[2], hi[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) band.keys(row[x], &lo[x], &hi[x]);
    float m[2] = {fast ? 0.f : kNegInf, fast ? 0.f : kNegInf};
    float l[2] = {0.f, 0.f};
    float o[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs);
    mbar_wait(q_full, 0);

    for (int kt = kt0; kt < kt1; ++kt) {
      const int n = kt - kt0;
      const int s = n % kStages, ph = (n / kStages) & 1;
      const int j0 = kt * kBN;
      if (band.none(r0, 64, j0, kBN)) {  // wait, so that this arrival
        mbar_wait(k_full + s, ph);       // counts for this tile's round
        mbar_wait(v_full + s, ph);
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t k_addr = smem_u32(Ks + s * Sm::kKV);
      const uint32_t v_addr = smem_u32(Vs + s * Sm::kKV);
      float sc[kBN / 2];
      mbar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor<kBM>(q_addr, wg * 64, k),
                       kmajor<kBN>(k_addr, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);

      // accumulator entry i: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
      // column j0 + 8 (i / 4) + c + i % 2
      const bool edge = band.edge(r0, 64, j0, kBN);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int x = (i >> 1) & 1;
        const int col = j0 + 8 * (i / 4) + c + (i & 1);
        float v = sc[i] * qscale;
        if (edge && (col < lo[x] || col >= hi[x])) v = kNegInf;
        sc[i] = v;
        mx[x] = fmaxf(mx[x], v);
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
      for (int i = 0; i < kBN / 2; ++i) {
        const int x = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m_new[x]);
        sum[x] += sc[i];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l[x] = l[x] * alpha[x] + quad_sum(sum[x]);
        m[x] = m_new[x];
      }
      if constexpr (DROPOUT) {  // every tile, after l: zero the dropped p
#pragma unroll
        for (int i = 0; i < kBN / 2; i += 2) {
          bool k0, k1;
          drop.cols2(b, h, row[(i >> 1) & 1], j0 + 8 * (i / 4) + c, k0, k1);
          if (!k0) sc[i] = 0.f;
          if (!k1) sc[i + 1] = 0.f;
        }
      }
      if (!fast) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (i < panel_cols<HD>(p) / 2) o[p][i] *= alpha[(i >> 1) & 1];
      }
      uint32_t pa[kBN / 16][4];
      to_a_frags<kBN>(pa, sc);

      mbar_wait(v_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBN / 16; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
          wgmma_panel<HD>(o[p], p, pa[k], mnmajor<kBN>(v_addr, p, k));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) keep_panel<HD>(o[p], p);
      keep(pa);
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= band.Sq) continue;
      const float inv = (DROPOUT ? drop.inv_keep : 1.f) / l[x];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < panel_cols<HD>(p))
            t.store_o(b, h, row[x], 64 * p + 8 * j + c,
                      o[p][4 * j + 2 * x] * inv,
                      o[p][4 * j + 2 * x + 1] * inv);
      if ((lane & 3) == 0) t.store_lse(b, h, row[x], m[x] + log2f(l[x]));
    }
  }
}

template <int HD>
struct DqSmem {
  static constexpr int P = panels(HD);
  static constexpr uint32_t kQ = P * panel_bytes(kBM);
  static constexpr uint32_t kKV = P * panel_bytes(kBKd);
  static constexpr uint32_t kOffDO = kQ;
  static constexpr uint32_t kOffK = 2 * kQ;
  static constexpr uint32_t kOffV = kOffK + kDqStages * kKV;
  static constexpr uint32_t kOffStats = kOffV + kDqStages * kKV;
  static constexpr uint32_t kOffBar = kOffStats + kBM * 8;
  static constexpr size_t kBytes = kOffBar + 8 * (1 + 2 * kDqStages) + 1024;
};

// ------------------------------------------------ the dq walk (K2a, K6)
// One CTA: q rows i0 .. i0 + 127 of head h, batch b. Consumer warpgroup w
// owns q rows i0 + 64 w .. + 63 and keeps their dQ (64 x HD f32) in
// registers for the whole walk: the CTA owns its dq rows, so there is
// nothing to add across CTAs and the result is the same bits every run.
// The producer loads Q, dO and the rows' (lse, delta) once and K, V
// through a ring of kDqStages 64-row stages, over the k tiles of the band
// only. Per k tile: S = Q K^T and dP = dO V^T (wgmma, all four operands
// K-major from the TMA tiles), p = exp2(S scale log2e - lse) and dS = p (dP
// - delta) scale on the accumulator registers, rounded to bf16 into A
// fragments as the TPU kernels round ds, then dQ += dS K (wgmma, A from
// registers, K MN-major). 64-row k tiles keep S, dP and dQ (32 + 32 +
// HD / 2 f32 a thread) within the consumers' 232-240 registers. A
// warpgroup whose 64 rows miss a tile of the walk (above its diagonal,
// below its window, past Sq) only waits for the tile and frees it;
// interior tiles skip the mask.
template <int HD, bool DROPOUT, class Tiles>
__device__ __forceinline__ void dq_walk(const Tiles& t, unsigned char* smem,
                                        int h, int b, int i0, float scale,
                                        float qscale, const Dropout& drop) {
  using Sm = DqSmem<HD>;
  constexpr int P = Sm::P;
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + Sm::kOffDO;
  unsigned char* Ks = smem + Sm::kOffK;
  unsigned char* Vs = smem + Sm::kOffV;
  float2* stats_s = reinterpret_cast<float2*>(smem + Sm::kOffStats);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;
  const Band& band = t.band;
  int kt0, kt1;
  band.k_tiles(i0, kBM, kBKd, &kt0, &kt1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, q_stage_arrivals<Tiles>());
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<Tiles::kRegsProducer>();
    const int pw = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (pw == kTmaWarp && lane == 0) {
      mbar_expect_tx(q_full, 2 * Sm::kQ + t.stats_tx(b, h, i0, kBM));
      t.template q_tile<kBM>(Qs, q_full, b, h, i0);
      t.template do_tile<kBM>(dOs, q_full, b, h, i0);
      if constexpr (!Tiles::kStatsWarp)
        t.stats(stats_s, q_full, b, h, i0, kBM, 0);
      const int g = h / t.G;
      for (int kt = kt0; kt < kt1; ++kt) {
        const int n = kt - kt0, s = n % kDqStages;
        mbar_wait(empty + s, ((n / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * Sm::kKV);
        t.template k_tile<kBKd>(Ks + s * Sm::kKV, full + s, b, g, kt * kBKd);
        t.template v_tile<kBKd>(Vs + s * Sm::kKV, full + s, b, g, kt * kBKd);
      }
    } else if (Tiles::kStatsWarp && pw == kStatsWarpId) {
      t.stats(stats_s, q_full, b, h, i0, kBM, lane);
      mbar_arrive(q_full);
    }
  } else {  // consumer warpgroups
    regs_inc<Tiles::kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int c = (lane & 3) * 2;
    const int lrow = wg * 64 + warp * 16 + (lane >> 2);
    const int row[2] = {i0 + lrow, i0 + lrow + 8};
    const int r0 = i0 + wg * 64;  // this warpgroup's first row
    float dq[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs), do_addr = smem_u32(dOs);
    mbar_wait(q_full, 0);
    // rows past Sq may not have been loaded: (0, 0) keeps their terms 0;
    // the keys of each row's band, [lo, hi), fixed for the whole walk
    float2 st[2];
    int lo[2], hi[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      st[x] = row[x] < band.Sq ? stats_s[lrow + 8 * x]
                               : make_float2(0.f, 0.f);
      band.keys(row[x], &lo[x], &hi[x]);
    }

    for (int kt = kt0; kt < kt1; ++kt) {
      const int n = kt - kt0;
      const int s = n % kDqStages, ph = (n / kDqStages) & 1;
      const int j0 = kt * kBKd;
      if (band.none(r0, 64, j0, kBKd)) {  // wait, so that this arrival
        mbar_wait(full + s, ph);          // counts for this tile's round
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t k_addr = smem_u32(Ks + s * Sm::kKV);
      const uint32_t v_addr = smem_u32(Vs + s * Sm::kKV);
      float sc[32], dp[32];
      mbar_wait(full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(sc, kmajor<kBM>(q_addr, wg * 64, k),
                       kmajor<kBKd>(k_addr, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wgmma_ss<0, 0>(dp, kmajor<kBM>(do_addr, wg * 64, k),
                       kmajor<kBKd>(v_addr, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);
      keep(dp);

      // accumulator entry i: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
      // column 8 (i / 4) + c + i % 2
      const bool edge = band.edge(r0, 64, j0, kBKd);
      bool kp[2];  // DROPOUT: keep bits of the column pair of entries i, i+1
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1;
        const int col = j0 + 8 * (i / 4) + c + (i & 1);
        const float p = band_p<Tiles::kClamp>(
            edge && (col < lo[x] || col >= hi[x]), sc[i] * qscale - st[x].x);
        float d = dp[i];
        if constexpr (DROPOUT) {
          if ((i & 1) == 0) drop.cols2(b, h, row[x], col, kp[0], kp[1]);
          d = kp[i & 1] ? d * drop.inv_keep : 0.f;
        }
        sc[i] = p * (d - st[x].y) * scale;
      }
      uint32_t ds[kBKd / 16][4];
      to_a_frags<kBKd>(ds, sc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBKd / 16; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p)
          wgmma_panel<HD>(dq[p], p, ds[k], mnmajor<kBKd>(k_addr, p, k));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) keep_panel<HD>(dq[p], p);
      keep(ds);
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= band.Sq) continue;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < panel_cols<HD>(p))
            t.store_dq(b, h, row[x], 64 * p + 8 * j + c,
                       dq[p][4 * j + 2 * x], dq[p][4 * j + 2 * x + 1]);
    }
  }
}

template <int HD, bool FUSED, bool CLUSTER = false>
struct KvSmem {
  // FUSED's dQ = dS K and CLUSTER's stage take whole 64-column panels
  static_assert(HD % 64 == 0 || !(FUSED || CLUSTER), "hd 96: kv_walk only");
  static constexpr int P = panels(HD);
  static constexpr int LDQ = HD + 8;  // f32 dq rows, padded against conflicts
  static constexpr uint32_t kKV = P * panel_bytes(kBN);
  static constexpr uint32_t kQ = P * panel_bytes(kBQh);
  static constexpr uint32_t kOffV = kKV;
  static constexpr uint32_t kOffQ = 2 * kKV;
  static constexpr uint32_t kOffDO = kOffQ + kStages * kQ;
  static constexpr uint32_t kOffDS = kOffDO + kStages * kQ;
  static constexpr uint32_t kOffStats =
      kOffDS + (FUSED ? panel_bytes(kBN) : 0);
  static constexpr uint32_t kOffDQ = kOffStats + kStages * kBQh * 8;
  static constexpr uint32_t kDQ = FUSED ? 2 * kBQh * LDQ * 4 : 0;
  // CLUSTER: one f32 partial (dK or dV) of the CTA's kBN k rows; FUSED
  // and CLUSTER: in the two dq buffers, which are larger (kv_walk)
  static constexpr uint32_t kStage = CLUSTER ? kBN * HD * 4 : 0;
  static_assert(!(FUSED && CLUSTER) || kStage <= kDQ, "stage past dq");
  static constexpr uint32_t kOffStage = kOffDQ;
  static constexpr uint32_t kOffBar =
      kOffDQ + (kStage > kDQ ? kStage : kDQ);
  static constexpr size_t kBytes =
      kOffBar + 8 * (6 + 2 * kStages + (CLUSTER ? 3 : 0)) + 1024;
};

// One item of the dk/dv walk: k tile kt (128 k rows) of k/v head g, batch
// b, and the q tiles [qt0, qt1) of its band. FUSED takes the items (b,
// g)-major, the others kt-major (the longest causal walks first).
struct KvItem {
  int kt, b, g, qt0, qt1;

  template <bool FUSED, class Tiles>
  __device__ __forceinline__ static KvItem of(const Tiles& t, int item,
                                              int n_kt) {
    KvItem it;
    it.kt = FUSED ? item % n_kt : item / (t.B * t.KV);
    const int bg = FUSED ? item / n_kt : item % (t.B * t.KV);
    it.b = bg / t.KV;
    it.g = bg % t.KV;
    t.band.q_tiles(it.kt * kBN, kBN, kBQh, &it.qt0, &it.qt1);
    return it;
  }
  // the qq-th q tile of the walk: FUSED walks down from the last
  template <bool FUSED>
  __device__ __forceinline__ int qt(int qq) const {
    return FUSED ? qt1 - 1 - qq : qt0 + qq;
  }
};

// -------------------------- the dk/dv walk (K2b, K7) and the fused K2c
// A persistent grid (at most one CTA an SM) walks the items, item i on CTA
// i % grid. Consumer warpgroup w owns k rows j0 + 64 w .. + 63 with dK and
// dV in registers; for each of the group's G q heads the walk takes 64-row
// q tiles over the band: S^T = K Q^T and dP^T = V dO^T (wgmma from shared
// memory), P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - delta) scale on
// the registers, rounded to bf16 into A fragments; dV += P^T dO and dK +=
// dS^T Q (wgmma, A from registers, dO and Q MN-major). Without FUSED a
// warpgroup whose 64 keys miss a q tile (its diagonal's first tile, below
// its window) only waits for the tile and frees it.
// FUSED (packed layout only) stages dS^T in shared memory (swizzled),
// computes dQ = dS K (warpgroup w: columns 64 w ..) and stages it as f32 in
// one of two buffers. A writer warp of the producer warpgroup adds each
// staged tile into the f32 dq scratch, one bulk copy a tile, in k-tile
// order: the CTA of k tile kt waits until the turn counter of (b, h, q
// tile) reads kt, stores (kt = 0) or reduce-adds the tile and, once it has
// landed, passes the turn on. The consumers only wait for a free buffer,
// so the chain of turns runs beside the products. FUSED takes the items
// (b, g)-major and walks q from the last tile down: k tile kt then trails
// kt - 1 by one q tile, and the few (b, g) in flight keep their scratch in
// L2. No deadlock: an item waits only on the item before it (same b, g, k
// tile kt - 1), and each CTA takes its items in order, so the lowest
// unfinished item can always run.
// CLUSTER (the packed layout past 8 q heads a kv head: K2b, and with FUSED
// the fused K2) runs an item on a cluster of C CTAs, launched as a
// persistent grid of whole clusters: CTA r walks the group's heads [r G /
// C, (r + 1) G / C), each for the item's q tiles. Rank 0 loads the item's
// K and V once, by TMA multicast into every CTA of the cluster, when all C
// have freed their buffers and announced the bytes (kv_free). After its
// walk each CTA but rank 0 stages its partial dK as f32 in its own shared
// memory (kStage: a consumer thread's 16-byte chunk j at 16 (256 j + t)
// bytes, so that a warp's reads are contiguous) and arrives on rank 0's
// red_full; rank 0 adds ranks 1 .. C - 1 into its registers in rank order
// over distributed shared memory, then frees each stage (red_free); then
// the same for dV, and rank 0 stores. The sum has a fixed order and no
// atomics: the same bits every launch. Each CTA waits for rank 0 to have
// read its stage before it moves on or exits, and rank 0 waits for every
// arrival on its barriers, so no CTA's shared memory is touched after it
// exits.
// FUSED and CLUSTER together: each CTA computes dQ for its own heads and
// its writer warp keeps the turn chain of those (b, h, q tile)s as above;
// the turns and the dq scratch are those of the one-CTA walk. Three
// changes:
//   * the stage lies in the two dq buffers. At hd 128 the one-CTA fused
//     walk already holds ~213 KB (K, V 64; the Q and dO rings 64; dS^T 16;
//     dq 68), so a separate 64 KB stage would pass the 227 KB cap; halves
//     (32 KB) would too. Aliasing the Q/dO ring would stop the producer
//     from loading the next item's first tiles during the reduction, while
//     the dq buffers are idle then anyway: at the end of an item the
//     writer finishes its last tile at once (waits for its bulk add and
//     passes the turn) instead of when the next tile is staged, and every
//     rank but 0 waits for both buffers to be free before it stages.
//   * the walk is q-tile-major: every head of the CTA's share at q tile
//     qt, then at qt - 1. Head-major, item kt - 1 walks two more q tiles a
//     head than item kt (causal), so at each head it falls further behind
//     and the chain holds every item of a (b, g) until its k tile 0 has
//     reached the last head. Q-tile-major, (head, q tile) is the same step
//     of every item's walk, and item kt trails item kt - 1 by about one
//     step, then ends when its own walk does.
//   * the clusters take the rows of `stride` items forth and back: item n
//     stride + x on cluster x for even n, on cluster stride - 1 - x for
//     odd n. Under a causal mask the items of a (b, g) run from 2 n_kt q
//     tiles a head (kt 0) down to 2; dealt round robin, the cluster that
//     draws k tile 0 of one (b, g) tends to draw it of the next, and sums
//     twice the mean walk; dealt forth and back, the long walks of one row
//     meet the short of the next.
// No deadlock, clusters included: an item's rank r waits only on rank r
// of the item before it (same b, g, k tile kt - 1: a lower index); rank
// 0's kv_free waits for the cluster's own previous item, and the
// reduction for the ranks of the same item; every cluster of the grid is
// resident (sized by occupancy) and takes its items in increasing order
// (forth and back keeps that: row n + 1's items all lie above row n's).
// So the lowest unfinished item can always run.
template <int HD, bool FUSED, bool DROPOUT, class Tiles, bool CLUSTER = false>
__device__ __forceinline__ void kv_walk(const Tiles& t, unsigned char* smem,
                                        float* __restrict__ dq_acc,
                                        int* __restrict__ dq_turn,
                                        float scale, float qscale,
                                        const Dropout& drop) {
  using Sm = KvSmem<HD, FUSED, CLUSTER>;
  // FUSED and CLUSTER: the walk q-tile-major, the items dealt forth and
  // back (above)
  constexpr bool kQMajor = FUSED && CLUSTER;
  constexpr int P = Sm::P;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Sm::kOffV;
  unsigned char* Qs = smem + Sm::kOffQ;
  unsigned char* dOs = smem + Sm::kOffDO;
  unsigned char* dSt = smem + Sm::kOffDS;
  float2* stats_s = reinterpret_cast<float2*>(smem + Sm::kOffStats);
  float* dq_s = reinterpret_cast<float*>(smem + Sm::kOffDQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Sm::kOffBar);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;  // FUSED: the two dq buffers
  uint64_t* dq_empty = dq_full + 2;
  // CLUSTER: rank 0's kv_free (C arrivals) and red_full (C - 1), every
  // other rank's red_free (1)
  uint64_t* kv_free = dq_empty + 2;
  uint64_t* red_full = kv_free + 1;
  uint64_t* red_free = red_full + 1;
  float4* stage = reinterpret_cast<float4*>(smem + Sm::kOffStage);

  const Band& band = t.band;
  const int G = t.G;
  const int n_kt = (band.Skv + kBN - 1) / kBN;
  const int n_qt = (band.Sq + kBQh - 1) / kBQh;
  const int n_items = n_kt * t.B * t.KV;
  // the cluster (1 CTA without CLUSTER): size, this CTA's rank, its first
  // item and the items' stride, its heads of the group [m0, m1)
  const int C = CLUSTER ? (int)cluster_size() : 1;
  const int rank = CLUSTER ? (int)cluster_rank() : 0;
  const int first = blockIdx.x / C, stride = gridDim.x / C;
  const int m0 = rank * G / C, m1 = (rank + 1) * G / C;
  // the cluster's n-th item (n_items or more past its last)
  auto item_at = [&](int n) {
    return n * stride + (kQMajor && (n & 1) ? stride - 1 - first : first);
  };
  // a walk of n_q q tiles a head takes (m1 - m0) n_q steps, `so` outer
  // and `si` inner: the head m0 + si and the q tile so (kQMajor), else the
  // head m0 + so and the q tile si
  auto outer = [&](int n_q) { return kQMajor ? n_q : m1 - m0; };
  auto inner = [&](int n_q) { return kQMajor ? m1 - m0 : n_q; };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, q_stage_arrivals<Tiles>());
      mbar_init(empty + s, kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(dq_full + s, kConsumers);
      mbar_init(dq_empty + s, 1);
    }
    if constexpr (CLUSTER) {
      mbar_init(kv_free, C);
      mbar_init(red_full, C - 1);
      mbar_init(red_free, 1);
    }
    mbar_fence_init();
  }
  // CLUSTER: every CTA's barriers ready before any arrives from afar
  if constexpr (CLUSTER)
    cluster_sync_all();
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup
    regs_dec<Tiles::kRegsProducer>();
    const int pw = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (pw == kTmaWarp && lane == 0) {
      int it = 0;
      for (int n = 0, item = first; item < n_items; item = item_at(++n)) {
        const KvItem w = KvItem::of<FUSED>(t, item, n_kt);
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * Sm::kKV);
        if constexpr (CLUSTER) {
          mbar_arrive_cluster(map_rank(kv_free, 0));
          if (rank == 0) {
            mbar_wait_cluster(kv_free, n & 1);
            const uint16_t all = (uint16_t)((1u << C) - 1);
            t.template k_tile<kBN>(Ks, kv_full, w.b, w.g, w.kt * kBN, all);
            t.template v_tile<kBN>(Vs, kv_full, w.b, w.g, w.kt * kBN, all);
          }
        } else {
          t.template k_tile<kBN>(Ks, kv_full, w.b, w.g, w.kt * kBN);
          t.template v_tile<kBN>(Vs, kv_full, w.b, w.g, w.kt * kBN);
        }
        const int n_q = w.qt1 - w.qt0;
        for (int so = 0; so < outer(n_q); ++so) {
          for (int si = 0; si < inner(n_q); ++si, ++it) {
            const int h = w.g * G + m0 + (kQMajor ? si : so);
            const int s = it % kStages;
            const int i0 = w.qt<FUSED>(kQMajor ? so : si) * kBQh;
            mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full + s,
                           2 * Sm::kQ + t.stats_tx(w.b, h, i0, kBQh));
            t.template q_tile<kBQh>(Qs + s * Sm::kQ, full + s, w.b, h, i0);
            t.template do_tile<kBQh>(dOs + s * Sm::kQ, full + s, w.b, h, i0);
            if constexpr (!Tiles::kStatsWarp)
              t.stats(stats_s + s * kBQh, full + s, w.b, h, i0, kBQh, 0);
          }
        }
      }
    } else if (Tiles::kStatsWarp && pw == kStatsWarpId) {
      int it = 0;
      for (int n = 0, item = first; item < n_items; item = item_at(++n)) {
        const KvItem w = KvItem::of<FUSED>(t, item, n_kt);
        const int n_q = w.qt1 - w.qt0;
        for (int so = 0; so < outer(n_q); ++so) {
          for (int si = 0; si < inner(n_q); ++si, ++it) {
            const int h = w.g * G + m0 + (kQMajor ? si : so);
            const int s = it % kStages;
            const int i0 = w.qt<FUSED>(kQMajor ? so : si) * kBQh;
            mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
            t.stats(stats_s + s * kBQh, full + s, w.b, h, i0, kBQh, lane);
            mbar_arrive(full + s);
          }
        }
      }
    } else if (FUSED && pw == kWriterWarp) {
      // the dq writer warp. A tile's adds are finished (waited for, turn
      // passed on, buffer freed) once the next tile is staged, so they fly
      // while the consumers compute (with CLUSTER an item's last tile at
      // the item's end); and always before the writer waits for a turn, so
      // that it never holds one back while it waits.
      const int wl = lane;
      int it = 0, prev_kt = -1;
      int* prev_turn = nullptr;
      auto finish = [&](int buf) {
        bulk_wait();
        __syncwarp();
        if (wl == 0) {
          fence_proxy_async();
          st_release(prev_turn, prev_kt + 1);
          mbar_arrive(dq_empty + buf);
        }
      };
      for (int n = 0, item = first; item < n_items; item = item_at(++n)) {
        const KvItem w = KvItem::of<FUSED>(t, item, n_kt);
        const int n_q = w.qt1 - w.qt0;
        for (int so = 0; so < outer(n_q); ++so) {
          for (int si = 0; si < inner(n_q); ++si, ++it) {
            const int h = w.g * G + m0 + (kQMajor ? si : so);
            const int buf = it % 2, qt = w.qt<FUSED>(kQMajor ? so : si);
            int* turn = dq_turn + ((size_t)w.b * t.H + h) * n_qt + qt;
            mbar_wait(dq_full + buf, (it / 2) & 1);
            if (prev_turn) finish(buf ^ 1);
            if (wl == 0 && w.kt > 0)
              while (ld_acquire(turn) < w.kt) __nanosleep(32);
            __syncwarp();
            fence_proxy_async();
            if (wl == 0) {
              const float* src = dq_s + buf * kBQh * Sm::LDQ;
              float* dst = dq_acc + (((size_t)w.b * t.H + h) * n_qt + qt) *
                                        (kBQh * Sm::LDQ);
              if (w.kt == 0)
                bulk_store(dst, src, kBQh * Sm::LDQ * 4);
              else
                bulk_add_f32(dst, src, kBQh * Sm::LDQ * 4);
            }
            bulk_commit();
            prev_turn = turn;
            prev_kt = w.kt;
          }
        }
        if constexpr (CLUSTER) {  // the stage reuses the dq buffers: free
          if (prev_turn) finish((it - 1) % 2);  // them with the item
          prev_turn = nullptr;
        }
      }
      if (prev_turn) finish((it - 1) % 2);
    }
  } else {  // consumer warpgroups
    regs_inc<Tiles::kRegsConsumer>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r = lane >> 2, c = (lane & 3) * 2;
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    int it = 0;
    for (int n = 0, item = first; item < n_items; item = item_at(++n)) {
      const KvItem w = KvItem::of<FUSED>(t, item, n_kt);
      const int jw = w.kt * kBN + wg * 64;  // this warpgroup's first key
      const int krow0 = jw + warp * 16 + r;  // and krow0 + 8
      float dk[P][32], dv[P][32];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.f;
      mbar_wait(kv_full, n & 1);

      const int n_q = w.qt1 - w.qt0;
      for (int so = 0; so < outer(n_q); ++so) {
        for (int si = 0; si < inner(n_q); ++si, ++it) {
          const int mem = m0 + (kQMajor ? si : so);
          const int s = it % kStages, ph = (it / kStages) & 1;
          const int i0 = w.qt<FUSED>(kQMajor ? so : si) * kBQh;
          if (!FUSED && band.none(i0, kBQh, jw, 64)) {  // as in dq_walk
            mbar_wait(full + s, ph);
            mbar_arrive(empty + s);
            continue;
          }
          const uint32_t q_addr = smem_u32(Qs + s * Sm::kQ);
          const uint32_t do_addr = smem_u32(dOs + s * Sm::kQ);
          const float2* st_s = stats_s + s * kBQh;
          float st[32], dpt[32];
          mbar_wait(full + s, ph);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < HD / 16; ++k)
            wgmma_ss<0, 0>(st, kmajor<kBN>(k_addr, wg * 64, k),
                           kmajor<kBQh>(q_addr, 0, k), k > 0);
#pragma unroll
          for (int k = 0; k < HD / 16; ++k)
            wgmma_ss<0, 0>(dpt, kmajor<kBN>(v_addr, wg * 64, k),
                           kmajor<kBQh>(do_addr, 0, k), k > 0);
          wgmma_commit();
          wgmma_wait<0>();
          keep(st);
          keep(dpt);

          // entry i: key krow0 + 8 ((i / 2) % 2), q row i0 + 8 (i / 4) + c
          // + i % 2; on an edge tile, each key's rows of the band [lo, hi)
          const bool edge = band.edge(i0, kBQh, jw, 64);
          int lo[2] = {0, 0}, hi[2] = {kBQh, kBQh};
          if (edge) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              band.rows(krow0 + 8 * x, &lo[x], &hi[x]);
              lo[x] -= i0;
              hi[x] -= i0;
            }
          }
          bool kp[2];  // DROPOUT: keep bits of the q row pair of i, i + 1
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int li = 8 * (i / 4) + c + (i & 1);
            const int x = (i >> 1) & 1;
            const float2 ld = st_s[li];
            const float p = band_p<Tiles::kClamp>(li < lo[x] || li >= hi[x],
                                                  st[i] * qscale - ld.x);
            float pv = p, d = dpt[i];
            if constexpr (DROPOUT) {
              if ((i & 1) == 0)
                drop.rows2(w.b, w.g * G + mem, i0 + li, krow0 + 8 * x, kp[0],
                           kp[1]);
              pv = kp[i & 1] ? p * drop.inv_keep : 0.f;
              d = kp[i & 1] ? d * drop.inv_keep : 0.f;
            }
            st[i] = pv;
            dpt[i] = p * (d - ld.y) * scale;
          }
          uint32_t pt[4][4], dst[4][4];
          to_a_frags<kBQh>(pt, st);
          to_a_frags<kBQh>(dst, dpt);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kBQh / 16; ++k)
#pragma unroll
            for (int p = 0; p < P; ++p) {
              wgmma_panel<HD>(dv[p], p, pt[k], mnmajor<kBQh>(do_addr, p, k));
              wgmma_panel<HD>(dk[p], p, dst[k], mnmajor<kBQh>(q_addr, p, k));
            }
          wgmma_commit();
          if constexpr (!FUSED) {
            wgmma_wait<0>();
            keep(pt);
            keep(dst);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              keep_panel<HD>(dk[p], p);
              keep_panel<HD>(dv[p], p);
            }
            mbar_arrive(empty + s);
          } else {
            // dS^T (128 k rows x 64 q) into the swizzled tile: fragment q of
            // slice k holds rows +8 (q & 1), columns 16 k + 8 (q >> 1) + c
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int R = wg * 64 + warp * 16 + r + 8 * (q & 1);
                const int C = 16 * k + 8 * (q >> 1) + c;
                *reinterpret_cast<uint32_t*>(
                    dSt + R * 128 + (((C >> 3) ^ (R & 7)) << 4) + (C & 7) * 2) =
                    dst[k][q];
              }
            fence_async_smem();
            named_sync(1, kConsumers);  // all of dS^T is staged
            wgmma_wait<0>();            // dV, dK done: the q stage is free
            keep(pt);
            keep(dst);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              keep(dk[p]);
              keep(dv[p]);
            }
            mbar_arrive(empty + s);
            const int buf = it % 2;
            if (wg < P) {
              float dq[32];
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < kBN / 16; ++k)
                wgmma_ss<1, 1>(dq, mnmajor<kBN>(smem_u32(dSt), 0, k),
                               mnmajor<kBN>(k_addr, wg, k), k > 0);
              wgmma_commit();
              float* dq_b = dq_s + buf * kBQh * Sm::LDQ;
              mbar_wait(dq_empty + buf, ((it / 2) & 1) ^ 1);
              wgmma_wait<0>();
              keep(dq);
#pragma unroll
              for (int i = 0; i < 32; i += 2) {
                const int rr = warp * 16 + r + 8 * ((i >> 1) & 1);
                *reinterpret_cast<float2*>(
                    dq_b + rr * Sm::LDQ + wg * 64 + 8 * (i / 4) + c) =
                    make_float2(dq[i], dq[i + 1]);
              }
              fence_async_smem();
            }
            mbar_arrive(dq_full + buf);
            named_sync(1, kConsumers);  // both have read dS^T
          }
        }
      }
      mbar_arrive(kv_empty);
      if constexpr (CLUSTER) {
        const int tid = threadIdx.x;  // 0 .. kConsumers - 1
        if (FUSED && rank != 0) {  // the stage is the dq buffers: both free
          mbar_wait(dq_empty + it % 2, ((it / 2) & 1) ^ 1);
          mbar_wait(dq_empty + (it + 1) % 2, (((it + 1) / 2) & 1) ^ 1);
        }
        // part 0 sums dK, part 1 dV; each completes one phase of red_full
        // (rank 0) and of red_free (the others), so its parity is `part`
        auto reduce = [&](float (&a)[P][32], int part) {
          if (rank != 0) {
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                stage[(p * 8 + j) * kConsumers + tid] =
                    make_float4(a[p][4 * j], a[p][4 * j + 1],
                                a[p][4 * j + 2], a[p][4 * j + 3]);
            fence_cluster();
            named_sync(1, kConsumers);  // the whole partial is staged
            if (tid == 0) mbar_arrive_cluster(map_rank(red_full, 0));
            mbar_wait_cluster(red_free, part);  // rank 0 has read it
            return;
          }
          mbar_wait_cluster(red_full, part);
          for (int rk = 1; rk < C; ++rk) {
            const uint32_t peer = map_rank(stage, rk) + tid * 16;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              uint32_t v[8][4];
#pragma unroll
              for (int j = 0; j < 8; ++j)
                ld_cluster(v[j], peer + (p * 8 + j) * kConsumers * 16);
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  a[p][4 * j + e] += __uint_as_float(v[j][e]);
            }
          }
          named_sync(1, kConsumers);  // every stage read
          if (tid >= 1 && tid < C)
            mbar_arrive_cluster(map_rank(red_free, tid));
        };
        reduce(dk, 0);
        reduce(dv, 1);
        if (rank != 0) continue;
      }

#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int krow = krow0 + 8 * x;
        if (krow >= band.Skv) continue;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * j >= panel_cols<HD>(p)) continue;
            const int i = 4 * j + 2 * x;
            t.store_dkv(w.b, w.g, krow, 64 * p + 8 * j + c, dk[p][i],
                        dk[p][i + 1], dv[p][i], dv[p][i + 1]);
          }
      }
    }
  }
}

}  // namespace
