// Paged-attention decode on Hopper: one decode step of attention over a
// paged KV pool.
//
// Replaces the TPU kernel neuronika_tpu/ops/pallas/paged_attention.py::_kernel
// (launched by `paged_attention` through pl.pallas_call) and computes the
// same function with the same layout contract:
//   q      (B, KV, G, hd)    one new token per sequence, GQA folded into the
//                            query side (G = n_head / kv_heads)
//   pk/pv  (NB, KV, BS, hd)  one layer's slice of the block pool
//   table  (B, MB) int32     pool block id of each logical block
//   pos    (B,) int32        write position: keys 0..pos are attended
//   out    (B, KV, G, hd)    in q's dtype
// s = q.k^T / sqrt(hd) over the attended keys (with window > 0 only keys with
// pos - col < window), an online softmax, o = sum p.v. Inputs are f32 or
// bf16; every sum is kept in f32.
//
// What bounds it: device memory. A sequence's live K/V is read once, bytes =
// live tokens * KV * hd * 2 (K and V) * sizeof(dtype), against 4*G flops per
// K/V element pair -- far below the ~295 flop/byte at which the card's
// tensor cores would become the limit. So the loop moves no byte it does not
// need and keeps as many loads in flight as it can:
//   * the sequence is split (flash-decoding): the grid is (KV, B, splits),
//     and CTA z of a (sequence, kv head) walks the logical blocks
//     [z bps, (z + 1) bps) that meet m_lo .. pos/BS, reading table[b, m]
//     itself (the TPU grid visits, and copies, all MB table entries, dead
//     ones included). The host picks splits and bps from B*KV, MB and the
//     SM count alone (ops/paged_attention.py::paged_split_plan), never from
//     pos, so a decode step does not wait on the card;
//   * q stays in registers, pre-scaled by log2(e)/sqrt(hd) (exp2 domain);
//   * a group of lanes reads one K or V row, 16 bytes a thread, neighbouring
//     lanes on neighbouring addresses; each group loads kUnroll rows of K and
//     V before it computes on any of them;
//   * every group keeps its own online-softmax state in registers; groups
//     merge by warp shuffles, then warps through shared memory in a fixed
//     order;
//   * every CTA of a (sequence, kv head) knows from pos which splits meet
//     its attended blocks; a split that meets none ends at once (its
//     partial would be m = -inf, l = 0, weight 0 in the merge). A split
//     alone in them writes the output. Otherwise each writes its partial
//     (m, l, acc[G][hd]) in f32 to the scratch `part` and counts itself
//     on its (b, kv)'s counter; the CTA that counts last merges the
//     partials in split order, writes the output and resets the counter
//     to 0. Every partial is fixed by its inputs and the order is fixed,
//     so the result is the same bits every launch, whichever CTA merges,
//     and there is no second launch;
//   * the table entries of a step's rows are read a step ahead.
// A producer warp feeding an mbarrier ring by 1-d bulk copies
// (cp.async.bulk) in place of the register loads ran slower at walks of
// 11-12 blocks a CTA on an H100 (its 48 KB ring and 288 threads left 3-4
// CTAs an SM): 0.0200 against 0.0172 ms at B8 KV12 hd128 bf16. This body
// (route "chunked") keeps the tensor cores idle: at most kMaxG query rows a
// CTA. Past 8 query heads a kv head in bf16 at hd 64 and 128 the second
// body below (route "mma", paged_attention_mma_kernel) runs the group's
// rows as one m16 tile on mma.sync.
//
// Head dims and groups, as JAX's kernel takes them: any hd from 1 to 256
// and any G. The kernel is instantiated at four head-dim tiers (32, 64,
// 128, 256: a row group's lanes split a power-of-two width) and masks the
// runtime hd: a lane's 16-byte chunk past hd is not read and counts as 0,
// and element loads replace the 16-byte ones where hd breaks their
// alignment. A group larger than kMaxG is cut into chunks of kMaxG query
// heads, each a CTA of its own (grid.x = KV chunks): a chunk reads the kv
// head's K and V again, from L2 when its neighbours run beside it, and
// keeps every register bound of the 8-head kernel. Each chunk is a
// (sequence, kv head) of the split-and-merge above, with its own partials
// and counter, merged in split order as one kv head's are.
//
// Inactive decode lanes come with an all-zero table row and pos clamped to
// MB*BS-1: they read scratch block 0, which is valid memory, and their output
// is discarded by the caller. pos is clamped to MB*BS-1 here too, and a table
// entry outside [0, NB) contributes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxSplits = 256;   // ops/paged_attention.py: SPLIT_MAX
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ static void to_float(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float store(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_float(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
};

// m_use keeps exp2 finite before any key was seen (m = -inf): both factors
// are then exp2(-inf) = 0 instead of NaN.
__device__ __forceinline__ float safe_max(float m) {
  return m == -INFINITY ? 0.f : m;
}

// After a split's partial is written (pb: the first of the n partials of
// its (sequence, kv head, chunk) that take part, `stride` floats apart):
// count the split in; the CTA that counts last merges the n in split order
// into ob and resets the counter. The other CTAs' partials are read from L2
// (they are not in this SM's L1), the splits' m and l all at once into
// shared memory, each group's max by one warp, then each element's sums
// over the splits, the acc loads of several splits in flight together. A
// split whose blocks were all outside the pool (m = -inf: weight 0) adds
// nothing.
// 16 bytes from p, the elements at or past `avail` as 0 (none read when
// avail <= 0); `vec`: p is 16-byte aligned and avail, when positive, at
// least a vector
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int avail, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (avail <= 0) return r;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    if (i < avail) e[i] = p[i];
  return r;
}

// (pb advances `stride` floats a split; a split's partial is m[G], l[G],
// acc[G][hd])
template <typename T, int MAXG>
__device__ __forceinline__ void count_and_merge(const float* pb, int n,
                                                int G, int hd, int stride,
                                                int* cnt, T* ob) {
  __shared__ bool last;
  __shared__ float sw[kMaxSplits * MAXG], sl[kMaxSplits * MAXG];
  __threadfence();   // the partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < n * G; t += kThreads) {
    const float* py = pb + (size_t)(t / G) * stride;
    sw[t] = __ldcg(py + t % G);
    sl[t] = __ldcg(py + G + t % G);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < G) {   // G <= kWarps: warp g turns group g's m into weights
    float mm = -INFINITY;
    for (int y = lane; y < n; y += 32) mm = fmaxf(mm, sw[y * G + warp]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(kFull, mm, off));
    const float mu = safe_max(mm);
    for (int y = lane; y < n; y += 32)
      sw[y * G + warp] = exp2f(sw[y * G + warp] - mu);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float l = 0.f, a = 0.f;
#pragma unroll 4
    for (int y = 0; y < n; ++y) {
      const float w = sw[y * G + g];
      if (w == 0.f) continue;   // adds exactly 0
      l += sl[y * G + g] * w;
      a += __ldcg(pb + (size_t)y * stride + 2 * G + i) * w;
    }
    ob[i] = Vec<T>::store(a / l);
  }
  if (threadIdx.x == 0) *cnt = 0;   // ready for the next launch
}

// G = 1 at hd <= 128 (the decode path) fits 4 CTAs an SM in 64 registers a
// thread: paged_split_plan's SPLIT_CTAS_PER_SM, one wave at the long shape.
// HD is the head-dim tier, hd <= HD the pool's; blockIdx.x is (kv head,
// chunk of up to MAXG of its G query heads), NC chunks a kv head.
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kThreads, MAXG == 1 && HD <= 128 ? 4 : 1)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                           const T* __restrict__ pv,
                           const int* __restrict__ table,
                           const int* __restrict__ pos_arr,
                           T* __restrict__ out, int KV, int G_all, int NC,
                           int hd, int NB, int BS, int MB, int window,
                           float qscale, int bps, float* __restrict__ part,
                           int* __restrict__ count) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPT = (HD / VEC < 32) ? HD / VEC : 32;  // lanes per row
  constexpr int CH = HD / (LPT * VEC);  // 16-byte chunks per lane and row
  constexpr int EPL = CH * VEC;         // row elements per lane
  constexpr int RPW = 32 / LPT;         // rows a warp reads at once
  constexpr int NGRP = kWarps * RPW;    // row groups per CTA
  // rows a row group loads before it computes: 4 at G = 1 (the decode
  // path's multi-head attention), 2 where 8 query heads' registers leave
  // no room
  constexpr int kUnroll = MAXG == 1 ? 4 : 2;
  static_assert(HD % (LPT * VEC) == 0, "head dim must split into 16B chunks");

  const int kv = blockIdx.x / NC, g0 = blockIdx.x % NC * MAXG;
  const int G = min(MAXG, G_all - g0);  // this CTA's query heads
  const int b = blockIdx.y;
  const int z = blockIdx.z, splits = (int)gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPT;  // row group within the warp
  const int li = lane % LPT;   // lane within the row group
  const int grp = warp * RPW + sub;
  // this lane holds row elements (c * LPT + li) * VEC + e, c < CH, e < VEC

  int pos = pos_arr[b];
  pos = min(pos, MB * BS - 1);
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  // whole blocks from the one holding lo up to the one holding pos, within
  // this split's blocks [z bps, (z + 1) bps); keys past pos are masked
  const int t_begin = max((lo / BS) * BS, z * bps * BS);
  const int t_end = min(pos < 0 ? t_begin : (pos / BS + 1) * BS,
                        min(MB, (z + 1) * bps) * BS);
  // the splits z_lo .. z_hi meet the attended blocks lo / BS .. pos / BS
  // (every CTA of the sequence knows which): a split outside them ends
  // here, its partial would be m = -inf, l = 0; a split alone in them
  // writes the output itself; otherwise each writes its partial m[G], l[G],
  // acc[G][hd] (in the slot of [b][kv chunk][z]) and the last merges them
  const int z_lo = lo / BS / bps, z_hi = pos < 0 ? z_lo : pos / BS / bps;
  if (z < z_lo || z > z_hi) return;
  // every chunk's slot holds min(G_all, MAXG) heads, so slots are uniform
  const int stride = min(G_all, MAXG) * (hd + 2);
  const size_t xb = (size_t)b * KV * NC + blockIdx.x;
  float* pb = part + (xb * splits + z_lo) * stride;
  float* pz = pb + (size_t)(z - z_lo) * stride;
  int* cnt = count + xb;
  const size_t q0 = ((size_t)b * KV + kv) * G_all + g0;  // first q head
  T* ob = out + q0 * hd;
  // 16-byte loads where every row start is aligned (the wrapper checks
  // the bases)
  const bool vec = hd % VEC == 0;

  float qr[MAXG][EPL];
  const T* qb = q + q0 * hd;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float f[VEC];
      if (g < G) {
        const int cs = (c * LPT + li) * VEC;
        Vec<T>::to_float(load16(qb + (size_t)g * hd + cs, hd - cs, vec), f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][c * VEC + e] = f[e] * qscale;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int* trow = table + (size_t)b * MB;
  // the table entries of a step's rows are read a step ahead, so a step's
  // K and V loads wait on no other load
  constexpr int kStep = NGRP * kUnroll;
  int next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int col = t_begin + u * NGRP + grp;
    next[u] = col < t_end ? __ldg(trow + col / BS) : -1;
  }
  // the trip count is the same for every lane, so the shuffles below always
  // run on full warps; rows past t_end are loaded as zeros and masked
  for (int base = t_begin; base < t_end; base += kStep) {
    uint4 kr[kUnroll][CH], vr[kUnroll][CH];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = base + u * NGRP + grp;
      const int blk = next[u];
      const bool live = blk >= 0 && blk < NB;
      keep[u] = live && col >= lo && col <= pos;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (live) {
          const int cs = (c * LPT + li) * VEC;
          const size_t at =
              (((size_t)blk * KV + kv) * BS + col % BS) * hd + cs;
          kr[u][c] = load16(pk + at, hd - cs, vec);
          vr[u][c] = load16(pv + at, hd - cs, vec);
        } else {
          kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int col = base + kStep + u * NGRP + grp;
      next[u] = col < t_end ? __ldg(trow + col / BS) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        Vec<T>::to_float(kr[u][c], kf + c * VEC);
        Vec<T>::to_float(vr[u][c], vf + c * VEC);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {  // G is uniform over the CTA
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s += qr[g][e] * kf[e];
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(kFull, s, off);
          s = keep[u] ? s : -INFINITY;
          const float m_new = fmaxf(m[g], s);
          const float mu = safe_max(m_new);
          const float alpha = exp2f(m[g] - mu);
          const float p = exp2f(s - mu);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[e];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the row groups of a warp: lanes li of every group hold the same
  // elements, so xor-shuffles over multiples of LPT pair them up
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float m_o = __shfl_xor_sync(kFull, m[g], off);
        const float l_o = __shfl_xor_sync(kFull, l[g], off);
        const float mu = safe_max(fmaxf(m[g], m_o));
        const float a = exp2f(m[g] - mu);
        const float a_o = exp2f(m_o - mu);
        l[g] = l[g] * a + l_o * a_o;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float acc_o = __shfl_xor_sync(kFull, acc[g][e], off);
          acc[g][e] = acc[g][e] * a + acc_o * a_o;
        }
        m[g] = fmaxf(m[g], m_o);
      }
    }
  }

  // merge the warps: a common max, then each warp adds its rescaled sums in
  // warp order (a fixed order, so the result does not vary run to run)
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[MAXG];
  __shared__ float sm_acc[MAXG][HD];
  for (int i = threadIdx.x; i < MAXG * HD; i += kThreads) (&sm_acc[0][0])[i] = 0.f;
  if (threadIdx.x < MAXG) sm_l[threadIdx.x] = 0.f;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sm_m[warp][g] = m[g];
  }
  __syncthreads();
  float scale_w[MAXG], mx[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    mx[g] = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx[g] = fmaxf(mx[g], sm_m[w][g]);
    scale_w[g] = exp2f(m[g] - safe_max(mx[g]));
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && sub == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          if (li == 0) sm_l[g] += l[g] * scale_w[g];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              sm_acc[g][(c * LPT + li) * VEC + e] +=
                  acc[g][c * VEC + e] * scale_w[g];
          }
        }
      }
    }
    __syncthreads();
  }

  if (z_lo == z_hi) {
    for (int i = threadIdx.x; i < G * hd; i += kThreads) {
      const int g = i / hd;
      ob[i] = Vec<T>::store(sm_acc[g][i % hd] / sm_l[g]);
    }
    return;
  }
  for (int i = threadIdx.x; i < G * hd; i += kThreads)
    pz[2 * G + i] = sm_acc[i / hd][i % hd];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) {
        pz[g] = mx[g];
        pz[G + g] = sm_l[g];
      }
  }
  count_and_merge<T, MAXG>(pb, z_hi - z_lo + 1, G, hd, stride, cnt, ob);
}

// ------------------------------------------------ the tensor-core body
// Route "mma" (ops/paged_attention.py::paged_route): bf16 at hd 64 and 128,
// meant for groups past 8 query heads a kv head (StarCoderBase-1B's 16
// over 1). Replaces the same TPU kernel, _kernel of
// neuronika_tpu/ops/pallas/paged_attention.py, which computes s =
// dot(q, k^T) in q's dtype with f32 accumulation, scales it by
// log2(e)/sqrt(hd) in f32 and rounds p to v's dtype for dot(p, v): so does
// this body.
//
// What bounds it: device memory, as the chunked body; at G 16 hd 128 the
// K and V rows of a decode step are a few MB, ~1 us at 3.35 TB/s. The
// chunked body took ~50x that there: its 8-head chunks read each kv head's
// K and V twice, ran four waves of 256-thread CTAs at one an SM, each
// merging 16 row groups' 8 x hd accumulators by shuffles and 8 warps
// through shared memory in turn, and the last CTA of a sequence merged 32
// partials with a few loads in flight. Here:
//   * one CTA a (sequence, kv head, chunk of up to 16 query heads,
//     split) holds the chunk's heads as one m16 tile (rows past G are
//     zeros whose output is dropped), so each K and V row is read once
//     a chunk, and a group of 16 is one chunk;
//   * 4 warps take interleaved 16-key tiles of the split's keys; each
//     warp keeps kMmaStages tiles in flight in its own ring in shared
//     memory, each row addressed through the block table (any block
//     size works) and copied by a 1-d bulk copy (cp.async.bulk) of its
//     own, lanes 0-15 a tile's K rows and 16-31 its V rows, completing
//     on an mbarrier a warp and stage; a row past the split's end or of
//     a block outside the pool is zeroed by its lane and masked. Loads of
//     16 bytes a lane by cp.async read 6-10% slower at StarCoderBase-1B's
//     decode on an H100 (tools/torch_diag.py paged-loads);
//   * S = Q K^T is mma.sync.m16n8k16 bf16 with f32 accumulation, Q the A
//     fragments, held unscaled in registers for the whole walk, K from
//     shared memory by ldmatrix (rows padded by 16 bytes: no bank
//     conflicts); the online softmax runs on the accumulator registers
//     (quad shuffles, exp2 domain); P is rounded to bf16 into the A
//     fragment of O += P V, whose V comes by ldmatrix.trans;
//   * the warps merge their (m, l, O) through shared memory in warp
//     order; the split's partial (acc, m, l of 16 rows, f32) is counted
//     in as the chunked body's, and the last CTA merges the partials in
//     split order, float4 loads of several splits in flight together.
//     Every partial and the order are fixed: the same bits every launch.
// The host's plan (paged_mma_plan) gives one wave of CTAs that walk
// several blocks each, from B, KV, G, MB and the SM count, never pos.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16;    // query heads a CTA: one m16 tile
constexpr int kMmaKeys = 16;    // keys a warp's tile: the k16 of P V
constexpr int kMmaStages = 2;   // a warp's tiles in flight

template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + 8;          // bf16 a K or V row, padded
  static constexpr int kTile = kMmaKeys * LD;  // bf16 of a K or V tile
  static constexpr size_t kRing =
      (size_t)kMmaWarps * kMmaStages * 2 * kTile * 2;
  // after the walk, over the ring: each warp's m[16], l[16], O[16][LDO]
  static constexpr int LDO = HD + 4;
  static constexpr int kWarpPart = 2 * kMmaRows + kMmaRows * LDO;
  static constexpr size_t kMerge = (size_t)kMmaWarps * kWarpPart * 4;
  // then the last CTA's split weights and sums, kMaxSplits x 16 each
  static constexpr size_t kSplits = 2 * (size_t)kMaxSplits * kMmaRows * 4;
  // the ring's mbarriers, a warp and stage, after both
  static constexpr size_t kOffBar =
      kRing > kMerge + kSplits ? kRing : kMerge + kSplits;
  static constexpr size_t kBytes = kOffBar + 8 * kMmaWarps * kMmaStages;
  // floats of a split's partial: acc[16][HD], m[16], l[16]
  static constexpr int kStride = kMmaRows * (HD + 2);
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// HD is the pool's head dim (64 or 128); blockIdx.x is (kv head, chunk of
// up to 16 of its G query heads), NC chunks a kv head
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ pk,
                               const __nv_bfloat16* __restrict__ pv,
                               const int* __restrict__ table,
                               const int* __restrict__ pos_arr,
                               __nv_bfloat16* __restrict__ out, int KV,
                               int G_all, int NC, int NB, int BS, int MB,
                               int window, float qscale, int bps,
                               float* __restrict__ part,
                               int* __restrict__ count) {
  using Sm = MmaSmem<HD>;
  constexpr int LD = Sm::LD;
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;

  const int kv = blockIdx.x / NC, g0 = blockIdx.x % NC * kMmaRows;
  const int G = min(kMmaRows, G_all - g0);  // this CTA's query heads
  const int b = blockIdx.y;
  const int z = blockIdx.z, splits = (int)gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 2, c = (lane & 3) * 2;

  // the split's keys and the splits that meet the attended blocks, as the
  // chunked body has them
  int pos = pos_arr[b];
  pos = min(pos, MB * BS - 1);
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int t_begin = max((lo / BS) * BS, z * bps * BS);
  const int t_end = min(pos < 0 ? t_begin : (pos / BS + 1) * BS,
                        min(MB, (z + 1) * bps) * BS);
  const int z_lo = lo / BS / bps, z_hi = pos < 0 ? z_lo : pos / BS / bps;
  if (z < z_lo || z > z_hi) return;
  const size_t xb = (size_t)b * KV * NC + blockIdx.x;
  float* pb = part + (xb * splits + z_lo) * Sm::kStride;
  float* pz = pb + (size_t)(z - z_lo) * Sm::kStride;
  const size_t q0 = ((size_t)b * KV + kv) * G_all + g0;  // first q head
  __nv_bfloat16* ob = out + q0 * HD;

  // Q's A fragments (rows r and r + 8, columns 16 k + c and + 8), 0 past G
  uint32_t qa[HD / 16][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + q0 * HD);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      const int col = 16 * k + c;
      qa[k][0] = r < G ? __ldg(q32 + (r * HD + col) / 2) : 0u;
      qa[k][1] = r + 8 < G ? __ldg(q32 + ((r + 8) * HD + col) / 2) : 0u;
      qa[k][2] = r < G ? __ldg(q32 + (r * HD + col + 8) / 2) : 0u;
      qa[k][3] = r + 8 < G ? __ldg(q32 + ((r + 8) * HD + col + 8) / 2) : 0u;
    }
  }

  // this warp's tiles: keys t_begin + 16 (warp + 4 i) .. + 15
  const int ntiles = (t_end - t_begin + kMmaKeys - 1) / kMmaKeys;
  const int mine = ntiles > warp ? (ntiles - 1 - warp) / kMmaWarps + 1 : 0;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                        (size_t)warp * kMmaStages * 2 * Sm::kTile;
  const int* trow = table + (size_t)b * MB;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + Sm::kOffBar) + warp * kMmaStages;
  if (lane < kMmaStages) mbar_init(bars + lane, 1);
  mbar_fence_init();
  __syncwarp();
  // copies tile i of this warp into stage i % kMmaStages: lane l's row is
  // K row l (l < 16) or V row l - 16, one bulk copy on the stage's
  // barrier, or zeros; returns the tile's rows that hold pool keys, a bit
  // each
  auto issue = [&](int i) -> uint32_t {
    const int base = t_begin + (warp + kMmaWarps * i) * kMmaKeys;
    const int row = lane % kMmaKeys, col = base + row;
    const int blk = col < t_end ? __ldg(trow + col / BS) : -1;
    const bool ok = blk >= 0 && blk < NB;
    const uint32_t live = __ballot_sync(kFull, ok) & 0xffffu;
    __nv_bfloat16* dst = ring + (i % kMmaStages) * 2 * Sm::kTile +
                         (lane >= kMmaKeys ? Sm::kTile : 0) + row * LD;
    if (!ok)
#pragma unroll
      for (int ch = 0; ch < CPR; ++ch)
        reinterpret_cast<uint4*>(dst)[ch] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();  // the zeros and this stage's last reads, then
    __syncwarp();         // the copies
    uint64_t* bar = bars + i % kMmaStages;
    if (lane == 0) mbar_expect_tx(bar, __popc(live) * 2 * 2 * HD);
    if (ok)
      bulk_load(dst,
                (lane >= kMmaKeys ? pv : pk) +
                    (((size_t)blk * KV + kv) * BS + col % BS) * HD,
                2 * HD, bar);
    return live;
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int t = 0; t < HD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // ldmatrix rows: K as the B operand of S (keys 8 (lane / 16) + lane % 8,
  // columns + 8 ((lane / 8) % 2)), V as the B operand of P V, transposed
  // (keys 8 ((lane / 8) % 2) + lane % 8, columns + 8 (lane / 16))
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) << 3;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vcol = (lane >> 4) << 3;

  uint32_t live[kMmaStages];
#pragma unroll
  for (int s = 0; s + 1 < kMmaStages; ++s) live[s] = s < mine ? issue(s) : 0;
  for (int i = 0; i < mine; ++i) {
    live[kMmaStages - 1] =
        i + kMmaStages - 1 < mine ? issue(i + kMmaStages - 1) : 0;
    mbar_wait(bars + i % kMmaStages, (i / kMmaStages) & 1);
    __syncwarp();
    const int base = t_begin + (warp + kMmaWarps * i) * kMmaKeys;
    const uint32_t ka = smem_u32(ring + (i % kMmaStages) * 2 * Sm::kTile);
    const uint32_t va = ka + Sm::kTile * 2;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      uint32_t kb[4];
      ldsm_x4(kb, ka + (krow * LD + 16 * k + kcol) * 2);
      mma16816(s[0], qa[k], kb[0], kb[1]);
      mma16816(s[1], qa[k], kb[2], kb[3]);
    }
    // entry (j, e): row r + 8 (e / 2), key base + 8 j + c + e % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + c + (e & 1), col = base + key;
        const bool in = ((live[0] >> key) & 1) && col >= lo && col <= pos;
        const float v = in ? s[j][e] * qscale : -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float m_new = fmaxf(m[x], quad_max(mx[x]));
      mu[x] = safe_max(m_new);
      alpha[x] = exp2f(m[x] - mu[x]);
      m[x] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + sum[x];
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] *= alpha[e >> 1];
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      uint32_t vb[4];
      ldsm_x4_t(vb, va + (vrow * LD + 16 * t + vcol) * 2);
      mma16816(o[2 * t], pa, vb[0], vb[1]);
      mma16816(o[2 * t + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();  // the stage is read before a later tile overwrites it
#pragma unroll
    for (int s2 = 0; s2 + 1 < kMmaStages; ++s2) live[s2] = live[s2 + 1];
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) l[x] = quad_sum(l[x]);

  // the warps' (m, l, O) into shared memory (over the ring)
  __syncthreads();
  float* wp = reinterpret_cast<float*>(smem);
  {
    float* w = wp + warp * Sm::kWarpPart;
    if ((lane & 3) == 0) {
      w[r] = m[0];
      w[r + 8] = m[1];
      w[kMmaRows + r] = l[0];
      w[kMmaRows + r + 8] = l[1];
    }
    float* wo = w + 2 * kMmaRows;
#pragma unroll
    for (int t = 0; t < HD / 8; ++t) {
      *reinterpret_cast<float2*>(wo + r * Sm::LDO + 8 * t + c) =
          make_float2(o[t][0], o[t][1]);
      *reinterpret_cast<float2*>(wo + (r + 8) * Sm::LDO + 8 * t + c) =
          make_float2(o[t][2], o[t][3]);
    }
  }
  __syncthreads();
  // merged in warp order: the output itself where the split is alone in
  // the attended blocks, else its partial
  const bool alone = z_lo == z_hi;
  for (int i = threadIdx.x; i < G * HD; i += kMmaThreads) {
    const int g = i / HD, d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, wp[w * Sm::kWarpPart + g]);
    const float mw = safe_max(M);
    float acc = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float* ww = wp + w * Sm::kWarpPart;
      const float f = exp2f(ww[g] - mw);
      L += ww[kMmaRows + g] * f;
      acc += ww[2 * kMmaRows + g * Sm::LDO + d] * f;
    }
    if (alone) {
      ob[i] = __float2bfloat16(acc / L);
    } else {
      pz[i] = acc;
      if (d == 0) {
        pz[kMmaRows * HD + g] = M;
        pz[kMmaRows * HD + kMmaRows + g] = L;
      }
    }
  }
  if (alone) return;

  // count the split in; the last of the n merges them in split order
  const int n = z_hi - z_lo + 1;
  int* cnt = count + xb;
  __threadfence();  // the partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* sw = wp + kMmaWarps * Sm::kWarpPart;  // [split][16] weights
  float* sl = sw + kMaxSplits * kMmaRows;      // [split][16] sums
  for (int t = threadIdx.x; t < n * G; t += kMmaThreads) {
    const float* py = pb + (size_t)(t / G) * Sm::kStride + kMmaRows * HD;
    sw[t / G * kMmaRows + t % G] = __ldcg(py + t % G);
    sl[t / G * kMmaRows + t % G] = __ldcg(py + kMmaRows + t % G);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kMmaWarps) {  // m into weights, row g
    float mm = -INFINITY;
    for (int y = lane; y < n; y += 32) mm = fmaxf(mm, sw[y * kMmaRows + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(kFull, mm, off));
    const float mu = safe_max(mm);
    for (int y = lane; y < n; y += 32)
      sw[y * kMmaRows + g] = exp2f(sw[y * kMmaRows + g] - mu);
  }
  __syncthreads();
  // each thread sums kPer float4 of the output over the splits, their
  // loads of one split in flight together
  constexpr int kPer = kMmaRows * HD / 4 / kMmaThreads;
  float4 a[kPer];
  float L[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    L[k] = 0.f;
  }
#pragma unroll 4
  for (int y = 0; y < n; ++y) {
    const float* py = pb + (size_t)y * Sm::kStride;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e0 = 4 * (threadIdx.x + kMmaThreads * k);
      if (e0 >= G * HD) continue;
      const int g = e0 / HD;
      const float w = sw[y * kMmaRows + g];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(py + e0));
      a[k].x += v.x * w;
      a[k].y += v.y * w;
      a[k].z += v.z * w;
      a[k].w += v.w * w;
      L[k] += sl[y * kMmaRows + g] * w;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e0 = 4 * (threadIdx.x + kMmaThreads * k);
    if (e0 >= G * HD) continue;
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(a[k].x / L[k],
                                                     a[k].y / L[k]);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a[k].z / L[k],
                                                     a[k].w / L[k]);
    uint2 st;
    st.x = *reinterpret_cast<const uint32_t*>(&lo2);
    st.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(ob + e0) = st;
  }
  if (threadIdx.x == 0) *cnt = 0;  // ready for the next launch
}

// the launch's shape beside the pointers: splits CTAs of bps logical blocks
// each per (sequence, kv head, chunk of the group); part and count only
// with splits > 1
struct Shape {
  int B, KV, G, hd, NB, BS, MB, window, splits, bps;
  float qscale;
  float* part;
  int* count;
};

template <typename T, int HD, int MAXG>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* table, const void* pos, void* out,
                   const Shape& s, cudaStream_t stream) {
  const int NC = (s.G + MAXG - 1) / MAXG;
  const dim3 grid(s.KV * NC, s.B, s.splits);
  paged_attention_kernel<T, HD, MAXG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), s.KV, s.G, NC,
      s.hd, s.NB, s.BS, s.MB, s.window, s.qscale, s.bps, s.part, s.count);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const void* q, const void* pk, const void* pv,
                     const void* table, const void* pos, void* out,
                     const Shape& s, cudaStream_t stream) {
  // G = 1 (plain multi-head attention) gets its own instance so that the
  // guarded per-group loops cost nothing
  if (s.G == 1)
    return launch<T, HD, 1>(q, pk, pv, table, pos, out, s, stream);
  return launch<T, HD, kMaxG>(q, pk, pv, table, pos, out, s, stream);
}

// the head-dim tiers: the smallest of 32, 64, 128 and 256 that holds hd
template <typename T>
cudaError_t launch_hd(const void* q, const void* pk, const void* pv,
                      const void* table, const void* pos, void* out,
                      const Shape& s, cudaStream_t stream) {
  if (s.hd <= 32) return launch_g<T, 32>(q, pk, pv, table, pos, out, s, stream);
  if (s.hd <= 64) return launch_g<T, 64>(q, pk, pv, table, pos, out, s, stream);
  if (s.hd <= 128)
    return launch_g<T, 128>(q, pk, pv, table, pos, out, s, stream);
  if (s.hd <= 256)
    return launch_g<T, 256>(q, pk, pv, table, pos, out, s, stream);
  return cudaErrorInvalidValue;
}

// the tensor-core body at head dim HD: NC chunks of up to 16 query heads
template <int HD>
cudaError_t launch_mma(const void* q, const void* pk, const void* pv,
                       const void* table, const void* pos, void* out,
                       const Shape& s, cudaStream_t stream) {
  const auto kernel = paged_attention_mma_kernel<HD>;
  const size_t smem = MmaSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int NC = (s.G + kMmaRows - 1) / kMmaRows;
  const dim3 grid(s.KV * NC, s.B, s.splits);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), s.KV,
      s.G, NC, s.NB, s.BS, s.MB, s.window, s.qscale, s.bps, s.part,
      s.count);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16;
// route (ops/paged_attention.py::paged_route): 0 the chunked body, any hd
// from 1 to 256 and any G; 1 the tensor-core body, bf16 at hd 64 or 128
// and any G (a launch asking for it elsewhere is refused). With the
// route's chunks NC (chunked: ceil(G / 8), 1 when G = 1; mma: ceil(G /
// 16)) and slot rows GS (chunked: min(G, 8); mma: 16): splits CTAs of bps
// logical blocks each per (sequence, kv head, chunk), splits = ceil(MB /
// bps); with splits > 1, part is f32 scratch of B KV NC splits GS (hd + 2)
// floats and count B KV NC int32 zeros, which the kernel leaves at 0.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int nk_paged_attention(int dtype, int route, const void* q,
                                  const void* pk, const void* pv,
                                  const void* table, const void* pos,
                                  void* out, int B, int KV, int G, int hd,
                                  int NB, int BS, int MB, int window,
                                  float scale, int splits, int bps,
                                  void* part, void* count, void* stream) {
  if (B < 1 || KV < 1 || G < 1 || hd < 1 || hd > 256 || NB < 1 || BS < 1 ||
      MB < 1 || window < 0 || B > 65535 || bps < 1 || splits < 1 ||
      splits > kMaxSplits ||
      splits != (MB + bps - 1) / bps ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const Shape s{B,      KV,     G,   hd,
                NB,     BS,     MB,  window,
                splits, bps,    scale * kLog2e,
                static_cast<float*>(part), static_cast<int*>(count)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (hd == 64) return launch_mma<64>(q, pk, pv, table, pos, out, s, st);
    if (hd == 128) return launch_mma<128>(q, pk, pv, table, pos, out, s, st);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_hd<float>(q, pk, pv, table, pos, out, s, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, pk, pv, table, pos, out, s, st);
  return cudaErrorInvalidValue;
}
