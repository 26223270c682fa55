// Concatenation-cost reselection (the paper's CAT step), fp32, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and bound with ctypes (knnsvc_torch/ops/build.py, ops/concat_scan.py).
//
// Replaces the TPU kernel knnsvc_tpu/ops/concat_scan.py::concat_cost_pair_pallas
// (pl.pallas_call at concat_scan.py:182, body _kernel at :68). Its plain
// version is knnsvc_torch/match/concat_cost.py::concat_cost_scan.
//
// A serial recurrence over T frames, per lane (lane 0 unpitched, lane 1
// pitched; one lane for the single reselection), for any k in 1..32:
//   cand    = own top-k of frame t, then min(picks of frame t-1 + 1, P - 1)
//   match_c = 1 - cand_c . svn_t / |cand_c|
//   cc_jc   = 1 - prev_j . cand_c / (|prev_j| |cand_c|)
//   unpitched: cc > b -> 1.5 cc - b;   pitched: b < 0.08 and cc < 5 b -> 0,
//              weight latched to 0 for good once b >= 0.08 (it starts at
//              init_weight: concat_weight, or a streaming carry's weight)
//   total_c = weight * median_j(cc_jc) + match_c [+ |tlf0[cand_c] - slf0_t|]
//   picks   = the k smallest totals, ties to the lowest candidate position,
//             NaN after everything (torch.sort's order)
// with median = sorted[(k-1)/2], b = 2 (1 - svn_{t-1} . svn_t) and the
// log2 f0 tracks computed by the wrapper with the plain version's torch ops.
//
// What bounds it at the main path's shape (T = P = 1500, D = 1024, k = 4,
// 2 lanes): the k x 2k cross dots and 2k source dots of D per frame and
// lane, plus the P pool norms once, are 0.25 GFLOP (~3.7 us at 67 TFLOP/s
// fp32), the rows read once 12.4 MB (~3.7 us at 3.35 TB/s). Neither
// limits it: frame t's candidates hold frame t-1's picks + 1, so the frames
// are a chain of T dependent steps and the kernel is bound by the latency
// of one step. The design takes off that chain all it can:
//   1. concat_cost_prepass_kernel, a parallel pass over the card before the
//      chain: the norm of every pool row, and for every own candidate c of
//      every frame t and lane the source dots c . svn_t and min(c + 1, P -
//      1) . svn_{t+1}, with the warp_dot of the chain's producers, so a
//      value computed ahead has the bits it would have there;
//   2. concat_cost_chain_kernel, one block per lane (lanes are
//      independent). Four producer warps work one frame ahead: once frame
//      t's candidate set S_t is known (at the start of step t), frame t+1's
//      prev+1 candidates are a subset of {min(c + 1, P - 1) : c in S_t}.
//      The producers copy those 2k rows and frame t+1's k own rows into a
//      ring in shared memory, one TMA bulk copy (cp.async.bulk) per row
//      completing on an mbarrier, compute the k source dots the pre-pass
//      cannot know (frame t-1's picks + 2), and gather every scalar the
//      selector needs (norms, f0, baseline) into shared memory;
//   3. on the chain per frame: the dot warps wait on the mbarrier of frame
//      t's rows, which landed during step t-1, and form the k x 2k cross
//      dots against the picks; for k <= 4 each of the 8 warps takes a slice
//      of D for all pairs, so every row is read from shared memory once,
//      and a butterfly reduce-scatter leaves one partial per pair and lane.
//      One named barrier (bar.arrive by the dot warps, bar.sync by the
//      selector), then the selector warp forms one concat cost per lane and
//      pair, the medians, and ranks the candidates in one round (each counts
//      those that come before it under (value, position)); one
//      __syncthreads ends the frame. No global load is left on the chain.
// The per-frame time this leaves (chip_smoke.py; PERF.md) is the cross dots
// and the selector's dependent shared-memory and division latencies, about
// 2 us a frame, with the producers' one L2 round trip close behind.
//
// The pool is a table of S shard base pointers (a device array) and the
// rows per shard: row g is shards[g / shard_len] + (g % shard_len) * D. A
// dense pool is the case S = 1, shard_len = P, where each thread reads the
// one base pointer once and skips the division and the table load (they
// cost the dense entry ~2% per frame); a pool split over a mesh's
// pool axis (knnsvc_torch/parallel) passes its shards, which the JAX
// package's sharded core reads through a masked gather + psum instead
// (knnsvc_tpu/parallel/sharded_match.py:111-117). P is the unpadded pool
// length: ids clamp to it, so padding rows are never read. Shards on
// another card than the kernel's are read through peer access, which the
// wrapper checks and enables.
//
// Rows of any width D. When D % 4 == 0 (template parameter VEC; the main
// path's D = 1024) every row starts 16-byte aligned: the producers copy it
// by one TMA bulk copy and every dot reads it as float4. Otherwise row g
// starts at g D floats, 4-byte aligned only, which neither cp.async.bulk
// nor a float4 load takes: the producers copy the rows by 4-byte cp.async,
// spread over their 128 threads (each thread's cp.async.mbarrier.arrive
// completes the slot's mbarrier when its copies have landed), into ring
// rows padded to DP = D rounded up to 4 floats with zeros, and the dots
// that read device memory read each group of 4 by scalar loads, zeros past
// D. A dot sums the same groups of 4 in the same order either way, so the
// pre-pass and the producers still give equal rows equal sums, and the
// zero tail adds exact zeros.
//
// Rows in shared memory: 3 frames of k own rows and 3 frames of 2k prev+1
// rows, 9 k DP floats. When they and the static arrays fit the block's
// opt-in shared memory (227 KB on an H100: k <= 6 at D = 1024, every k at
// D = 128) the rows live there; otherwise (k >= 7 at D = 1024) the chain
// reads them from global memory (L2), the same arithmetic on other
// pointers, with a dependent row load on the chain. launch_chain decides.
// The chain is compiled for k <= 4, 8 and 32 (KM) and runs any k up to that,
// each for D % 4 == 0 and for other D.
// The scalar cost arithmetic uses __f*_rn intrinsics and the dots explicit
// fmaf, so no multiply-add is contracted where the plain version rounds
// twice: the two differ only in the order of the dot-product sums, and
// equal rows give equal sums wherever they are formed. Ids are clamped to
// [0, P-1] before any row is read (XLA's gather clamps the same way).

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_K = 32;
constexpr int MAX_LANES = 32;
constexpr int DOT_WARPS = 8;     // cross dots; warp 0 also selects
constexpr int PROD_WARPS = 4;    // producers, one frame ahead
constexpr int THREADS = (DOT_WARPS + PROD_WARPS) * 32;
constexpr int PROD_THREADS = PROD_WARPS * 32;
constexpr int PREPASS_THREADS = 256;

// group i of 4 floats of a row of D floats: one float4 load (VEC, the row
// 16-byte aligned) or four scalar ones, zeros past D
template <bool VEC>
__device__ __forceinline__ float4 ld4(const float* row, int i, int D) {
  if (VEC) return reinterpret_cast<const float4*>(row)[i];
  const int c = 4 * i;
  return make_float4(row[c], c + 1 < D ? row[c + 1] : 0.f, c + 2 < D ? row[c + 2] : 0.f,
                     c + 3 < D ? row[c + 3] : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One term group of a dot: s += x . y, in a fixed order with fused
// multiply-adds, so every dot of equal rows gives equal bits.
__device__ __forceinline__ float fma4(float4 x, float4 y, float s) {
  s = __fmaf_rn(x.x, y.x, s);
  s = __fmaf_rn(x.y, y.y, s);
  s = __fmaf_rn(x.z, y.z, s);
  return __fmaf_rn(x.w, y.w, s);
}

// sum(a * b) over D floats, in d4 = ceil(D / 4) groups of 4, by one warp;
// every lane gets it. The order depends on D alone.
template <bool VEC>
__device__ __forceinline__ float warp_dot(const float* a, const float* b, int D, int ln) {
  const int d4 = (D + 3) / 4;
  float s = 0.f;
#pragma unroll 8
  for (int i = ln; i < d4; i += 32) s = fma4(ld4<VEC>(a, i, D), ld4<VEC>(b, i, D), s);
  return warp_sum(s);
}

// One step of a butterfly reduce-scatter over the warp: each lane holds
// 2 OFF partial sums and keeps OFF of them, those whose index has bit OFF
// equal to its lane's, adding its partner's. After the steps 16..1 lane l
// holds the warp's sum of value l, in an order that is the same for every l.
template <int OFF>
__device__ __forceinline__ void reduce_scatter(float* acc, int ln) {
  const bool upper = ln & OFF;
#pragma unroll
  for (int p = 0; p < OFF; ++p) {
    const float send = upper ? acc[p] : acc[p + OFF];
    const float keep = upper ? acc[p + OFF] : acc[p];
    acc[p] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// (a, ia) comes before (b, ib): by value, NaN after every number, ties to
// the lower position (torch.sort(stable=True)'s order)
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ia < ib : nb;
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ int clamp_id(int id, int P) { return min(max(id, 0), P - 1); }

// The pool's rows behind the shard table; `first` is shards[0], read once.
struct PoolRows {
  const float* const* shards;
  const float* first;
  int shard_len, n_shards, D;

  __device__ PoolRows(const float* const* s, int len, int n, int d)
      : shards(s), first(s[0]), shard_len(len), n_shards(n), D(d) {}

  // row g, 0 <= g < P
  __device__ __forceinline__ const float* operator()(int g) const {
    if (n_shards == 1) return first + (size_t)g * D;
    return shards[g / shard_len] + (size_t)(g % shard_len) * D;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `count` arrivals complete a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// arrive once on `bar` and expect `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one TMA 1-D bulk copy of `bytes` (a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// 4 bytes (0: a zero) into shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src, unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes) : "memory");
}

// one arrival on `bar` once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Pool norms and source dots of the own candidates, one warp per dot:
// osd[0][t][l][j] = tgt[c] . svn[t] and osd[1][t][l][j] = tgt[min(c + 1,
// P - 1)] . svn[t + 1] (frame t+1's prev+1 candidate from own candidate j
// of frame t), with c = idx[t][l][j] clamped.
template <bool VEC>
__global__ void __launch_bounds__(PREPASS_THREADS)
concat_cost_prepass_kernel(const int* __restrict__ idx, const float* __restrict__ svn,
                           const float* const* __restrict__ shards, int shard_len,
                           int n_shards, float* __restrict__ pnorm, float* __restrict__ osd,
                           int T, int P, int D, int L, int k) {
  const int ln = threadIdx.x & 31;
  const PoolRows pool_row(shards, shard_len, n_shards, D);
  const long own = (long)T * L * k, items = P + 2 * own;
  const long warps = (long)gridDim.x * (PREPASS_THREADS / 32);
  for (long w = blockIdx.x * (PREPASS_THREADS / 32) + (threadIdx.x >> 5); w < items; w += warps) {
    if (w < P) {
      const float* row = pool_row((int)w);
      const float n = warp_dot<VEC>(row, row, D, ln);
      if (ln == 0) pnorm[w] = sqrtf(n);
    } else {
      const long e = (w - P) % own;              // (t, lane, j) of idx
      const int next = (int)((w - P) / own);     // 0: own, 1: own + 1
      const int t = (int)(e / ((long)L * k)) + next;
      const int id = min(clamp_id(idx[e], P) + next, P - 1);
      const float s =
          t < T ? warp_dot<VEC>(pool_row(id), svn + (size_t)t * D, D, ln) : 0.f;
      if (ln == 0) osd[w - P] = s;
    }
  }
}

// Per-frame scalars the selector reads, double-buffered by frame parity.
template <int KM>
struct FrameData {
  int oid[KM];                    // own candidate ids, clamped
  float onorm[KM], osd[KM], olf0[KM];
  int xid[2 * KM];                // min(S_{t-1}[q] + 1, P - 1)
  float xnorm[2 * KM], xsd[2 * KM], xlf0[2 * KM];
  float b, slf0;                  // baseline b_{t-1}, source log2 f0 of t
};

// Pick state of one frame, double-buffered by frame parity.
template <int KM>
struct Picks {
  int pos[KM];                    // candidate position of pick r
  float norm[KM];
  int at[KM];                     // its row: a ring offset, or a pool row id (L2)
};

// Cross dots of one frame, written by the dot warps for the selector. For
// k <= 4 each warp takes a slice of D for all k x 2k pairs and leaves one
// partial sum per pair (lane = pair j * 8 + c); above, each candidate's
// dots are whole.
template <int KM>
struct Cross {
  float v[KM <= 4 ? DOT_WARPS : KM][KM <= 4 ? 32 : 2 * KM];
};

template <int KM, bool SMEM, bool VEC>
__global__ void __launch_bounds__(THREADS)
concat_cost_chain_kernel(const int* __restrict__ idx, const float* __restrict__ svn,
                         const float* const* __restrict__ shards, int shard_len,
                         int n_shards, const float* __restrict__ baselines,
                         const float* __restrict__ src_lf0, const float* __restrict__ tgt_lf0,
                         const float* __restrict__ pnorm, const float* __restrict__ osd,
                         int* __restrict__ out, int T, int P, int D, int L, int k,
                         int pitched_mask, float concat_weight, float init_weight) {
  constexpr int NC = (2 * KM + 31) / 32;     // candidates per selector lane
  constexpr bool SPLIT = KM <= 4;            // cross dots split over D
  constexpr bool RV = SMEM || VEC;           // the chain's rows are 16-byte aligned
  // when the rows fit: own rows [3][k][DP], then prev+1 rows [3][2k][DP]
  extern __shared__ __align__(128) float ring[];
  __shared__ FrameData<KM> fd[2];
  __shared__ Picks<KM> pk[2];
  __shared__ Cross<KM> cross;
  __shared__ float tot[2 * KM];
  __shared__ __align__(8) uint64_t full[3];  // one mbarrier per ring slot

  const int lane = blockIdx.x;
  const bool pitched = (pitched_mask >> lane) & 1;
  const PoolRows pool_row(shards, shard_len, n_shards, D);
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int pt = tid - DOT_WARPS * 32, pw = pt >> 5;  // producer thread and warp
  const int DP = (D + 3) / 4 * 4, d4 = DP / 4, C = 2 * k;   // a ring row: DP floats
  // ring slots of frame f's own row j and prev+1 row q; a dot finds a row
  // by its "at": the slot's offset, or the pool row's id when the rows go to L2
  auto own_slot = [&](int f, int j) { return ring + ((size_t)(f % 3) * k + j) * DP; };
  auto x_slot = [&](int f, int q) { return ring + ((size_t)(3 + 2 * (f % 3)) * k + q) * DP; };
  auto own_at = [&](int f, int j, int id) { return SMEM ? ((f % 3) * k + j) * DP : id; };
  auto x_at = [&](int f, int q, int id) { return SMEM ? ((3 + 2 * (f % 3)) * k + q) * DP : id; };
  auto row_of = [&](int at) -> const float* {
    return SMEM ? ring + at : pool_row(at);
  };
  const unsigned row_bytes = (unsigned)D * sizeof(float);
  const int* idx0 = idx + (size_t)lane * k;
  int own_next = 0;  // producer thread C + j: raw own id j of the frame staged next
  // !VEC: n rows (row r: dst_of(r) <- pool row id_of(r)) by 4-byte copies
  // spread over the producer threads, zeros from D to DP, then this
  // thread's arrival on `bar`
  auto copy_rows4 = [&](int n, auto dst_of, auto id_of, uint64_t* bar) {
    for (int r = 0; r < n; ++r) {
      float* dst = dst_of(r);
      const float* src = pool_row(id_of(r));
      for (int c = pt; c < DP; c += PROD_THREADS) cp_async4(dst + c, src + (c < D ? c : 0),
                                                            c < D ? 4u : 0u);
    }
    cp_async_arrive(bar);
  };

  // Producers: stage frame f, given S_{f-1}'s ids through sid(q): one TMA
  // bulk copy per row into the ring slot (completing on full[f % 3]), the
  // scalars, the next frame's own ids and the k source dots the pre-pass
  // cannot know, all loads of one latency; nothing here waits for the rows.
  auto stage = [&](int f, auto sid) {
    FrameData<KM>& F = fd[f & 1];
    if (pt < C) F.xid[pt] = min(sid(pt) + 1, P - 1);
    else if (pt < 3 * k) F.oid[pt - C] = clamp_id(own_next, P);
    if (SMEM && VEC && pt == 0) mbar_expect_tx(&full[f % 3], 3u * k * row_bytes);
    bar_sync(2, PROD_THREADS);
    const bool is_x = pt < C, is_own = !is_x && pt < 3 * k, is_frame = pt == PROD_THREADS - 1;
    const int j = pt - C, id = is_x ? F.xid[pt] : is_own ? F.oid[j] : 0;
    if (SMEM && VEC && (is_x || is_own))
      bulk_copy(is_x ? x_slot(f, pt) : own_slot(f, j), pool_row(id), row_bytes, &full[f % 3]);
    if (SMEM && !VEC)
      copy_rows4(3 * k, [&](int r) { return r < C ? x_slot(f, r) : own_slot(f, r - C); },
                 [&](int r) { return r < C ? F.xid[r] : F.oid[r - C]; }, &full[f % 3]);
    // loads first, stores after, so they all wait on one latency
    float norm = 0.f, lf0 = 0.f, sdot = 0.f;
    if (is_x || is_own) {
      norm = pnorm[id];
      lf0 = pitched ? tgt_lf0[id] : 0.f;
    }
    if (is_own) {
      sdot = osd[((size_t)f * L + lane) * k + j];
      if (f + 1 < T) own_next = idx[((size_t)(f + 1) * L + lane) * k + j];
    } else if (is_x && pt < k) {  // own_{f-1} + 1: from the pre-pass
      sdot = osd[(size_t)T * L * k + ((size_t)(f - 1) * L + lane) * k + pt];
    }
    const float b = is_frame ? baselines[f - 1] : 0.f;
    const float slf0 = is_frame && pitched ? src_lf0[f] : 0.f;
    for (int q = k + pw; q < C; q += PROD_WARPS) {  // frame f-2's picks + 2
      const float s = warp_dot<VEC>(pool_row(F.xid[q]), svn + (size_t)f * D, D, ln);
      if (ln == 0) F.xsd[q] = s;
    }
    if (is_x) {
      if (pt < k) F.xsd[pt] = sdot;
      F.xnorm[pt] = norm;
      F.xlf0[pt] = lf0;
    } else if (is_own) {
      F.onorm[j] = norm;
      F.osd[j] = sdot;
      F.olf0[j] = lf0;
    } else if (is_frame) {
      F.b = b;
      F.slf0 = slf0;
    }
  };

  // a phase: the one bulk-copying thread's arrival (VEC) or every producer
  // thread's (4-byte copies)
  if (tid < 3) mbar_init(&full[tid], VEC ? 1u : (unsigned)PROD_THREADS);
  __syncthreads();
  // frame 0 passes through; its own rows are frame 1's previous picks
  if (warp == 0 && ln < k) {
    const int raw = idx0[ln], id = clamp_id(raw, P);
    out[(size_t)lane * k + ln] = raw;
    pk[0].pos[ln] = ln;
    pk[0].norm[ln] = pnorm[id];
    pk[0].at[ln] = own_at(0, ln, id);
  }
  if (warp >= DOT_WARPS && T > 1) {
    if (SMEM && VEC && pt == 0) mbar_expect_tx(&full[0], k * row_bytes);
    bar_sync(2, PROD_THREADS);
    if (SMEM && VEC && pt < k)
      bulk_copy(own_slot(0, pt), pool_row(clamp_id(idx0[pt], P)), row_bytes, &full[0]);
    if (SMEM && !VEC)
      copy_rows4(k, [&](int r) { return own_slot(0, r); },
                 [&](int r) { return clamp_id(idx0[r], P); }, &full[0]);
    if (pt >= C && pt < 3 * k) own_next = idx[((size_t)L + lane) * k + pt - C];
    stage(1, [&](int q) { return clamp_id(idx0[q % k], P); });
  }
  // carried by the selector (warp 0); unpitched lanes keep concat_weight
  float weight = pitched ? init_weight : concat_weight;
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const int par = t & 1, ppar = par ^ 1;
    const FrameData<KM>& F = fd[par];
    const Picks<KM>& prev = pk[ppar];
    if (warp < DOT_WARPS) {
      if (SMEM) {  // frame t's rows (and at t = 1 frame 0's) have landed
        if (t == 1) mbar_wait(&full[0], 0);
        mbar_wait(&full[t % 3], (t / 3) & 1);
      }
      auto cand_at = [&](int c) {
        if (c < k) return own_at(t, c, F.oid[c]);
        const int q = prev.pos[c - k];
        return x_at(t, q, F.xid[q]);
      };
      if constexpr (SPLIT) {
        // warp w sums the float4 w*32 + ln + 256 m of every pair, each row
        // read once; a butterfly leaves pair j * 8 + c's partial on lane it
        const float* c4[8];
        const float* p4[4];
        float acc[32];
#pragma unroll
        for (int c = 0; c < 8; ++c) c4[c] = row_of(cand_at(c < C ? c : 0));
#pragma unroll
        for (int j = 0; j < 4; ++j) p4[j] = row_of(prev.at[j < k ? j : 0]);
#pragma unroll
        for (int p = 0; p < 32; ++p) acc[p] = 0.f;
        for (int i = warp * 32 + ln; i < d4; i += DOT_WARPS * 32) {
          float4 y[8], x[4];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < C) y[c] = ld4<RV>(c4[c], i, D);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < k) x[j] = ld4<RV>(p4[j], i, D);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (j < k && c < C) acc[j * 8 + c] = fma4(x[j], y[c], acc[j * 8 + c]);
        }
        reduce_scatter<16>(acc, ln);
        reduce_scatter<8>(acc, ln);
        reduce_scatter<4>(acc, ln);
        reduce_scatter<2>(acc, ln);
        reduce_scatter<1>(acc, ln);
        cross.v[warp][ln] = acc[0];
      } else {
        // warp w takes candidates w, w + 8, ...: its row read once for all picks
        for (int c = warp; c < C; c += DOT_WARPS) {
          const float* c4 = row_of(cand_at(c));
          const float* p4[KM];
          float acc[KM];
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            p4[j] = row_of(prev.at[j < k ? j : 0]);
            acc[j] = 0.f;
          }
          for (int i = ln; i < d4; i += 32) {
            const float4 y = ld4<RV>(c4, i, D);
#pragma unroll
            for (int j = 0; j < KM; ++j)
              if (j < k) acc[j] = fma4(ld4<RV>(p4[j], i, D), y, acc[j]);
          }
#pragma unroll
          for (int j = 0; j < KM; ++j)
            if (j < k) {
              const float s = warp_sum(acc[j]);
              if (ln == 0) cross.v[j][c] = s;
            }
        }
      }
      if (warp != 0) {
        bar_arrive(1, DOT_WARPS * 32);
      } else {
        bar_sync(1, DOT_WARPS * 32);
        // the selector: costs, medians and the picks of frame t
        const bool low = F.b < 0.08f;
        const float w = (pitched && !low) ? 0.f : weight;
        Picks<KM>& next = pk[par];
        // where pair (j, c)'s dot is, and where its concat cost goes
        auto pair = [&](int j, int c) -> float& {
          if constexpr (SPLIT) return cross.v[0][j * 8 + c];
          else return cross.v[j][c];
        };
        // 1. the concat cost of every pair (j, c), one pair per lane
        for (int p = ln; p < k * C; p += 32) {
          const int j = p / C, c = p - j * C;
          float x = pair(j, c);
          if constexpr (SPLIT) {  // the dot warps' partial sums, in warp order
#pragma unroll
            for (int s = 1; s < DOT_WARPS; ++s) x += cross.v[s][j * 8 + c];
          }
          const float cn = c < k ? F.onorm[c] : F.xnorm[prev.pos[c - k]];
          float v = __fsub_rn(1.f, __fdiv_rn(x, __fmul_rn(prev.norm[j], cn)));
          if (pitched) {
            if (low && v < __fmul_rn(5.f, F.b)) v = 0.f;
          } else if (v > F.b) {
            v = __fsub_rn(__fmul_rn(1.5f, v), F.b);
          }
          pair(j, c) = v;
        }
        __syncwarp();
        // 2. each candidate's median (torch.median: the value of rank
        // (k-1)/2) and total
        int cid[NC];
        float cnorm[NC];
        int cat[NC];
#pragma unroll
        for (int h = 0; h < NC; ++h) {
          const int c = ln + 32 * h;
          if (c >= C) continue;
          float sd, lf;
          if (c < k) {
            cid[h] = F.oid[c];
            cnorm[h] = F.onorm[c];
            sd = F.osd[c];
            lf = F.olf0[c];
          } else {
            const int q = prev.pos[c - k];
            cid[h] = F.xid[q];
            cnorm[h] = F.xnorm[q];
            sd = F.xsd[q];
            lf = F.xlf0[q];
          }
          cat[h] = cand_at(c);
          float med = pair(0, c);
          if constexpr (KM <= 8) {  // in registers, unrolled
            float cc[KM];
#pragma unroll
            for (int j = 0; j < KM; ++j)
              if (j < k) cc[j] = pair(j, c);
#pragma unroll
            for (int j = 0; j < KM; ++j) {
              if (j >= k) break;
              int r = 0;
#pragma unroll
              for (int i = 0; i < KM; ++i)
                if (i < k && before(cc[i], i, cc[j], j)) ++r;
              if (r == (k - 1) / 2) med = cc[j];
            }
          } else {                  // large k: from shared memory
            for (int j = 0; j < k; ++j) {
              const float v = pair(j, c);
              int r = 0;
              for (int i = 0; i < k; ++i) r += before(pair(i, c), i, v, j);
              if (r == (k - 1) / 2) med = v;
            }
          }
          const float matching = __fsub_rn(1.f, __fdiv_rn(sd, cnorm[h]));
          float total = __fadd_rn(__fmul_rn(w, med), matching);
          if (pitched) total = __fadd_rn(total, fabsf(__fsub_rn(lf, F.slf0)));
          tot[c] = total;
        }
        __syncwarp();
        // 3. one round: candidate c's rank is the count of those before it
#pragma unroll
        for (int h = 0; h < NC; ++h) {
          const int c = ln + 32 * h;
          if (c >= C) continue;
          const float v = tot[c];
          int r = 0;
#pragma unroll
          for (int o = 0; o < 2 * KM; ++o)
            if (o < C) r += before(tot[o], o, v, c);
          if (r < k) {
            out[((size_t)t * L + lane) * k + r] = cid[h];
            next.pos[r] = c;
            next.norm[r] = cnorm[h];
            next.at[r] = cat[h];
          }
        }
        weight = w;
      }
    } else if (t + 1 < T) {
      // producers: frame t+1, from S_t = own_t, then frame t-1's picks + 1
      stage(t + 1, [&](int q) { return q < k ? F.oid[q] : F.xid[prev.pos[q - k]]; });
    }
    __syncthreads();
  }
}

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return optin;
}

// bytes of dynamic shared memory: the 9 k rows of DP floats when they fit
// beside the static arrays, else 0; negative on a CUDA error
template <int KM, bool VEC>
long dyn_bytes(int k, int D) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, concat_cost_chain_kernel<KM, true, VEC>) != cudaSuccess)
    return -1;
  const long rows = 9L * k * ((D + 3) / 4 * 4) * (long)sizeof(float);
  const int optin = smem_optin();
  if (optin < 0) return -1;
  return (long)attr.sharedSizeBytes + rows <= optin ? rows : 0;
}

template <int KM, bool VEC>
int launch_chain(const int* idx, const float* svn, const float* const* shards, int shard_len,
                 int n_shards, const float* baselines, const float* src_lf0, const float* tgt_lf0,
                 const float* pnorm, const float* osd, int* out, int T, int P, int D, int L,
                 int k, int pitched_mask, float concat_weight, float init_weight,
                 cudaStream_t stream) {
  const long bytes = dyn_bytes<KM, VEC>(k, D);
  if (bytes < 0) return (int)cudaGetLastError();
  auto kernel = bytes ? concat_cost_chain_kernel<KM, true, VEC>
                      : concat_cost_chain_kernel<KM, false, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<L, THREADS, bytes, stream>>>(idx, svn, shards, shard_len, n_shards, baselines,
                                        src_lf0, tgt_lf0, pnorm, osd, out, T, P, D, L, k,
                                        pitched_mask, concat_weight, init_weight);
  return (int)cudaGetLastError();
}

// the chain compiled for the smallest KM >= k
template <bool VEC>
int launch_chain_k(const int* idx, const float* svn, const float* const* shards, int shard_len,
                   int n_shards, const float* baselines, const float* src_lf0,
                   const float* tgt_lf0, const float* pnorm, const float* osd, int* out, int T,
                   int P, int D, int L, int k, int pitched_mask, float concat_weight,
                   float init_weight, cudaStream_t s) {
  if (k <= 4)
    return launch_chain<4, VEC>(idx, svn, shards, shard_len, n_shards, baselines, src_lf0,
                                tgt_lf0, pnorm, osd, out, T, P, D, L, k, pitched_mask,
                                concat_weight, init_weight, s);
  if (k <= 8)
    return launch_chain<8, VEC>(idx, svn, shards, shard_len, n_shards, baselines, src_lf0,
                                tgt_lf0, pnorm, osd, out, T, P, D, L, k, pitched_mask,
                                concat_weight, init_weight, s);
  return launch_chain<32, VEC>(idx, svn, shards, shard_len, n_shards, baselines, src_lf0,
                               tgt_lf0, pnorm, osd, out, T, P, D, L, k, pitched_mask,
                               concat_weight, init_weight, s);
}

bool bad_shape(int T, int P, int D, int L, int k, int shard_len, int n_shards) {
  return T <= 0 || P <= 0 || D <= 0 || L <= 0 || L > MAX_LANES || k < 1 || k > MAX_K ||
         shard_len <= 0 || n_shards <= 0 || (long)shard_len * n_shards < P;
}

}  // namespace

extern "C" {

// The pre-pass alone, on `stream`: pnorm (P,) and osd (2, T, L, k) fp32.
// shards: a device array of the pool's n_shards shard base pointers,
// shard_len rows each (one pointer and shard_len = P for a dense pool).
int concat_cost_prepass_f32(const int* idx, const float* svn, const float* const* shards,
                            int shard_len, int n_shards, float* pnorm, float* osd, int T, int P,
                            int D, int L, int k, void* stream) {
  if (bad_shape(T, P, D, L, k, shard_len, n_shards)) return (int)cudaErrorInvalidValue;
  const long items = (long)P + 2L * T * L * k;
  const long per_block = PREPASS_THREADS / 32;
  const int blocks = (int)std::min<long>((items + per_block - 1) / per_block, 132L * 8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0)
    concat_cost_prepass_kernel<true><<<blocks, PREPASS_THREADS, 0, s>>>(
        idx, svn, shards, shard_len, n_shards, pnorm, osd, T, P, D, L, k);
  else
    concat_cost_prepass_kernel<false><<<blocks, PREPASS_THREADS, 0, s>>>(
        idx, svn, shards, shard_len, n_shards, pnorm, osd, T, P, D, L, k);
  return (int)cudaGetLastError();
}

// The whole reselection on `stream`: the pre-pass, then one chain block per
// lane; returns the cudaError_t of the launches (0 = success). idx and out
// are (T, L, k) int32, svn (T, D), the pool's rows behind the shard table
// (P of them, shard_len per shard), baselines (T-1,), src_lf0
// (T,) and tgt_lf0 (P,) fp32; pnorm (P,) and osd (2, T, L, k) fp32 scratch; all
// contiguous and 16-byte aligned (4-byte for the rows and svn when
// D % 4 != 0; checked by the Python wrapper); any D >= 1; the f0
// tracks may be null when no lane is pitched. The pitched lanes' weight
// starts at init_weight (concat_weight for a whole utterance, the carried
// weight for a streaming chunk whose frame 0 is the carry).
int concat_cost_pair_f32(const int* idx, const float* svn, const float* const* shards,
                         int shard_len, int n_shards, const float* baselines,
                         const float* src_lf0, const float* tgt_lf0, float* pnorm, float* osd,
                         int* out, int T, int P, int D, int L, int k, int pitched_mask,
                         float concat_weight, float init_weight, void* stream) {
  if (bad_shape(T, P, D, L, k, shard_len, n_shards)) return (int)cudaErrorInvalidValue;
  if (pitched_mask && (src_lf0 == nullptr || tgt_lf0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = concat_cost_prepass_f32(idx, svn, shards, shard_len, n_shards, pnorm, osd, T,
                                          P, D, L, k, stream);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  return D % 4 == 0
             ? launch_chain_k<true>(idx, svn, shards, shard_len, n_shards, baselines, src_lf0,
                                    tgt_lf0, pnorm, osd, out, T, P, D, L, k, pitched_mask,
                                    concat_weight, init_weight, s)
             : launch_chain_k<false>(idx, svn, shards, shard_len, n_shards, baselines, src_lf0,
                                     tgt_lf0, pnorm, osd, out, T, P, D, L, k, pitched_mask,
                                     concat_weight, init_weight, s);
}

// Lets the current device's kernels read `peer`'s memory (a shard on
// another card); 0 when enabled now or before.
int concat_cost_enable_peer_access(int peer) {
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it left
    return 0;
  }
  return (int)err;
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
