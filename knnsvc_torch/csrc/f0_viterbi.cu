// Viterbi smoothing of the device f0 extractor, fp32, for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (knnsvc_torch/ops/build.py, ops/viterbi.py).
//
// Replaces knnsvc_tpu/dsp/f0_device.py::_viterbi (:204) with its distance
// transform _dt_min (:187): in the JAX package an XLA lax.scan over frames
// (forward :234, backtrack :247), not a Pallas kernel. Its plain version is
// knnsvc_torch/ops/viterbi.py::viterbi_plain.
//
// The recursion, per frame t over C voiced states and one unvoiced state C
// (running costs dv (C,), du):
//   best_v[j], arg_v[j] = min_i dv[i] + lam_s |i - j|: the leftmost argmin
//       of a left cumulative min of dv[i] - i lam_s, plus j lam_s, against
//       the rightmost argmin of a right cumulative min of dv[i] + i lam_s,
//       minus j lam_s; left wins ties
//   new_dv[j] = min(best_v[j], du + switch) + cost_v[t][j]
//   ptr_v[j]  = best_v[j] <= du + switch ? arg_v[j] : C
//   new_du    = min(du, min(dv) + switch) + cost_u[t],
//   ptr_u     = du <= min(dv) + switch ? C : argmin(dv) (first minimum)
//   dv, du    = new_dv - m, new_du - m with m = min(min(new_dv), new_du)
// then a backtrack from argmin(dv) (or C) at the last frame.
//
// What bounds it. At the main path's shape (N = 1501 frames, C = 482) the
// least work is reading the (N, C) costs once and writing and reading the
// pointers: ~4.4 MB, ~1.3 us at 3.35 TB/s, and ~5 M additions. Neither
// limits it: frame t needs frame t-1's costs, so the kernel is a chain of N
// dependent steps, bound by the latency of one step on one SM. The design
// spreads each step over the SM's four schedulers and keeps loads off it:
//   - one block of WARPS = 4 chain warps, one per scheduler, and a producer
//     warp. Chain thread i holds states PER i .. PER i + PER - 1 in
//     registers: PER = 4 for C + 1 <= 512 (the main path's C = 482), 8 for
//     C + 1 <= 1024 (template parameter PER). Each cumulative min is a
//     serial pass over the thread's PER values, a 5-level shuffle scan over
//     the warp's lanes and a cross-warp level. A warp's first min/argmin of dv is two redux.sync on
//     an order-preserving integer key (-0 and +0 share a key, so they tie as
//     floats do);
//   - two exchanges a frame through shared memory, each behind the chain's
//     named barrier (bar.sync 1, 128; the producer never joins it): the
//     warps' left totals, right totals and min/argmin of dv, then the warps'
//     mins of new_dv for m. The second cannot fold into the next frame's
//     first: dv is rounded after - m and before the next frame's - i lam_s.
//     The slots are indexed by frame parity, so a slot is written again two
//     barriers after it was read;
//   - the producer warp stages the emission rows in a ring of RING = 8 rows
//     in shared memory, up to RING frames ahead of the chain, by cp.async: 16
//     bytes for a row's aligned interior and 4 for the up to 3 floats at
//     either end and cost_u[t] (a row of C = 482 floats is 1928 B, not a
//     multiple of 16, so neither cp.async.bulk nor a TMA tensor map addresses
//     it in place, and padding cost_v would cost a copy). Each lane's
//     cp.async.mbarrier.arrive completes a slot's `full` mbarrier when its
//     copies have landed; thread 0 arrives on the slot's `empty` mbarrier once
//     the chain has read it. The chain waits on `full` every WAIT_EVERY = 4
//     frames, for the 4th row ahead: an arrive fires only when all of the
//     lane's earlier copies have landed too. Copies issued by a chain warp
//     stall it: that is why a warp of its own issues them;
//   - the pointers go to global memory as int16 in rows of 128 PER (ptr_u
//     in slot C, so the backtrack reads one table), 1 KB a frame at PER = 4,
//     1.5 MB for a 30-s chunk, which stays in L2; a frame's row is stored
//     while the next frame scans. The backtrack stages blocks of 64 KB of
//     rows (BACK_ROWS = 32 at PER = 4) into two shared buffers by 16-byte
//     cp.async: warps 1-4 fetch block b + 1 while thread 0 walks block b,
//     one dependent shared read a frame. The buffers alias the ring,
//     drained by then.
// Exactness, which no partition may break: every elementwise cost operation
// is an __f*_rn intrinsic in the plain version's order (no contracted
// multiply-add, e.g. of dv - i * lam_s); the min/argmin combines are exact
// and associative, and every level (within a thread, across lanes, across
// warps, the carries into a thread) keeps the plain version's ties:
//   - the left scan keeps the leftmost index (the earlier segment wins on <=);
//   - the right scan keeps the rightmost index (the later segment wins on <=);
//   - left wins over right on <=;
//   - argmin takes the first minimum;
//   - ptr_v takes C on best > du + switch, and ptr_u takes C on
//     du <= min(dv) + switch.
// So the states equal the plain version's on every frame.
//
// Above 1024 states the running costs move to shared memory
// (f0_viterbi_smem_kernel below: 16 chain warps, up to 16384 states, which
// covers the JAX package's grid_cents down to about 0.3; int16 pointers
// hold state indices up to 16383). The wrapper asks f0_viterbi_pitch for
// the instance's pointer row length.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_STATES = 16384;              // C + 1 <= 16384: int16 pointers hold C
constexpr int WARPS = 4;                       // chain warps, one per scheduler of the SM
constexpr int CHAIN = 32 * WARPS;              // their threads
constexpr int THREADS = CHAIN + 32;            // and the producer warp
constexpr int RING = 8;                        // emission rows staged ahead
constexpr int WAIT_EVERY = 4;                  // the chain checks the ring every 4 frames
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS >= 1 && WARPS <= 4, "exchange slots are 4 wide");
static_assert(WAIT_EVERY <= RING, "the producer can run WAIT_EVERY rows ahead");

// The register instance of PER states a chain thread: CHAIN * PER states
// (C + 1 <= 512 at PER = 4, the main path's, and 1024 at PER = 8), int16
// pointer rows of as many, ring rows of as many floats and 4 more (a row
// starts at its offset from a 16-byte boundary), and backtrack blocks of
// 64 KB of pointer rows
template <int PER>
struct Reg {
  static constexpr int STATES = CHAIN * PER;
  static constexpr int PTR_PITCH = STATES;
  static constexpr int ROW = STATES + 4;
  static constexpr int BACK_ROWS = 32 * 512 / PTR_PITCH;
  static_assert(PER % 4 == 0 && BACK_ROWS >= 1, "4 states a pointer store");
  struct Ring {                                // the forward pass's emission rows
    float v[RING][ROW];
    float u[RING];
  };
  struct Back {                                // the backtrack's two pointer blocks
    int16_t rows[2][BACK_ROWS][PTR_PITCH];
  };
  static constexpr int SMEM_BYTES =
      sizeof(Back) > sizeof(Ring) ? (int)sizeof(Back) : (int)sizeof(Ring);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst: an address in the shared window (smem_addr), computed once per kernel
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// `bytes` (4 or 0) copied, the rest of the 4 zero-filled
__device__ __forceinline__ void cp_async4z(unsigned dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the mbarrier completes its phase when this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void chain_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CHAIN) : "memory");
}

// a signed integer in the order of the floats, -0 and +0 both 0 (NaN excluded)
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : -(i & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : (-k) | (int)0x80000000);
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const int* p, int* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <int PER>
__global__ void __launch_bounds__(THREADS, 1)
f0_viterbi_kernel(const float* __restrict__ cost_v, const float* __restrict__ cost_u,
                  int16_t* ptrs, int* __restrict__ states, int N, int C,
                  float lam_s, float sw) {
  using Ring = typename Reg<PER>::Ring;
  using Back = typename Reg<PER>::Back;
  constexpr int STATES = Reg<PER>::STATES, PTR_PITCH = Reg<PER>::PTR_PITCH;
  constexpr int ROW = Reg<PER>::ROW, BACK_ROWS = Reg<PER>::BACK_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  Ring& ring = *reinterpret_cast<Ring*>(smem);
  Back& back = *reinterpret_cast<Back*>(smem);
  // ring slot s holds frame f = s + 1 + n RING in its n-th use: `full` when
  // the producer's copies have landed, `empty` when the chain has read it
  __shared__ __align__(8) uint64_t full[RING], empty[RING];
  // the chain's exchanges, [frame parity][field][warp]: the warps' left and
  // right totals (float bits) and their indices, the key and index of each
  // warp's first min of dv, and the key of each warp's min of new_dv
  enum { X_LV, X_LI, X_RV, X_RI, X_MK, X_MI, X_NK, X_FIELDS = 8 };
  __shared__ __align__(16) int xch[2][X_FIELDS][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float INF = __int_as_float(0x7f800000);
  const unsigned v_words = (unsigned)(reinterpret_cast<uintptr_t>(cost_v) >> 2);
  const unsigned full_s = smem_addr(&full[0]), empty_s = smem_addr(&empty[0]);
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full_s + 8 * i, 32);           // one cp.async arrival per producer lane
      mbar_init(empty_s + 8 * i, 1);           // one arrival from the chain
    }
  }
  __syncthreads();
  // frame f's offset in floats from a 16-byte boundary
  auto row_offset = [&](int f) { return (int)((v_words + (unsigned)f * (unsigned)C) & 3u); };

  int s = C;                                   // the last frame's state, in thread 0
  if (warp == WARPS) {
    // the producer: frame f's row to ring.v[slot][o + j], o = row_offset(f),
    // by 16-byte copies of its aligned interior and one 4-byte copy per lane
    // for the up to 3 floats at either ragged end and for cost_u[f]
    const unsigned ring_v = smem_addr(&ring.v[0][0]), ring_u = smem_addr(&ring.u[0]);
    for (int f = 1; f < N; ++f) {
      const int slot = (f - 1) % RING, use = (f - 1) / RING;
      if (use > 0) mbar_wait(empty_s + 8 * slot, (use - 1) & 1);
      const int o = row_offset(f);
      const int head = min((4 - o) & 3, C);
      const int nq = (C - head) >> 2;
      const float* src = cost_v + (size_t)f * C;
      const unsigned dst = ring_v + (unsigned)(slot * ROW + o) * 4u;
#pragma unroll
      for (int r = 0; r < STATES / 4 / 32; ++r) {
        const int q = lane + 32 * r;
        if (q < nq) cp_async16(dst + 4u * (head + 4 * q), src + head + 4 * q);
      }
      const bool is_u = lane == 6;
      const int j = lane < 3 ? lane : head + 4 * nq + lane - 3;
      if (is_u || (lane < 3 ? lane < head : lane < 6 && j < C))
        cp_async4(is_u ? ring_u + 4u * slot : dst + 4u * j, is_u ? cost_u + f : src + j);
      cp_async_arrive(full_s + 8 * slot);
    }
  } else {
    const int base = tid * PER;
    float shift[PER], dv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = base + k;
      shift[k] = __fmul_rn((float)j, lam_s);
      dv[k] = j < C ? cost_v[j] : INF;
    }
    float du = cost_u[0];

    uint32_t packed[PER / 2];                  // a frame's pointers, stored during the next
    for (int t = 1; t < N; ++t) {
      const int par = t & 1, slot = (t - 1) % RING;
      // pointer row t-2 maps frame t-1's state to frame t-2's; slot C is ptr_u
      if (t > 1) {
        uint2* row = reinterpret_cast<uint2*>(ptrs + (size_t)(t - 2) * PTR_PITCH + base);
#pragma unroll
        for (int q = 0; q < PER / 4; ++q) row[q] = make_uint2(packed[2 * q], packed[2 * q + 1]);
      }
      if ((t - 1) % WAIT_EVERY == 0) {       // rows t .. t + WAIT_EVERY - 1 have landed
        const int last = min(t + WAIT_EVERY - 1, N - 1);
        mbar_wait(full_s + 8 * ((last - 1) % RING), ((last - 1) / RING) & 1);
      }
      const int o = row_offset(t);
      float ev[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) ev[k] = ring.v[slot][o + base + k];
      const float eu = ring.u[slot];

      // within the thread: the left (leftmost) and right (rightmost)
      // cumulative mins and the first min of dv, interleaved
      float mv = dv[0];
      int mi = base;
      float lv[PER], rv[PER];
      int li[PER], ri[PER];
      lv[0] = __fsub_rn(dv[0], shift[0]);
      li[0] = base;
      rv[PER - 1] = __fadd_rn(dv[PER - 1], shift[PER - 1]);
      ri[PER - 1] = base + PER - 1;
#pragma unroll
      for (int k = 1; k < PER; ++k) {
        if (dv[k] < mv) { mv = dv[k]; mi = base + k; }
        const float a = __fsub_rn(dv[k], shift[k]);
        if (lv[k - 1] <= a) { lv[k] = lv[k - 1]; li[k] = li[k - 1]; }
        else { lv[k] = a; li[k] = base + k; }
        const int q = PER - 1 - k;
        const float b = __fadd_rn(dv[q], shift[q]);
        if (rv[q + 1] <= b) { rv[q] = rv[q + 1]; ri[q] = ri[q + 1]; }
        else { rv[q] = b; ri[q] = base + q; }
      }
      // across the warp's lanes: inclusive prefix (left) and suffix (right)
      // scans of the thread totals, the earlier (left) or later (right)
      // segment winning ties; the first min by redux on its key
      float lt = lv[PER - 1], rt = rv[0];
      int lti = li[PER - 1], rti = ri[0];
      const int mkey = order_key(mv);
      const int wkey = __reduce_min_sync(FULL, mkey);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        // a lane with no source lane gets its own value back: no change
        const float ol = __shfl_up_sync(FULL, lt, off);
        const int oli = __shfl_up_sync(FULL, lti, off);
        const float orr = __shfl_down_sync(FULL, rt, off);
        const int ori = __shfl_down_sync(FULL, rti, off);
        if (ol <= lt) { lt = ol; lti = oli; }
        if (orr <= rt) { rt = orr; rti = ori; }
      }
      const int widx = __reduce_min_sync(FULL, mkey == wkey ? mi : 0x7fffffff);
      if (lane == 31) {
        xch[par][X_LV][warp] = __float_as_int(lt);
        xch[par][X_LI][warp] = lti;
      }
      if (lane == 0) {
        xch[par][X_RV][warp] = __float_as_int(rt);
        xch[par][X_RI][warp] = rti;
        xch[par][X_MK][warp] = wkey;
        xch[par][X_MI][warp] = widx;
      }
      // the lanes before and after this one, while the barrier waits
      const float pl = __shfl_up_sync(FULL, lt, 1);
      const int pli = __shfl_up_sync(FULL, lti, 1);
      const float pr = __shfl_down_sync(FULL, rt, 1);
      const int pri = __shfl_down_sync(FULL, rti, 1);
      chain_sync();
      if (tid == 0) mbar_arrive(empty_s + 8 * slot);   // every chain thread has read it

      float wl[4], wr[4];
      int wli[4], wri[4], wk[4], wmi[4];
      load4(reinterpret_cast<const float*>(xch[par][X_LV]), wl); load4(xch[par][X_LI], wli);
      load4(reinterpret_cast<const float*>(xch[par][X_RV]), wr); load4(xch[par][X_RI], wri);
      load4(xch[par][X_MK], wk); load4(xch[par][X_MI], wmi);
      // the left carry into this thread: the warps before it, then the lanes
      // before it (the earlier wins ties); with neither, its own first value,
      // which no lv[k] loses to
      float sl = wl[0];
      int sli = wli[0];
#pragma unroll
      for (int w = 1; w < WARPS - 1; ++w)
        if (w < warp && wl[w] < sl) { sl = wl[w]; sli = wli[w]; }
      const bool take_wl = warp > 0 && (lane == 0 || sl <= pl);
      const float cl = take_wl ? sl : (lane > 0 ? pl : lv[0]);
      const int cli = take_wl ? sli : (lane > 0 ? pli : base);
      // the right carry: the lanes after it, then the warps after it (the
      // later wins ties); with neither, its own last value
      float sr = wr[WARPS - 1];
      int sri = wri[WARPS - 1];
#pragma unroll
      for (int w = WARPS - 2; w > 0; --w)
        if (w > warp && wr[w] < sr) { sr = wr[w]; sri = wri[w]; }
      const bool take_wr = warp < WARPS - 1 && (lane == 31 || sr <= pr);
      const float cr = take_wr ? sr : (lane < 31 ? pr : rv[PER - 1]);
      const int cri = take_wr ? sri : (lane < 31 ? pri : base + PER - 1);
      // the first min of dv: the earlier warp wins ties
      int gkey = wk[0], gmi = wmi[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        if (wk[w] < gkey) { gkey = wk[w]; gmi = wmi[w]; }

      const float stay_u = __fadd_rn(du, sw);
      float nd[PER];
      int ptr[PER];
      float mloc = INF;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        float l = lv[k], r = rv[k];
        int il = li[k], ir = ri[k];
        if (cl <= l) { l = cl; il = cli; }
        if (cr <= r) { r = cr; ir = cri; }
        l = __fadd_rn(l, shift[k]);
        r = __fsub_rn(r, shift[k]);
        const bool take_l = l <= r;
        const float best = take_l ? l : r;
        const int arg = take_l ? il : ir;
        nd[k] = base + k < C ? __fadd_rn(fminf(best, stay_u), ev[k]) : INF;
        ptr[k] = best <= stay_u ? arg : C;
        mloc = fminf(mloc, nd[k]);
      }
      const int nkey = __reduce_min_sync(FULL, order_key(mloc));
      if (lane == 0) xch[par][X_NK][warp] = nkey;
      const float from_v = __fadd_rn(key_value(gkey), sw);
      const float new_du = __fadd_rn(fminf(du, from_v), eu);
      const int ptr_u = du <= from_v ? C : gmi;
#pragma unroll
      for (int k = 0; k < PER; k += 2) {
        const int p0 = base + k == C ? ptr_u : ptr[k];
        const int p1 = base + k + 1 == C ? ptr_u : ptr[k + 1];
        packed[k / 2] = (uint32_t)(uint16_t)p0 | ((uint32_t)(uint16_t)p1 << 16);
      }
      chain_sync();

      int mk[4];
      load4(xch[par][X_NK], mk);
      int mkmin = mk[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mkmin = min(mkmin, mk[w]);
      const float m = fminf(key_value(mkmin), new_du);
#pragma unroll
      for (int k = 0; k < PER; ++k) dv[k] = __fsub_rn(nd[k], m);   // pads stay INF
      du = __fsub_rn(new_du, m);
    }
    if (N > 1) {
      uint2* row = reinterpret_cast<uint2*>(ptrs + (size_t)(N - 2) * PTR_PITCH + base);
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) row[q] = make_uint2(packed[2 * q], packed[2 * q + 1]);
    }

    // the last frame's state: first argmin of dv, or unvoiced
    float mv = dv[0];
    int mi = base;
#pragma unroll
    for (int k = 1; k < PER; ++k)
      if (dv[k] < mv) { mv = dv[k]; mi = base + k; }
    const int par = N & 1;
    const int mkey = order_key(mv);
    const int wkey = __reduce_min_sync(FULL, mkey);
    const int widx = __reduce_min_sync(FULL, mkey == wkey ? mi : 0x7fffffff);
    if (lane == 0) { xch[par][X_MK][warp] = wkey; xch[par][X_MI][warp] = widx; }
    chain_sync();
    int wk[4], wmi[4];
    load4(xch[par][X_MK], wk); load4(xch[par][X_MI], wmi);
    int gkey = wk[0];
    mi = wmi[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (wk[w] < gkey) { gkey = wk[w]; mi = wmi[w]; }
    s = key_value(gkey) <= du ? mi : C;
    if (tid == 0) states[N - 1] = s;
  }
  // the ring is drained (the chain waited for every row the producer
  // copied) and the pointer rows are written
  __syncthreads();
  if (N < 2) return;

  // backtrack: block b holds pointer rows hi_b - BACK_ROWS + 1 .. hi_b, hi_b =
  // N - 2 - b BACK_ROWS; warps 1.. fetch block b + 1 while thread 0 walks b
  const int nblk = (N - 1 + BACK_ROWS - 1) / BACK_ROWS;
  const bool fetcher = warp > 0;
  const int ftid = tid - 32;
  constexpr int FTHREADS = THREADS - 32;
  constexpr int ROW_VECS = PTR_PITCH * 2 / 16;   // 16-byte pieces per row
  const unsigned back_s = smem_addr(&back.rows[0][0][0]);
  auto fetch = [&](int b) {
    const int hi = N - 2 - b * BACK_ROWS;
    const int lo = hi - BACK_ROWS + 1 > 0 ? hi - BACK_ROWS + 1 : 0;
    const int n = (hi - lo + 1) * ROW_VECS;
    const uint4* src = reinterpret_cast<const uint4*>(ptrs + (size_t)lo * PTR_PITCH);
    const unsigned dst = back_s + (unsigned)(b & 1) * (unsigned)sizeof(back.rows[0]);
    for (int i = ftid; i < n; i += FTHREADS) cp_async16(dst + 16u * i, src + i);
    cp_async_commit();
  };
  if (fetcher) fetch(0);
  for (int b = 0; b < nblk; ++b) {
    if (fetcher) cp_async_wait_all();          // block b has landed
    __syncthreads();                           // for all; and the walk of b - 1 is over
    if (fetcher && b + 1 < nblk) fetch(b + 1);
    if (tid == 0) {
      const int hi = N - 2 - b * BACK_ROWS;
      const int lo = hi - BACK_ROWS + 1 > 0 ? hi - BACK_ROWS + 1 : 0;
      const int16_t* rows = &back.rows[b & 1][0][0];
      for (int t = hi; t >= lo; --t) {
        s = rows[(t - lo) * PTR_PITCH + s];
        states[t] = s;
      }
    }
  }
}

// The shared-memory instance, for C + 1 above what registers hold: SW = 16
// chain warps (512 threads, no producer warp) of PER states each, up to
// 512 PER states (16384 at PER = 32). The running costs dv and the right
// scan's values and indices live in shared memory, state j = base + k of
// thread tid (base = tid * PER) at [k][tid], so a warp's 32 lanes read 32
// banks; so do the frame's emission costs, which each thread copies for its
// own states by 4-byte cp.async while the previous frame's barriers wait
// (registers would not hold them at PER = 32). A frame is three passes
// over the thread's PER states:
//   1. dv = new_dv - m (the previous frame's lowering), and the thread's
//      left total, right total and first min of dv;
//   2. then the same warp scans and cross-warp carries as the register
//      instance, over SW warp slots; descending from the right carry, the
//      running right min (a carry wins ties, as in rv[k] after it) minus
//      shift, to shared memory;
//   3. ascending from the left carry, the running left min plus shift
//      against the stored right value: new_dv, the pointers and their min.
// A running min from a carry equals the carry combined with the thread's
// own cumulative min, ties included, so the states are those of the
// register instance. The loops over a thread's states unroll by 4, not
// fully: fully unrolled, the PER = 32 instance spilled 12 bytes at the 128
// registers a thread of a 512-thread block may hold. The backtrack is
// thread 0's walk over the pointer rows in device memory (L2), one
// dependent load a frame.
constexpr int SW = 16;
constexpr int SCHAIN = 32 * SW;

template <int PER>
struct Smem {
  static constexpr int STATES = SCHAIN * PER;
  static constexpr int PTR_PITCH = STATES;
  // dv, the right scan's values, the emission costs (float) and the right
  // scan's indices (int16)
  static constexpr int SMEM_BYTES = 3 * STATES * 4 + STATES * 2;
  static_assert(SMEM_BYTES + 1024 <= 232448, "fits an H100 block beside the exchange slots");
  static_assert(PER % 4 == 0 && STATES <= MAX_STATES, "4 states a pointer store");
};

template <int PER>
__global__ void __launch_bounds__(SCHAIN, 1)
f0_viterbi_smem_kernel(const float* __restrict__ cost_v, const float* __restrict__ cost_u,
                       int16_t* ptrs, int* __restrict__ states, int N, int C, float lam_s,
                       float sw) {
  constexpr int PTR_PITCH = Smem<PER>::PTR_PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dvs = reinterpret_cast<float*>(smem);         // [PER][SCHAIN]
  float* rvs = dvs + PER * SCHAIN;
  float* evs = rvs + PER * SCHAIN;
  int16_t* ris = reinterpret_cast<int16_t*>(evs + PER * SCHAIN);
  enum { X_LV, X_LI, X_RV, X_RI, X_MK, X_MI, X_NK, X_FIELDS = 8 };
  __shared__ int xch[2][X_FIELDS][SW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = tid * PER;
  const float INF = __int_as_float(0x7f800000);
  auto shift = [&](int k) { return __fmul_rn((float)(base + k), lam_s); };
  auto at = [&](int k) { return k * SCHAIN + tid; };

  // frame 0 as the lowered costs of a frame -1 with m = 0 (x - 0 == x)
#pragma unroll 4
  for (int k = 0; k < PER; ++k) dvs[at(k)] = base + k < C ? cost_v[base + k] : INF;
  float du = cost_u[0], m = 0.f, eu = 0.f;
  // frame f's emission costs of this thread's states (zeros past C) to
  // evs by cp.async, waited for before pass 3 reads them
  auto load_frame = [&](int f) {
    const float* row = cost_v + (size_t)f * C;
#pragma unroll 4
    for (int k = 0; k < PER; ++k) {
      const bool ok = base + k < C;
      cp_async4z(smem_addr(&evs[at(k)]), ok ? row + base + k : row, ok ? 4 : 0);
    }
    cp_async_commit();
    eu = cost_u[f];
  };
  if (N > 1) load_frame(1);

  for (int t = 1; t < N; ++t) {
    const int par = t & 1;
    // 1. lower, then the thread's totals: the left min of dv - shift
    // (leftmost), the right min of dv + shift (rightmost), the first min of dv
    float a0 = 0.f, lt = INF, rt = INF, mv = INF;
    int lti = base, rti = base, mi = base;
#pragma unroll 4
    for (int k = 0; k < PER; ++k) {
      const float dv = __fsub_rn(dvs[at(k)], m);
      dvs[at(k)] = dv;
      const float a = __fsub_rn(dv, shift(k)), b = __fadd_rn(dv, shift(k));
      if (k == 0) {
        a0 = a;
        lt = a;
        rt = b;
        mv = dv;
      } else {
        if (!(lt <= a)) { lt = a; lti = base + k; }
        if (b <= rt) { rt = b; rti = base + k; }
        if (dv < mv) { mv = dv; mi = base + k; }
      }
    }
    // across the warp's lanes, as in the register instance
    const int mkey = order_key(mv);
    const int wkey = __reduce_min_sync(FULL, mkey);
#pragma unroll 4
    for (int off = 1; off < 32; off <<= 1) {
      const float ol = __shfl_up_sync(FULL, lt, off);
      const int oli = __shfl_up_sync(FULL, lti, off);
      const float orr = __shfl_down_sync(FULL, rt, off);
      const int ori = __shfl_down_sync(FULL, rti, off);
      if (ol <= lt) { lt = ol; lti = oli; }
      if (orr <= rt) { rt = orr; rti = ori; }
    }
    const int widx = __reduce_min_sync(FULL, mkey == wkey ? mi : 0x7fffffff);
    if (lane == 31) {
      xch[par][X_LV][warp] = __float_as_int(lt);
      xch[par][X_LI][warp] = lti;
    }
    if (lane == 0) {
      xch[par][X_RV][warp] = __float_as_int(rt);
      xch[par][X_RI][warp] = rti;
      xch[par][X_MK][warp] = wkey;
      xch[par][X_MI][warp] = widx;
    }
    const float pl = __shfl_up_sync(FULL, lt, 1);
    const int pli = __shfl_up_sync(FULL, lti, 1);
    const float pr = __shfl_down_sync(FULL, rt, 1);
    const int pri = __shfl_down_sync(FULL, rti, 1);
    __syncthreads();

    // the carries into this thread: the warps before (after) it, then the
    // lanes before (after) it, the earlier (later) winning ties; with
    // neither, its own first (last) value
    float sl = __int_as_float(xch[par][X_LV][0]);
    int sli = xch[par][X_LI][0];
    for (int w = 1; w < warp; ++w) {
      const float x = __int_as_float(xch[par][X_LV][w]);
      if (x < sl) { sl = x; sli = xch[par][X_LI][w]; }
    }
    const bool take_wl = warp > 0 && (lane == 0 || sl <= pl);
    const float cl = take_wl ? sl : (lane > 0 ? pl : a0);
    const int cli = take_wl ? sli : (lane > 0 ? pli : base);
    float sr = __int_as_float(xch[par][X_RV][SW - 1]);
    int sri = xch[par][X_RI][SW - 1];
    for (int w = SW - 2; w > warp; --w) {
      const float x = __int_as_float(xch[par][X_RV][w]);
      if (x < sr) { sr = x; sri = xch[par][X_RI][w]; }
    }
    const bool take_wr = warp < SW - 1 && (lane == 31 || sr <= pr);
    // with neither: the thread's last value b_{PER-1}, which a running min
    // from it keeps at k = PER-1 (b <= b)
    const float dlast = dvs[at(PER - 1)];
    const float blast = __fadd_rn(dlast, shift(PER - 1));
    const float cr = take_wr ? sr : (lane < 31 ? pr : blast);
    const int cri = take_wr ? sri : (lane < 31 ? pri : base + PER - 1);
    int gkey = xch[par][X_MK][0], gmi = xch[par][X_MI][0];
    for (int w = 1; w < SW; ++w) {
      const int key = xch[par][X_MK][w];
      if (key < gkey) { gkey = key; gmi = xch[par][X_MI][w]; }
    }

    // 2. the right scan from its carry, descending; a carry wins ties
    {
      float run = cr;
      int runi = cri;
#pragma unroll 4
      for (int k = PER - 1; k >= 0; --k) {
        const float b = __fadd_rn(dvs[at(k)], shift(k));
        if (!(run <= b)) { run = b; runi = base + k; }
        rvs[at(k)] = __fsub_rn(run, shift(k));
        ris[at(k)] = static_cast<int16_t>(runi);
      }
    }

    // 3. the left scan from its carry, ascending, against the right values
    const float stay_u = __fadd_rn(du, sw);
    const float from_v = __fadd_rn(key_value(gkey), sw);
    const float new_du = __fadd_rn(fminf(du, from_v), eu);
    const int ptr_u = du <= from_v ? C : gmi;
    // pointer row t-1 maps frame t's state to frame t-1's; slot C is ptr_u;
    // stored 4 pointers at a time as they are formed
    uint2* row = reinterpret_cast<uint2*>(ptrs + (size_t)(t - 1) * PTR_PITCH + base);
    uint32_t w0 = 0, w1 = 0;
    float mloc = INF;
    cp_async_wait_all();                       // this frame's evs have landed
    {
      float run = cl;
      int runi = cli;
#pragma unroll 4
      for (int k = 0; k < PER; ++k) {
        const float a = __fsub_rn(dvs[at(k)], shift(k));
        if (!(run <= a)) { run = a; runi = base + k; }
        const float l = __fadd_rn(run, shift(k)), r = rvs[at(k)];
        const bool take_l = l <= r;
        const float best = take_l ? l : r;
        const int arg = take_l ? runi : ris[at(k)];
        const float nd = base + k < C ? __fadd_rn(fminf(best, stay_u), evs[at(k)]) : INF;
        dvs[at(k)] = nd;
        mloc = fminf(mloc, nd);
        const uint32_t p = (uint16_t)(base + k == C ? ptr_u : (best <= stay_u ? arg : C));
        if (k % 4 == 0) w0 = p;
        else if (k % 4 == 1) w0 |= p << 16;
        else if (k % 4 == 2) w1 = p;
        else row[k / 4] = make_uint2(w0, w1 | p << 16);
      }
    }
    if (t + 1 < N) load_frame(t + 1);
    const int nkey = __reduce_min_sync(FULL, order_key(mloc));
    if (lane == 0) xch[par][X_NK][warp] = nkey;
    __syncthreads();
    int mkmin = xch[par][X_NK][0];
    for (int w = 1; w < SW; ++w) mkmin = min(mkmin, xch[par][X_NK][w]);
    m = fminf(key_value(mkmin), new_du);
    du = __fsub_rn(new_du, m);
  }

  // the last frame's state: the first argmin of dv = new_dv - m, or unvoiced
  float mv = INF;
  int mi = base;
#pragma unroll 4
  for (int k = 0; k < PER; ++k) {
    const float dv = __fsub_rn(dvs[at(k)], m);
    if (k == 0 || dv < mv) { mv = dv; mi = base + k; }
  }
  const int par = N & 1;
  const int mkey = order_key(mv);
  const int wkey = __reduce_min_sync(FULL, mkey);
  const int widx = __reduce_min_sync(FULL, mkey == wkey ? mi : 0x7fffffff);
  if (lane == 0) { xch[par][X_MK][warp] = wkey; xch[par][X_MI][warp] = widx; }
  __syncthreads();   // also publishes every pointer row to thread 0
  if (tid != 0) return;
  int gkey = xch[par][X_MK][0];
  mi = xch[par][X_MI][0];
  for (int w = 1; w < SW; ++w)
    if (xch[par][X_MK][w] < gkey) { gkey = xch[par][X_MK][w]; mi = xch[par][X_MI][w]; }
  int s = key_value(gkey) <= du ? mi : C;
  states[N - 1] = s;
  for (int t = N - 2; t >= 0; --t) {
    s = ptrs[(size_t)t * PTR_PITCH + s];
    states[t] = s;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const float* cost_v, const float* cost_u,
           int16_t* ptrs, int* states, int N, int C, float lam_s, float sw,
           cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, stream>>>(cost_v, cost_u, ptrs, states, N, C, lam_s, sw);
  return (int)cudaGetLastError();
}

// the smallest instance that holds C + 1 states: its states a pointer row
// (0: none)
int pitch_for(int C) {
  const int n = C + 1;
  for (int s : {Reg<4>::STATES, Reg<8>::STATES, Smem<4>::STATES, Smem<8>::STATES,
                Smem<16>::STATES, Smem<32>::STATES})
    if (n <= s) return s;
  return 0;
}

}  // namespace

extern "C" {

// The pointer row's length, in int16, for C voiced states: the states of
// the instance that runs them; 0 when C + 1 > 16384.
int f0_viterbi_pitch(int C) { return C < 1 ? 0 : pitch_for(C); }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// cost_v (N, C) and cost_u (N,) float32; ptrs (max(N-1, 1), f0_viterbi_pitch(C))
// int16 scratch, 16-byte aligned; states (N,) int32. Requires
// 1 <= C <= 16383.
int f0_viterbi_f32(const float* cost_v, const float* cost_u, int16_t* ptrs, int* states, int N,
                   int C, float lam_s, float sw, cudaStream_t stream) {
  const int pitch = N < 1 || C < 1 ? 0 : pitch_for(C);
  if (pitch == 0) return (int)cudaErrorInvalidValue;
  if (pitch == Reg<4>::STATES)
    return launch(f0_viterbi_kernel<4>, THREADS, Reg<4>::SMEM_BYTES, cost_v, cost_u, ptrs,
                  states, N, C, lam_s, sw, stream);
  if (pitch == Reg<8>::STATES)
    return launch(f0_viterbi_kernel<8>, THREADS, Reg<8>::SMEM_BYTES, cost_v, cost_u, ptrs,
                  states, N, C, lam_s, sw, stream);
  if (pitch == Smem<4>::STATES)
    return launch(f0_viterbi_smem_kernel<4>, SCHAIN, Smem<4>::SMEM_BYTES, cost_v, cost_u, ptrs,
                  states, N, C, lam_s, sw, stream);
  if (pitch == Smem<8>::STATES)
    return launch(f0_viterbi_smem_kernel<8>, SCHAIN, Smem<8>::SMEM_BYTES, cost_v, cost_u, ptrs,
                  states, N, C, lam_s, sw, stream);
  if (pitch == Smem<16>::STATES)
    return launch(f0_viterbi_smem_kernel<16>, SCHAIN, Smem<16>::SMEM_BYTES, cost_v, cost_u,
                  ptrs, states, N, C, lam_s, sw, stream);
  return launch(f0_viterbi_smem_kernel<32>, SCHAIN, Smem<32>::SMEM_BYTES, cost_v, cost_u, ptrs,
                states, N, C, lam_s, sw, stream);
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
