// The concatenation-smoothness optimizer (the paper's OPT step), fp32, for
// Hopper (sm_90a): one persistent cooperative launch runs every Adam step of
// a call and its early stop. Built with nvcc into a shared library with a
// plain C interface and bound with ctypes (knnsvc_torch/ops/build.py,
// ops/smoothness_adam.py). Its plain version is the loop of
// knnsvc_torch/match/smoothness.py::optimize_smoothness_from_surrounding.
//
// Replaces no TPU kernel: the JAX package runs the optimizer as one jitted
// lax.while_loop (knnsvc_tpu/match/smoothness.py:182), which XLA keeps on
// the device. The port's plain loop issues ~53 eager launches a step from
// Python for ~780 steps a request, so the card waits on the host; this
// kernel keeps the whole loop on the card: one launch and one read-back of
// the step count a call.
//
// What it computes, per call, on S = the gathered neighbourhood (T, k, 3D)
// (each selected pool row at id offsets -1, 0, +1) and logits w (T, k) = 0:
//   p     = softmax(w) per frame
//   e[t]  = sum_j p[t, j] S[t, j]                                (3D floats)
//   d1[t] = e[t+1][0:D] - e[t][D:2D],  d2[t] = e[t+1][D:2D] - e[t][2D:3D]
//   loss  = mean_t(scale mean_d d1^2) + mean_t(scale mean_d d2^2)
//   g_e   from d1, d2 (c = 2 scale / (max(T-1, 1) D)), g_p = S . g_e,
//   grad  = p (g_p - sum_j p_j g_p_j)                   (softmax backward)
// then the bookkeeping of the plain loop (the loss is taken before the
// step; best_w holds the pre-step weights of the lowest loss; the plateau
// check at t % 100 == 1 with tolerance 1e-5; a stop after 1000 failures in
// a row or at max_steps) and Adam with AMSGrad. The kernel stops exactly at
// the step that ends the loop. Adam's bias corrections come from the
// wrapper's device table (1 - beta^t in float32, as the plain loop builds
// them); Adam and the bookkeeping use __f*_rn intrinsics, so no
// multiply-add is contracted where the plain version rounds twice, and
// given the same gradient they give the plain loop's bits. The softmax
// is torch's warp softmax (a max and a sum by XOR butterflies over the
// next power of two lanes, then exp(x - max) / sum). The sums over D and
// over frames run in another order than the plain version's reductions:
// the two differ in the last bits of the loss and the gradient.
//
// What bounds it on this card: one step reads S once, T k 3D 4 bytes
// (48 KB a frame at k = 4, D = 1024; 74 MB at T = 1500), ~22 us at
// 3.35 TB/s; a step's arithmetic is ~4 T k 3D flops, far under that. At
// T <= ~1000 S stays in the 50 MB L2. The lane of the harmonics (D = 49,
// 2.4 KB a frame) is bound by latency: the grid barrier and the per-frame
// block syncs.
//
// Design. B blocks, launched with cudaLaunchCooperativeKernel, so all are
// resident: 256 threads, one an SM, or 64 threads, four an SM, where a
// frame's columns fit 64 threads (the harmonics); fewer where T is small
// (the wrapper's plan_grid). Block b owns frames [f0, f1) = [b T / B,
// (b + 1) T / B). A step:
//   phase 1: the block walks frames lo = max(f0 - 1, 0) .. hi = min(f1,
//     T - 1) in order (its own frames and one halo frame on each side). A
//     ring of `slots` frames' rows in shared memory is filled slots - 1
//     frames ahead, across step boundaries, so the next step's first frames
//     load during the barrier: one TMA bulk copy a frame completing on an
//     mbarrier where a frame is 16-byte aligned and a multiple of 16 bytes
//     (k = 4: every D), else 4-byte cp.async. One warp forms the next
//     frame's softmax. Every thread owns a group of 4 (or 1) of the D
//     columns in all three parts and forms e[g] there, so e needs no
//     reduction. Once e[g] is formed, frame g - 1 has e[g-2], e[g-1] and
//     e[g], so g_e[g-1] at the thread's columns; its partial g_p from the
//     rows of g - 1 and its partial d1^2, d2^2 go through one block
//     reduction (a warp butterfly, then the warps in order); warp 0 forms
//     grad[g-1] and adds the pair's loss term to the block's partial in
//     frame order. With k <= 4 and one column group a thread (the main
//     path), the thread keeps frame g - 1's rows and e of frames g - 2 and
//     g - 1 in registers, so a frame's rows are read from shared memory
//     once; otherwise e goes through a ring of 3 frames in shared memory
//     and the rows are read twice. S is read from device memory once a step
//     plus the two halo frames. Where two frames' rows do not fit in shared
//     memory (k = 8 at D = 1024), every read of a frame goes to device
//     memory, the second from L2.
//     Adam then updates the block's own frames, before the barrier: it
//     needs no decision of the step. The logits are double-buffered by the
//     step's parity, so those of step t stay for best_w until the next step,
//     which copies them where step t improved.
//   one grid barrier (a counter in device memory: arrive by atomic add,
//     wait by acquire load).
//   phase 2: every block sums the B loss partials in one fixed order, so
//     every block takes the same decisions (improved, the plateau check,
//     the fail streak, the stop) from the same bits, and updates a replica
//     of the Adam state of its two halo frames from their gradients, which
//     the neighbours wrote before the barrier: the replica follows the same
//     operations on the same bits as the owner's, so the next step's phase
//     1 reads the halo logits from it and needs no second barrier.
//     Gradients and loss partials are double-buffered by the step's parity:
//     a neighbour that runs ahead into the next step writes the other
//     buffer.
// The loss partials are summed without atomics in a fixed order, so a run
// repeats itself bit for bit. Block 0 writes the step count.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_K = 32;
constexpr int MAX_WARPS = 8;        // a block of 256 threads
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* S;        // (T, k, 3D)
  const float* bc;       // (2, n_bc): 1 - b1^(t+1), 1 - b2^(t+1) at index t
  float* state;          // six (T, k) arrays: the logits by step parity, m, v, vhat, best_w
  float* grad;           // (2, T, k), by the step's parity
  float* partials;       // (2, B, 2), by the step's parity
  unsigned* barrier;     // the grid barrier's counter, 0 at launch
  int* steps_out;
  int T, k, D, slots, n_bc;
  float scale, c, inv_d, inv_pairs;
  float lr, b1, omb1, b2, omb2, eps, tol, init_loss;
  int plateau_every, fail_limit, max_steps;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight (0 or 1)
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every block waits until `target` arrivals have been counted; a wait of
// 2^35 cycles (~17 s) can only be a fault, and traps rather than hang
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long start = clock64();
    while (load_acquire(count) < target)
      if (clock64() - start > (1LL << 35)) __trap();
    __threadfence();
  }
  __syncthreads();
}

// W consecutive floats (W = 4: a 16-byte aligned float4)
template <int W>
__device__ __forceinline__ void ldw(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void stw(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// One AMSGrad step of one logit, in the plain loop's operations and order:
// m = b1 m + (1 - b1) g; v = b2 v + ((1 - b2) g) g; vhat = max(vhat, v);
// w = w - lr (m / bc1) / (sqrt(vhat / bc2) + eps)
__device__ __forceinline__ void adam(const Params& P, float g, float bc1, float bc2, float& w,
                                     float& m, float& v, float& vh) {
  m = __fadd_rn(__fmul_rn(P.b1, m), __fmul_rn(P.omb1, g));
  v = __fadd_rn(__fmul_rn(P.b2, v), __fmul_rn(__fmul_rn(P.omb2, g), g));
  vh = max_nan(vh, v);
  const float step = __fdiv_rn(__fmul_rn(P.lr, __fdiv_rn(m, bc1)),
                               __fadd_rn(__fsqrt_rn(__fdiv_rn(vh, bc2)), P.eps));
  w = __fsub_rn(w, step);
}

// g_e of frame x at one group of W columns from e of frames x - 1 (m),
// x (a) and x + 1 (n), and the group's d1^2 and d2^2 added to ss1, ss2:
// g_e[x, 0] = c d1[x-1]; g_e[x, 1] = -c d1[x] + c d2[x-1]; g_e[x, 2] =
// -c d2[x], the plain version's terms and sums
template <int W>
__device__ __forceinline__ void ge_terms(const float (&m)[3][W], const float (&a)[3][W],
                                         const float (&n)[3][W], bool has_prev, bool has_next,
                                         float cc, float (&ge)[3][W], float& ss1, float& ss2) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float d1 = 0.f, d2 = 0.f, d1m = 0.f, d2m = 0.f;
    if (has_next) {
      d1 = __fsub_rn(n[0][c], a[1][c]);
      d2 = __fsub_rn(n[1][c], a[2][c]);
      ss1 = __fmaf_rn(d1, d1, ss1);
      ss2 = __fmaf_rn(d2, d2, ss2);
    }
    if (has_prev) {
      d1m = __fsub_rn(a[0][c], m[1][c]);
      d2m = __fsub_rn(a[1][c], m[2][c]);
    }
    const float up = __fmul_rn(-cc, d1), down = __fmul_rn(cc, d2m);
    ge[0][c] = has_prev ? __fmul_rn(cc, d1m) : 0.f;
    ge[1][c] = has_next ? (has_prev ? __fadd_rn(up, down) : up) : (has_prev ? down : 0.f);
    ge[2][c] = has_next ? __fmul_rn(-cc, d2) : 0.f;
  }
}

// KM: the largest k of the instance (register arrays); VEC: 16-byte rows;
// NT: threads a block (256, or 64 for rows of at most 64 column groups)
template <int KM, bool VEC, int NT>
__global__ void __launch_bounds__(NT) smoothness_adam_kernel(const Params P) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int WARPS = NT / 32, P_WARP = WARPS - 1;   // P_WARP: the next frame's softmax
  constexpr int KB = KM < 8 ? KM : 8;                   // rows whose loads go out together
  extern __shared__ __align__(16) float smem[];
  __shared__ float pring[4][KM];     // softmax of the last four frames streamed
  __shared__ int s_flags;            // bit 0: improved, bit 1: stop
  __shared__ __align__(8) uint64_t ring_bar[3];   // a ring slot's bulk copy has landed

  const int T = P.T, k = P.k, D = P.D, D3 = 3 * D, FR = k * D3, NS = P.slots;
  const size_t TK = (size_t)T * k;
  const int NG = D / W;
  const int B = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f0 = (int)((long)b * T / B), f1 = (int)((long)(b + 1) * T / B);
  const int lo = f0 > 0 ? f0 - 1 : f0, hi = f1 < T ? f1 : f1 - 1;
  const int n = hi - lo + 1;                       // frames streamed a step
  const int n_iter = n + (f1 == T ? 1 : 0);        // + the last frame's gradient
  const int n_own = (f1 - f0) * k;
  float* ring = smem;                              // NS frames of k x 3D
  float* ering = ring + (size_t)NS * FR;           // e of 3 frames
  float* red = ering + 3 * D3;                     // 2 x WARPS x (k + 2)
  float* halo = red + 2 * MAX_WARPS * (k + 2);     // 2 frames x (w, m, v, vhat) x k
  float* const m_all = P.state + 2 * TK;           // state: w (2: by step parity), m, v,
  float* const v_all = P.state + 3 * TK;           // vhat, best_w
  float* const vh_all = P.state + 4 * TK;
  float* const best = P.state + 5 * TK;
  int wsz = 1;                                     // softmax lanes: next power of two >= k
  while (wsz < k) wsz <<= 1;

  for (int i = tid; i < 8 * k; i += NT) halo[i] = 0.f;
  // frames 16-byte aligned, a multiple of 16 bytes long: one TMA bulk copy
  // a frame (k = 4: every D); otherwise 4-byte cp.async spread over the block
  const bool bulk = FR % 4 == 0 && reinterpret_cast<uintptr_t>(P.S) % 16 == 0;
  if (bulk && tid == 0)
    for (int s = 0; s < NS; ++s) mbar_init(&ring_bar[s], 1);
  unsigned phases = 0;                             // bit s: the parity slot s waits for next

  // frame g's rows into ring slot `slot`
  auto prefetch = [&](int g, int slot) {
    const float* src = P.S + (size_t)g * FR;
    float* dst = ring + (size_t)slot * FR;
    if (bulk) {
      if (tid == 0) {
        mbar_expect_tx(&ring_bar[slot], 4u * FR);
        bulk_copy(dst, src, 4u * FR, &ring_bar[slot]);
      }
    } else {
      for (int i = tid; i < FR; i += NT) cp_async4(dst + i, src + i);
      cp_async_commit();
    }
  };
  // until ring slot `slot` holds its next frame
  auto wait_slot = [&](int slot) {
    if (bulk) {
      mbar_wait(&ring_bar[slot], (phases >> slot) & 1u);
      phases ^= 1u << slot;
    } else {
      cp_async_wait(NS - 2);
    }
  };
  // logit j of frame g at step t (lane j < k; -inf elsewhere): the owner's,
  // or the halo replica
  auto logit = [&](int t, int g) {
    if (lane >= k) return -INFINITY;
    if (g < f0) return halo[lane];
    if (g >= f1) return halo[4 * k + lane];
    return P.state[(size_t)(t & 1) * TK + (size_t)g * k + lane];
  };
  // torch's warp softmax of one frame's logits x (one a lane) into out[0..k),
  // by one whole warp
  auto softmax_to = [&](float x, float* out) {
    float mx = x;
    for (int off = wsz >> 1; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(FULL, mx, off);
      mx = mx < o ? o : mx;
    }
    const float e = lane < k ? expf(x - mx) : 0.f;
    float s = e;
    for (int off = wsz >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane < k) out[lane] = e / s;
  };

  if (P.max_steps <= 0) {
    if (b == 0 && tid == 0) *P.steps_out = 0;
    return;
  }
  // the ring slot of this iteration's frame, and the stream index of the
  // frame NS - 1 ahead of it, which the iteration prefetches
  int cur = 0, ahead = NS > 1 ? (NS - 1) % n : 0;
  __syncthreads();                                 // the replicas are zero, the mbarriers set
  for (int s = 0; s < NS - 1; ++s) prefetch(lo + s % n, s);

  // one column group a thread (k <= 4, D / W <= NT): frame x's rows and e
  // of frames x - 1 and x stay in registers from frame to frame
  const bool reg = KM == 4 && NG <= NT;
  float r_y[KB][3][W] = {}, r_em[3][W] = {}, r_e0[3][W] = {};

  float min_loss = P.init_loss, conv_loss = P.init_loss;   // thread 0 alone
  int fail = 0;
  bool improved = false;                           // at the step before
  int t = 0;
  for (;; ++t) {
    const int par = t & 1;
    float* grad = P.grad + par * TK;
    float part1 = 0.f, part2 = 0.f;                // thread 0: this block's loss terms
    float wn = 0.f;                                // P_WARP: the next frame's logits
    if (warp == P_WARP) {
      softmax_to(logit(t, lo), pring[0]);
      if (n > 1) wn = logit(t, lo + 1);
    }

    // ---- phase 1: e, the gradient and the loss terms, frame by frame ----
    for (int i = 0; i < n_iter; ++i) {
      const int prev = cur == 0 ? NS - 1 : cur - 1;     // the ring slot of frame i - 1
      const bool has_e = i < n;
      if (has_e && NS) wait_slot(cur);
      __syncthreads();                             // frame i's rows and softmax are in
      const int g = lo + i, x = g - 1;
      if (has_e && warp == P_WARP && i + 1 < n) {
        softmax_to(wn, pring[(i + 1) & 3]);
        if (i + 2 < n) wn = logit(t, g + 2);       // read one frame ahead
      }
      // frame x = g - 1 takes its gradient once e[x+1] is formed (or at
      // x = T-1, in the extra iteration)
      const bool own = i >= 1 && x >= f0 && x < f1;
      const bool has_prev = x >= 1, has_next = x <= T - 2;
      const int rp = i & 1;
      const float* pg = pring[i & 3];
      float gp[KM];
#pragma unroll
      for (int j = 0; j < KM; ++j) gp[j] = 0.f;
      float ss1 = 0.f, ss2 = 0.f;
      // KB rows of a frame at one column group, loaded together (rows
      // j >= k read row k - 1 and add nothing); their terms of e (sums in
      // row order) and of g_p
      auto load_rows = [&](const float* rows, int q, int j0, float (&y)[KB][3][W]) {
#pragma unroll
        for (int jj = 0; jj < KB; ++jj)
#pragma unroll
          for (int part = 0; part < 3; ++part)
            ldw<W>(rows + min(j0 + jj, k - 1) * D3 + part * D + q * W, y[jj][part]);
      };
      auto add_e = [&](const float (&y)[KB][3][W], int j0, float (&e)[3][W]) {
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          const bool real = j0 + jj < k;
          const float pj = real ? pg[j0 + jj] : 0.f;
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int c = 0; c < W; ++c)
              e[part][c] = real ? __fmaf_rn(pj, y[jj][part][c], e[part][c]) : e[part][c];
        }
      };
      auto add_gp = [&](const float (&y)[KB][3][W], int j0, const float (&ge)[3][W]) {
#pragma unroll
        for (int jj = 0; jj < KB; ++jj)
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int c = 0; c < W; ++c)
              gp[j0 + jj] = __fmaf_rn(y[jj][part][c], ge[part][c], gp[j0 + jj]);
      };
      if (reg) {
        // one column group a thread (q = tid; KB = KM = 4), in registers
        // across frames: frame x's rows and e of frames x - 1 and x; a
        // frame's rows are read from the ring once
        float yn[KB][3][W], en[3][W] = {};
        if (has_e && tid < NG) {
          // one body each for rows in shared and in device memory, so that
          // each reads through its own address space
          if (NS)
            load_rows(ring + (size_t)cur * FR, tid, 0, yn);
          else
            load_rows(P.S + (size_t)g * FR, tid, 0, yn);
          add_e(yn, 0, en);
        }
        if (own && tid < NG) {
          float ge[3][W];
          ge_terms<W>(r_em, r_e0, en, has_prev, has_next, P.c, ge, ss1, ss2);
          add_gp(r_y, 0, ge);
        }
        if (has_e) {
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int c = 0; c < W; ++c) {
              r_em[part][c] = r_e0[part][c];
              r_e0[part][c] = en[part][c];
#pragma unroll
              for (int j = 0; j < KB; ++j) r_y[j][part][c] = yn[j][part][c];
            }
        }
      } else {
        // column groups in turn: e through a ring of 3 frames in shared
        // memory; a frame's rows are read from the ring twice (for e, then
        // for g_p)
        float* eg = ering + (i % 3) * D3;
        if (has_e) {
          for (int q = tid; q < NG; q += NT) {
            float e[3][W] = {};
#pragma unroll
            for (int j0 = 0; j0 < KM; j0 += KB) {
              if (j0 < k) {
                float y[KB][3][W];
                if (NS)
                  load_rows(ring + (size_t)cur * FR, q, j0, y);
                else
                  load_rows(P.S + (size_t)g * FR, q, j0, y);
                add_e(y, j0, e);
              }
            }
#pragma unroll
            for (int part = 0; part < 3; ++part) stw<W>(eg + part * D + q * W, e[part]);
          }
        }
        if (own) {
          const float* em = ering + ((i + 1) % 3) * D3;      // e[x-1]
          const float* e0 = ering + ((i + 2) % 3) * D3;      // e[x]
          for (int q = tid; q < NG; q += NT) {
            float m[3][W], a[3][W], nx[3][W], ge[3][W];
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              ldw<W>(e0 + part * D + q * W, a[part]);
              if (has_next) ldw<W>(eg + part * D + q * W, nx[part]);
              if (has_prev) ldw<W>(em + part * D + q * W, m[part]);
            }
            ge_terms<W>(m, a, nx, has_prev, has_next, P.c, ge, ss1, ss2);
#pragma unroll
            for (int j0 = 0; j0 < KM; j0 += KB) {
              if (j0 < k) {
                float y[KB][3][W];
                if (NS)
                  load_rows(ring + (size_t)prev * FR, q, j0, y);
                else
                  load_rows(P.S + (size_t)x * FR, q, j0, y);
                add_gp(y, j0, ge);
              }
            }
          }
        }
      }
      if (own) {
        float* r = red + (rp * WARPS + warp) * (k + 2);
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) {
            const float v = warp_sum(gp[j]);
            if (lane == 0) r[j] = v;
          }
        }
        ss1 = warp_sum(ss1);
        ss2 = warp_sum(ss2);
        if (lane == 0) {
          r[k] = ss1;
          r[k + 1] = ss2;
        }
      }
      __syncthreads();                             // the ring slot of x is free
      if (has_e && NS) {
        prefetch(lo + ahead, prev);
        cur = cur + 1 == NS ? 0 : cur + 1;
        ahead = ahead + 1 == n ? 0 : ahead + 1;
      }
      if (own && warp == 0) {
        // lane j < k sums g_p[j] over the warps, lanes 0 and 1 the pair's
        // d1^2 and d2^2, each in warp order
        const float* r = red + rp * WARPS * (k + 2);
        float g = 0.f, sq = 0.f;
        for (int w8 = 0; w8 < WARPS; ++w8) {
          if (lane < k) g = __fadd_rn(g, r[w8 * (k + 2) + lane]);
          if (lane < 2) sq = __fadd_rn(sq, r[w8 * (k + 2) + k + lane]);
        }
        const float pj = lane < k ? pring[(i + 3) & 3][lane] : 0.f;   // frame x's softmax
        float sp = __fmul_rn(pj, g);                // sum_j p_j g_p[j], by a butterfly
        for (int off = wsz >> 1; off > 0; off >>= 1)
          sp = __fadd_rn(sp, __shfl_xor_sync(FULL, sp, off));
        if (lane < k) grad[(size_t)x * k + lane] = __fmul_rn(pj, __fsub_rn(g, sp));
        const float s1 = __shfl_sync(FULL, sq, 0), s2 = __shfl_sync(FULL, sq, 1);
        if (lane == 0 && x <= T - 2) {
          part1 = __fadd_rn(part1, __fmul_rn(P.scale, __fmul_rn(s1, P.inv_d)));
          part2 = __fadd_rn(part2, __fmul_rn(P.scale, __fmul_rn(s2, P.inv_d)));
        }
      }
    }
    __syncthreads();                               // every own gradient is written

    // ---- Adam on the own frames, which needs no decision of this step:
    // w of step t + 1 goes to the other parity, so w of step t stays for
    // best_w; best_w takes w of step t - 1 first where that step improved ----
    const float bc1 = P.bc[t], bc2 = P.bc[P.n_bc + t];
    float* const w_now = P.state + par * TK;
    float* const w_next = P.state + (par ^ 1) * TK;
    for (int idx = tid; idx < n_own; idx += NT) {
      const size_t o = (size_t)f0 * k + idx;
      if (improved) best[o] = w_next[o];           // w of step t - 1
      float w = w_now[o], m = m_all[o], v = v_all[o], vh = vh_all[o];
      adam(P, grad[o], bc1, bc2, w, m, v, vh);
      w_next[o] = w, m_all[o] = m, v_all[o] = v, vh_all[o] = vh;
    }
    if (tid == 0) {
      P.partials[(par * B + b) * 2] = part1;
      P.partials[(par * B + b) * 2 + 1] = part2;
    }

    grid_barrier(P.barrier, (unsigned)(t + 1) * (unsigned)B);

    // ---- the same decisions in every block; the halo replicas' Adam ----
    float hg = 0.f;                                // the halo frames' gradients
    int hj = -1;
    if (tid < 2 * k) {
      const int h = tid / k, g = h ? f1 : f0 - 1;
      if (g >= 0 && g < T) {
        hj = tid;
        hg = __ldcg(grad + (size_t)g * k + tid - h * k);
      }
    }
    if (warp == 0) {
      const float2* parts = reinterpret_cast<const float2*>(P.partials) + par * B;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
      for (int bb = lane; bb < B; bb += 32) {
        const float2 v = __ldcg(parts + bb);
        s1 = __fadd_rn(s1, v.x);
        s2 = __fadd_rn(s2, v.y);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float loss = __fadd_rn(__fmul_rn(s1, P.inv_pairs), __fmul_rn(s2, P.inv_pairs));
        bool done = false;
        if (t % P.plateau_every == 1) {
          done = fabsf(__fsub_rn(min_loss, conv_loss)) < P.tol;
          conv_loss = min_loss;
        }
        const bool better = loss < min_loss;
        if (better) min_loss = loss;
        fail = better ? 0 : fail + 1;
        done = done || fail >= P.fail_limit;
        s_flags = (better ? 1 : 0) | ((done || t + 1 >= P.max_steps) ? 2 : 0);
      }
    }
    __syncthreads();
    improved = s_flags & 1;
    const bool stop = s_flags & 2;
    if (hj >= 0) {
      float* st = halo + 4 * k * (hj / k) + hj % k;    // w, m, v, vhat at stride k
      adam(P, hg, bc1, bc2, st[0], st[k], st[2 * k], st[3 * k]);
    }
    __syncthreads();
    if (stop) break;
  }
  if (improved)
    for (int idx = tid; idx < n_own; idx += NT) {
      const size_t o = (size_t)f0 * k + idx;
      best[o] = P.state[(size_t)(t & 1) * TK + o];
    }
  // the copies still in flight land before the block exits
  for (int s = 0; s < NS - 1; ++s) {
    if (bulk)
      wait_slot(cur + s < NS ? cur + s : cur + s - NS);
    else
      cp_async_wait(0);
  }
  if (b == 0 && tid == 0) *P.steps_out = t + 1;
}

// dynamic shared memory of a plan (floats): the ring, e of 3 frames, the
// reduction buffers, the halo replicas; ops/smoothness_adam.py::smem_bytes
long smem_bytes(int k, int D, int slots) {
  return 4L * ((long)slots * k * 3 * D + 9L * D + 2L * MAX_WARPS * (k + 2) + 8L * k);
}

template <int KM, bool VEC, int NT>
int launch(const Params& P, int blocks, long smem, cudaStream_t stream) {
  auto kernel = smoothness_adam_kernel<KM, VEC, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p = P;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(NT), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool VEC, int NT>
int launch_k(const Params& P, int blocks, long smem, cudaStream_t s) {
  if (P.k <= 4) return launch<4, VEC, NT>(P, blocks, smem, s);
  if (P.k <= 8) return launch<8, VEC, NT>(P, blocks, smem, s);
  return launch<32, VEC, NT>(P, blocks, smem, s);
}

template <int KM, bool VEC, int NT>
int occupancy(long smem, int* per_sm) {
  auto kernel = smoothness_adam_kernel<KM, VEC, NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, (size_t)smem);
}

template <bool VEC, int NT>
int occupancy_k(int k, long smem, int* per_sm) {
  if (k <= 4) return occupancy<4, VEC, NT>(smem, per_sm);
  if (k <= 8) return occupancy<8, VEC, NT>(smem, per_sm);
  return occupancy<32, VEC, NT>(smem, per_sm);
}

}  // namespace

extern "C" {

// The blocks of the instance for (k, threads, 16-byte rows or not) that
// one SM holds with `smem` bytes of dynamic shared memory each.
int smoothness_adam_occupancy(int k, int threads, int vec, long smem, int* per_sm) {
  if (k < 1 || k > MAX_K || !(threads == 256 || threads == 64)) return (int)cudaErrorInvalidValue;
  if (threads == 64)
    return vec ? occupancy_k<true, 64>(k, smem, per_sm) : occupancy_k<false, 64>(k, smem, per_sm);
  return vec ? occupancy_k<true, 256>(k, smem, per_sm) : occupancy_k<false, 256>(k, smem, per_sm);
}

// The whole optimizer call on `stream`; returns the cudaError_t of the
// launch (0 = success). S (T, k, 3D) fp32 contiguous; bc (2, n_bc) fp32;
// state six (T, k) fp32 arrays, zero (the logits by step parity, m, v,
// vhat, best_w; best_w is the result); grad (2, T, k) and partials
// (2, blocks, 2) fp32 scratch; barrier one zero uint32; steps_out one
// int32. blocks <= T, threads 256 or 64, slots 0, 2 or 3 and smem as
// planned by the wrapper (ops/smoothness_adam.py::plan_grid), whose blocks
// an SM are capped by smoothness_adam_occupancy; a grid that is not
// co-resident is refused by the cooperative launch
// (cudaErrorCooperativeLaunchTooLarge).
int smoothness_adam_f32(const float* S, const float* bc, int n_bc, float* state, float* grad,
                        float* partials, unsigned* barrier, int* steps_out, int T, int k, int D,
                        int blocks, int threads, int slots, long smem, float scale, float c,
                        float inv_d, float inv_pairs, float lr, float b1, float omb1, float b2,
                        float omb2, float eps, float tol, float init_loss, int plateau_every,
                        int fail_limit, int max_steps, void* stream) {
  if (T < 1 || k < 1 || k > MAX_K || D < 1 || blocks < 1 || blocks > T ||
      !(threads == 256 || threads == 64) || !(slots == 0 || slots == 2 || slots == 3) ||
      plateau_every < 1 || n_bc < max_steps || smem < smem_bytes(k, D, slots))
    return (int)cudaErrorInvalidValue;
  Params P{S, bc, state, grad, partials, barrier, steps_out, T, k, D, slots, n_bc,
           scale, c, inv_d, inv_pairs, lr, b1, omb1, b2, omb2, eps, tol, init_loss,
           plateau_every, fail_limit, max_steps};
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 64)
    return vec ? launch_k<true, 64>(P, blocks, smem, s) : launch_k<false, 64>(P, blocks, smem, s);
  return vec ? launch_k<true, 256>(P, blocks, smem, s) : launch_k<false, 256>(P, blocks, smem, s);
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
