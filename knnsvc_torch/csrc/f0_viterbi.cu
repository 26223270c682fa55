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
// dependent steps and bound by the latency of one step. The design keeps
// that step inside one warp, with no block barrier on the chain:
//   - one block of one warp per sequence; lane l holds states 16 l .. 16 l
//     + 15 in registers (C + 1 <= 512). Each cumulative min is a serial
//     pass over the lane's 16 values and a 5-level shuffle scan over the
//     lanes; the left pass, the right pass and min/argmin(dv) are
//     independent and interleave;
//   - frame t+1's emission row is loaded into registers while frame t
//     runs;
//   - the pointers go to global memory as int16 in rows of 512 (ptr_u in
//     slot C, so the backtrack reads one table), 1 KB a frame, 1.5 MB for
//     a 30-s chunk, which stays in L2. The backtrack stages 32 rows at a
//     time into shared memory with all lanes, then lane 0 walks them.
// Exactness: every cost operation is an __f*_rn intrinsic in the plain
// version's order (no contracted multiply-add, e.g. of dv - i * lam_s), and
// the ties follow the plain version, so the states equal it on every frame.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int LANES = 32;
constexpr int PER_LANE = 16;
constexpr int MAX_STATES = LANES * PER_LANE;   // C + 1 <= 512
constexpr int PTR_PITCH = 512;                 // int16 pointers per frame row
constexpr int BACK_ROWS = 32;                  // pointer rows staged per backtrack step
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(LANES, 1)
f0_viterbi_kernel(const float* __restrict__ cost_v, const float* __restrict__ cost_u,
                  int16_t* ptrs, int* __restrict__ states, int N, int C,
                  float lam_s, float sw) {
  __shared__ __align__(16) int16_t back[BACK_ROWS][PTR_PITCH];
  const int lane = threadIdx.x;
  const int base = lane * PER_LANE;
  const float INF = __int_as_float(0x7f800000);

  float shift[PER_LANE], dv[PER_LANE], ev[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int j = base + k;
    shift[k] = __fmul_rn((float)j, lam_s);
    dv[k] = j < C ? cost_v[j] : INF;
    ev[k] = (N > 1 && j < C) ? cost_v[(size_t)C + j] : 0.f;
  }
  float du = cost_u[0];

  for (int t = 1; t < N; ++t) {
    // next frame's emissions, in flight while this frame runs
    float nx[PER_LANE];
    const bool more = t + 1 < N;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
      nx[k] = (more && base + k < C) ? __ldg(cost_v + (size_t)(t + 1) * C + base + k) : 0.f;
    const float eu = __ldg(cost_u + t);

    // min and first argmin of dv; left (leftmost) and right (rightmost)
    // cumulative mins within the lane
    float mv = dv[0];
    int mi = base;
    float lv[PER_LANE], rv[PER_LANE];
    int li[PER_LANE], ri[PER_LANE];
    lv[0] = __fsub_rn(dv[0], shift[0]);
    li[0] = base;
    rv[PER_LANE - 1] = __fadd_rn(dv[PER_LANE - 1], shift[PER_LANE - 1]);
    ri[PER_LANE - 1] = base + PER_LANE - 1;
#pragma unroll
    for (int k = 1; k < PER_LANE; ++k) {
      if (dv[k] < mv) { mv = dv[k]; mi = base + k; }
      const float a = __fsub_rn(dv[k], shift[k]);
      if (lv[k - 1] <= a) { lv[k] = lv[k - 1]; li[k] = li[k - 1]; }
      else { lv[k] = a; li[k] = base + k; }
      const int q = PER_LANE - 1 - k;
      const float b = __fadd_rn(dv[q], shift[q]);
      if (rv[q + 1] <= b) { rv[q] = rv[q + 1]; ri[q] = ri[q + 1]; }
      else { rv[q] = b; ri[q] = base + q; }
    }
    // across lanes: argmin by butterfly; prefix (left) and suffix (right)
    // scans of the lane totals, the earlier segment winning ties
    float lt = lv[PER_LANE - 1], rt = rv[0];
    int lti = li[PER_LANE - 1], rti = ri[0];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      const float om = __shfl_xor_sync(FULL, mv, off);
      const int omi = __shfl_xor_sync(FULL, mi, off);
      const float ol = __shfl_up_sync(FULL, lt, off);
      const int oli = __shfl_up_sync(FULL, lti, off);
      const float orr = __shfl_down_sync(FULL, rt, off);
      const int ori = __shfl_down_sync(FULL, rti, off);
      if (om < mv || (om == mv && omi < mi)) { mv = om; mi = omi; }
      if (lane >= off && ol <= lt) { lt = ol; lti = oli; }
      if (lane + off < LANES && orr <= rt) { rt = orr; rti = ori; }
    }
    const float pl = __shfl_up_sync(FULL, lt, 1);
    const int pli = __shfl_up_sync(FULL, lti, 1);
    const float pr = __shfl_down_sync(FULL, rt, 1);
    const int pri = __shfl_down_sync(FULL, rti, 1);

    const float stay_u = __fadd_rn(du, sw);
    float nd[PER_LANE];
    int ptr[PER_LANE];
    float mloc = INF;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      float l = lv[k], r = rv[k];
      int il = li[k], ir = ri[k];
      if (lane > 0 && pl <= l) { l = pl; il = pli; }
      if (lane < LANES - 1 && pr <= r) { r = pr; ir = pri; }
      l = __fadd_rn(l, shift[k]);
      r = __fsub_rn(r, shift[k]);
      const bool take_l = l <= r;
      const float best = take_l ? l : r;
      const int arg = take_l ? il : ir;
      nd[k] = base + k < C ? __fadd_rn(fminf(best, stay_u), ev[k]) : INF;
      ptr[k] = best <= stay_u ? arg : C;
      mloc = fminf(mloc, nd[k]);
    }
    const float from_v = __fadd_rn(mv, sw);
    const float new_du = __fadd_rn(fminf(du, from_v), eu);
    const int ptr_u = du <= from_v ? C : mi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mloc = fminf(mloc, __shfl_xor_sync(FULL, mloc, off));
    const float m = fminf(mloc, new_du);

    // pointer row t-1 maps frame t's state to frame t-1's; slot C is ptr_u
    uint32_t packed[PER_LANE / 2];
#pragma unroll
    for (int k = 0; k < PER_LANE; k += 2) {
      const int p0 = base + k == C ? ptr_u : ptr[k];
      const int p1 = base + k + 1 == C ? ptr_u : ptr[k + 1];
      packed[k / 2] = (uint32_t)(uint16_t)p0 | ((uint32_t)(uint16_t)p1 << 16);
    }
    uint4* row = reinterpret_cast<uint4*>(ptrs + (size_t)(t - 1) * PTR_PITCH + base);
    row[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    row[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);

#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      dv[k] = base + k < C ? __fsub_rn(nd[k], m) : INF;
      ev[k] = nx[k];
    }
    du = __fsub_rn(new_du, m);
  }

  // the last frame's state: first argmin of dv, or unvoiced
  float mv = dv[0];
  int mi = base;
#pragma unroll
  for (int k = 1; k < PER_LANE; ++k)
    if (dv[k] < mv) { mv = dv[k]; mi = base + k; }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float om = __shfl_xor_sync(FULL, mv, off);
    const int omi = __shfl_xor_sync(FULL, mi, off);
    if (om < mv || (om == mv && omi < mi)) { mv = om; mi = omi; }
  }
  int s = mv <= du ? mi : C;
  if (lane == 0) states[N - 1] = s;

  // backtrack: stage BACK_ROWS pointer rows in shared memory, then walk them
  __syncwarp();
  constexpr int ROW_VECS = PTR_PITCH * 2 / 16;   // uint4 per row
  for (int hi = N - 2; hi >= 0; hi -= BACK_ROWS) {
    const int lo = hi - BACK_ROWS + 1 > 0 ? hi - BACK_ROWS + 1 : 0;
    const int n = (hi - lo + 1) * ROW_VECS;
    const uint4* src = reinterpret_cast<const uint4*>(ptrs + (size_t)lo * PTR_PITCH);
    uint4* dst = reinterpret_cast<uint4*>(&back[0][0]);
    for (int i = lane; i < n; i += LANES) dst[i] = src[i];
    __syncwarp();
    if (lane == 0) {
      for (int t = hi; t >= lo; --t) {
        s = back[t - lo][s];
        states[t] = s;
      }
    }
    s = __shfl_sync(FULL, s, 0);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// cost_v (N, C) and cost_u (N,) float32; ptrs (max(N-1, 1), 512) int16
// scratch, 16-byte aligned; states (N,) int32. Requires 1 <= C <= 511.
int f0_viterbi_f32(const float* cost_v, const float* cost_u, int16_t* ptrs, int* states, int N,
                   int C, float lam_s, float sw, cudaStream_t stream) {
  if (N < 1 || C < 1 || C + 1 > MAX_STATES) return (int)cudaErrorInvalidValue;
  f0_viterbi_kernel<<<1, LANES, 0, stream>>>(cost_v, cost_u, ptrs, states, N, C, lam_s, sw);
  return (int)cudaGetLastError();
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
