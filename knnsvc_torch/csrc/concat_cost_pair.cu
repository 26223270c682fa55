// Concatenation-cost reselection (the paper's CAT step), fp32, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and bound with ctypes (knnsvc_torch/ops/build.py, ops/concat_scan.py).
//
// Replaces the TPU kernel knnsvc_tpu/ops/concat_scan.py::concat_cost_pair_pallas
// (pl.pallas_call at concat_scan.py:182, body _kernel at :68). Its plain
// version is knnsvc_torch/match/concat_cost.py::concat_cost_scan.
//
// A serial recurrence over T frames, per lane (lane 0 unpitched, lane 1
// pitched; one lane for the single reselection), k = 4:
//   cand    = own top-4 of frame t, then min(picks of frame t-1 + 1, P - 1)
//   match_c = 1 - cand_c . svn_t / |cand_c|
//   cc_jc   = 1 - prev_j . cand_c / (|prev_j| |cand_c|)
//   unpitched: cc > b -> 1.5 cc - b;   pitched: b < 0.08 and cc < 5 b -> 0,
//              weight latched to 0 for good once b >= 0.08
//   total_c = weight * median4_j(cc_jc) + match_c [+ |tlf0[cand_c] - slf0_t|]
//   picks   = the 4 smallest totals, ties to the lowest candidate position
// with b = 2 (1 - svn_{t-1} . svn_t) and the log2 f0 tracks computed by the
// wrapper with the same torch ops as the plain version.
//
// What bounds it at the main path's shape (T = P = 1500, D = 1024, 2 lanes):
//   - operations: 48 dots of 2D operations per frame and lane, 0.29 GFLOP,
//     ~4.4 us at the H100's 67 TFLOP/s fp32 rate;
//   - bytes: source and pool read once, 12.3 MB, ~3.7 us at 3.35 TB/s.
// Neither is what limits it: frame t needs frame t-1's picks, so the frames
// form a chain of T dependent steps, each waiting on row loads from L2 and a
// few block barriers. It is bound by that latency.
//
// Design. One block per lane (the lanes are independent, so the pair takes
// the time of one lane), looping over frames inside the kernel. Per frame:
// the 8 candidate rows and the source row are loaded into shared memory
// with 16-byte loads (the 6 MB pool stays in the 50 MB L2); the rows picked
// in the previous frame stay in shared memory (two candidate buffers
// alternate), with their norms, so no previous row is ever loaded again;
// warp c computes candidate c's norm, source dot and 4 cross dots with
// shuffle reductions; warp 0 forms the costs, the medians and the picks
// (argmin over 8 lanes, ties to the lowest position), writes them out and
// updates the carry. The scalar cost arithmetic uses __f*_rn intrinsics, so
// no multiply-add is contracted that the plain version rounds twice: the
// two differ only in the order of the dot-product sums. Ids are clamped to
// [0, P-1] before any row is read (XLA's gather clamps the same way).
// Prefetching the next frame's own candidates (cp.async / TMA) and
// precomputed pool norms are left for later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int K = 4;            // picks per lane
constexpr int C = 2 * K;        // candidates per frame and lane
constexpr int THREADS = C * 32; // one warp per candidate
constexpr int MAX_LANES = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum(a * b) over D floats (D a multiple of 4) by one warp; every lane gets
// it. The order of the sum depends on D alone, so equal rows give equal sums.
__device__ __forceinline__ float warp_dot(const float* a, const float* b, int d4, int ln) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
  for (int i = ln; i < d4; i += 32) {
    const float4 x = a4[i], y = b4[i];
    s += x.x * y.x;
    s += x.y * y.y;
    s += x.z * y.z;
    s += x.w * y.w;
  }
  return warp_sum(s);
}

// torch.median of 4 values: the lower middle, the 2nd smallest
__device__ __forceinline__ float median4(float a, float b, float c, float d) {
  const float s1 = fminf(a, b), l1 = fmaxf(a, b);
  const float s2 = fminf(c, d), l2 = fmaxf(c, d);
  return fminf(fmaxf(s1, s2), fminf(l1, l2));
}

__global__ void __launch_bounds__(THREADS)
concat_cost_kernel(const int* __restrict__ idx, const float* __restrict__ svn,
                   const float* __restrict__ tgt, const float* __restrict__ baselines,
                   const float* __restrict__ src_lf0, const float* __restrict__ tgt_lf0,
                   int* __restrict__ out, int T, int P, int D, int L, int pitched_mask,
                   float concat_weight) {
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;              // [2][C][D]: candidate rows of frames t-1 and t
  float* sv = smem + 2 * C * D;    // [D]: source row of frame t
  __shared__ int cand_id[C];
  __shared__ int prev_id[K];       // picks of frame t-1
  __shared__ int prev_slot[K];     // their rows in frame t-1's buffer
  __shared__ float prev_norm[K];
  __shared__ float cn[C], sdot[C], cross[K][C];
  __shared__ float weight;

  const int lane = blockIdx.x;
  const bool pitched = (pitched_mask >> lane) & 1;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int d4 = D / 4;
  const float4* tgt4 = reinterpret_cast<const float4*>(tgt);
  const float4* svn4 = reinterpret_cast<const float4*>(svn);
  float4* sv4 = reinterpret_cast<float4*>(sv);

  // frame 0 passes through; its ids are frame 1's previous picks, in buffer 0
  if (tid < K) {
    const int id = idx[lane * K + tid];
    out[lane * K + tid] = id;
    prev_id[tid] = min(max(id, 0), P - 1);
    prev_slot[tid] = tid;
  }
  if (tid == 0) weight = concat_weight;
  __syncthreads();
  for (int i = tid; i < K * d4; i += THREADS) {
    const int r = i / d4, c = i - r * d4;
    reinterpret_cast<float4*>(rows + r * D)[c] = tgt4[(size_t)prev_id[r] * d4 + c];
  }
  __syncthreads();
  if (warp < K) {
    const float n = warp_dot(rows + warp * D, rows + warp * D, d4, ln);
    if (ln == 0) prev_norm[warp] = sqrtf(n);
  }

  for (int t = 1; t < T; ++t) {
    float* cur = rows + (t & 1) * C * D;
    const float* prv = rows + ((t - 1) & 1) * C * D;
    if (tid < K) {
      const int id = idx[((size_t)t * L + lane) * K + tid];
      cand_id[tid] = min(max(id, 0), P - 1);
    } else if (tid < C) {
      cand_id[tid] = min(prev_id[tid - K] + 1, P - 1);
    }
    __syncthreads();  // cand_id set; frame t-2's buffer and sv no longer read
    for (int i = tid; i < (C + 1) * d4; i += THREADS) {
      const int r = i / d4, c = i - r * d4;
      if (r < C)
        reinterpret_cast<float4*>(cur + r * D)[c] = tgt4[(size_t)cand_id[r] * d4 + c];
      else
        sv4[c] = svn4[(size_t)t * d4 + c];
    }
    __syncthreads();

    {  // warp c: candidate c's norm, source dot and cross dots
      const float* row = cur + warp * D;
      const float n = warp_dot(row, row, d4, ln);
      const float s = warp_dot(row, sv, d4, ln);
      float x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = warp_dot(prv + prev_slot[j] * D, row, d4, ln);
      if (ln == 0) {
        cn[warp] = sqrtf(n);
        sdot[warp] = s;
#pragma unroll
        for (int j = 0; j < K; ++j) cross[j][warp] = x[j];
      }
    }
    __syncthreads();

    if (warp == 0) {
      const float b = baselines[t - 1];
      const bool low = b < 0.08f;
      const float w = (pitched && !low) ? 0.f : weight;
      float total = INFINITY;  // lanes past C never win
      if (ln < C) {
        float cc[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float v = __fsub_rn(1.f, __fdiv_rn(cross[j][ln], __fmul_rn(prev_norm[j], cn[ln])));
          if (pitched) {
            if (low && v < __fmul_rn(5.f, b)) v = 0.f;
          } else if (v > b) {
            v = __fsub_rn(__fmul_rn(1.5f, v), b);
          }
          cc[j] = v;
        }
        const float matching = __fsub_rn(1.f, __fdiv_rn(sdot[ln], cn[ln]));
        total = __fadd_rn(__fmul_rn(w, median4(cc[0], cc[1], cc[2], cc[3])), matching);
        if (pitched)
          total = __fadd_rn(total, fabsf(__fsub_rn(tgt_lf0[cand_id[ln]], src_lf0[t])));
        if (isnan(total)) total = INFINITY;  // sorts last, as torch.sort puts NaN
      }
      int my_pick = 0;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        float v = total;
        int j = ln;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, off);
          const int oj = __shfl_xor_sync(0xffffffffu, j, off);
          if (ov < v || (ov == v && oj < j)) {
            v = ov;
            j = oj;
          }
        }
        if (ln == s) my_pick = j;
        if (ln == j) total = INFINITY;
      }
      __syncwarp();  // every lane has read prev_norm before lanes < K rewrite it
      if (ln < K) {
        const int id = cand_id[my_pick];
        out[((size_t)t * L + lane) * K + ln] = id;
        prev_id[ln] = id;
        prev_slot[ln] = my_pick;
        prev_norm[ln] = cn[my_pick];
      }
      if (ln == 0) weight = w;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches one block per lane on `stream`; returns the cudaError_t of the
// launch (0 = success). idx and out are (T, L, 4) int32, svn (T, D), tgt
// (P, D), baselines (T-1,), src_lf0 (T,) and tgt_lf0 (P,) fp32, all
// contiguous and 16-byte aligned (checked by the Python wrapper); the f0
// tracks may be null when no lane is pitched.
int concat_cost_pair_f32(const int* idx, const float* svn, const float* tgt,
                         const float* baselines, const float* src_lf0, const float* tgt_lf0,
                         int* out, int T, int P, int D, int L, int pitched_mask,
                         float concat_weight, void* stream) {
  if (T <= 0 || P <= 0 || D <= 0 || D % 4 || L <= 0 || L > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (pitched_mask && (src_lf0 == nullptr || tgt_lf0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * C + 1) * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(concat_cost_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  concat_cost_kernel<<<L, THREADS, smem, (cudaStream_t)stream>>>(
      idx, svn, tgt, baselines, src_lf0, tgt_lf0, out, T, P, D, L, pitched_mask,
      concat_weight);
  return (int)cudaGetLastError();
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
