// Fused self-attention with a gated relative-position bias, fp32, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and bound with ctypes (knnsvc_torch/ops/build.py, ops/attention.py).
//
// Replaces the TPU kernel knnsvc_tpu/ops/attention.py::gated_bias_attention
// (pl.pallas_call at attention.py:82, body _attn_kernel at :34):
//
//     out[h] = softmax(q[h] k[h]^T * d^-1/2 + gate[h, :, None] * bias[h]) v[h]
//
// q, k, v, out: (H, T, 64) fp32; bias: (H, T, T) fp32; gate: (H, T) fp32.
//
// What bounds it at the main path's shape (H=16, T=1500, d=64, one WavLM
// layer on a 30-s chunk):
//   - operations: 4*H*T^2*d = 9.2 GFLOP of fp32 products, ~137 us at the
//     H100's 67 TFLOP/s fp32 rate outside the tensor cores;
//   - bytes: the (H, T, T) bias is 144 MB, q/k/v/out 24.6 MB, ~169 MB in
//     all, ~50 us at 3.35 TB/s.
// So in fp32 on the CUDA cores it is bound by operations.
//
// Design. The Pallas kernel keeps a whole (256, T) score row in VMEM and
// takes a one-pass softmax. A block here has at most 227 KB of shared
// memory, and a (64, 1500) fp32 score tile alone is 384 KB, so each block
// (one head, 64 queries) streams 64-key tiles of K, V and the bias through
// shared memory with an online softmax (running row max and sum, rescaling
// the partial output when the max grows). No score ever reaches device
// memory; the bias is read once, straight from global memory into
// registers. Ragged T is handled inside the kernel with bounds masks: keys
// past T get -inf, whatever the gate, and rows past T are computed on zeros
// and never stored, so the caller pads nothing (padding the bias would be a
// 144 MB copy). 256 threads as 16x16: thread (ty, tx) owns score rows
// ty*4..+3 and key columns tx*4..+3 of a tile, and output rows ty*4..+3,
// dims tx*4..+3; row reductions are 16-lane shuffles. Tensor cores (TF32
// wgmma), TMA and building the bias in-kernel from its (2T-1, H) diagonal
// table are left for later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int D = 64;         // head dim
constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
// Qs [BQ][D] + Kt [D][BK] (K transposed) + Vs [BK][D] + Ps [BQ][BK]
constexpr int SMEM_BYTES = (BQ * D + D * BK + BK * D + BQ * BK) * (int)sizeof(float);

__device__ __forceinline__ float f4_get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(THREADS, 2)
gated_bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ gate, float* __restrict__ out,
                            int T, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * D;
  float* Vs = Kt + D * BK;
  float* Ps = Vs + BK * D;

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const size_t head = (size_t)h * T * D;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* bh = bias + (size_t)h * T * T;
  const float* gh = gate + (size_t)h * T;

  for (int idx = tid; idx < BQ * D / 4; idx += THREADS) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) val = reinterpret_cast<const float4*>(qh + (size_t)(q0 + r) * D)[c4];
    reinterpret_cast<float4*>(Qs + r * D)[c4] = val;
  }

  bool row_ok[4];
  float g[4], m[4], l[4], o[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty * 4 + a;
    row_ok[a] = r < T;
    g[a] = row_ok[a] ? gh[r] : 0.f;
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  }
  const bool vec_bias = (T & 3) == 0;  // 16-byte aligned bias rows

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // Qs written / previous tile's Kt, Vs, Ps consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx % BK, dd = idx / BK;
      Kt[dd * BK + j] = (k0 + j < T) ? kh[(size_t)(k0 + j) * D + dd] : 0.f;
    }
    for (int idx = tid; idx < BK * D / 4; idx += THREADS) {
      const int j = idx / (D / 4), c4 = idx % (D / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < T) val = reinterpret_cast<const float4*>(vh + (size_t)(k0 + j) * D)[c4];
      reinterpret_cast<float4*>(Vs + j * D)[c4] = val;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;

#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + a) * D + dd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 kb = *reinterpret_cast<const float4*>(Kt + (dd + e) * BK + tx * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float qv = f4_get(qa[a], e);
          s[a][0] += qv * kb.x;
          s[a][1] += qv * kb.y;
          s[a][2] += qv * kb.z;
          s[a][3] += qv * kb.w;
        }
      }
    }

    const int c0 = k0 + tx * 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float bv[4] = {0.f, 0.f, 0.f, 0.f};
      if (row_ok[a]) {
        const float* brow = bh + (size_t)(q0 + ty * 4 + a) * T + c0;
        if (vec_bias && c0 + 3 < T) {
          const float4 b4 = __ldg(reinterpret_cast<const float4*>(brow));
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < T) bv[b] = __ldg(brow + b);
        }
      }
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // keys past T get -inf AFTER the gate multiply: no gate revives them
        s[a][b] = (c0 + b < T) ? s[a][b] * scale + g[a] * bv[b] : -INFINITY;
        tmax = fmaxf(tmax, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // every tile holds key k0 < T, so m_new is finite
      const float m_new = fmaxf(m[a], tmax);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = expf(s[a][b] - m_new);
        rs += s[a][b];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + a) * BK + tx * 4) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + a) * BK + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 vb = *reinterpret_cast<const float4*>(Vs + (j + e) * D + tx * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = f4_get(pa[a], e);
          o[a][0] += p * vb.x;
          o[a][1] += p * vb.y;
          o[a][2] += p * vb.z;
          o[a][3] += p * vb.w;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!row_ok[a]) continue;
    float* orow = out + head + (size_t)(q0 + ty * 4 + a) * D + tx * 4;
    *reinterpret_cast<float4*>(orow) =
        make_float4(o[a][0] / l[a], o[a][1] / l[a], o[a][2] / l[a], o[a][3] / l[a]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Pointers must be 16-byte aligned and the tensors contiguous (checked by
// the Python wrapper).
int gated_bias_attention_f32(const float* q, const float* k, const float* v,
                             const float* bias, const float* gate, float* out,
                             int H, int T, int d, float scale, void* stream) {
  if (d != D || H <= 0 || T <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gated_bias_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H);
  gated_bias_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q, k, v, bias, gate, out, T, scale);
  return (int)cudaGetLastError();
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
