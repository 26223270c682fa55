// Fused self-attention with a gated relative-position bias, fp32 in and out,
// products on Hopper's tensor cores (sm_90a). Built with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (knnsvc_torch/ops/build.py, ops/attention.py).
//
// Replaces the TPU kernel knnsvc_tpu/ops/attention.py::gated_bias_attention
// (pl.pallas_call at attention.py:82, body _attn_kernel at :34):
//
//     out[h] = softmax(q[h] k[h]^T * d^-1/2 + gate[h, :, None] * bias[h]) v[h]
//
// q, k, v, out: (H, T, d) fp32 for any head dim d in 1..256; gate: (H, T)
// fp32. The bias comes in one of two forms, one entry each (template
// parameter FULL_BIAS):
//   - gated_bias_attention_full_f32: bias (H, T, T) fp32, row-major, as the
//     TPU kernel reads it; each (query block x key tile) bias tile is staged
//     from device memory by cp.async beside the K and V tiles;
//   - gated_bias_attention_f32: the (H, 2T-1) diagonal table of a Toeplitz
//     bias, bias[h, i, j] = diag[h, T-1 + j - i]. WavLM's relative-position
//     bias is that gather (models/wavlm/model.py::compute_position_diag), so
//     the served path reads 12 KB per head instead of 144 MB per launch at
//     T = 1500, and builds each tile's bias itself.
// Both run one inner loop; a Toeplitz bias through the full entry gives the
// diagonal entry's output bit for bit.
//
// Bound at the main path's shape (H=16, T=1500, d=64: one WavLM layer on a
// 30-s chunk):
//   - operations: 3 tensor-core passes (below) of 4*H*T^2*d = 9.2 GFLOP,
//     27.6 GFLOP at the H100's 495 TFLOP/s dense TF32: ~56 us;
//   - bytes: q, k, v, out 24.6 MB, diag and gate 0.3 MB: ~7 us at 3.35 TB/s;
//     the full entry adds its 144 MB bias: ~50 us.
// So the diagonal entry is bound by operations, the full entry by operations
// under 3 passes and by bytes under one.
//
// Why 3xTF32. A TF32 operand keeps 10 mantissa bits (~3 decimal digits), too
// few for the fp32 tolerances the port holds this kernel to (1e-4 at
// T = 1500, 2e-5 at T <= 200). Each operand x is split in registers into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (round to nearest, ties away:
// cvt.rna.tf32.f32's rounding, done with an integer add and mask, because
// ptxas expands that cvt into ~4 instructions and the split is most of this
// kernel's instructions), and a product is summed as lo*hi + hi*lo + hi*hi
// (small terms first) into fp32 accumulators; the dropped lo*lo term is
// ~2^-22 of the product. Under the port's "fastest" precision the same
// kernel takes one pass (hi*hi), as cuBLAS takes TF32 under that policy
// (template parameter PASSES).
//
// Head dims (template parameter DK, the instance's contraction width). d is
// zero-filled up to the smallest instance that holds it, DK = 16, 32, 64,
// 128 or 256, inside the kernel's copies (the zero columns add exact zeros
// to every product sum), so the caller pads nothing. At DK <= 64 a warp's
// Q fragments stay in registers (64 registers a thread at DK = 64); at
// DK = 128 and 256 they would not fit beside the output accumulators, so Q
// is staged in shared memory, pre-scaled, and split into hi and lo as it is
// read. Above 128 the output's columns are split into groups of DV = 128
// over the grid (blockIdx.z): each block forms S over all of d and writes
// its own columns. The scale d^-1/2 multiplies Q up front when it is a power
// of two (d = 1, 4, 16, 64, 256: exact either way) and S after the product
// otherwise, as the TPU kernel and the plain version do. Rows whose width
// is a multiple of 4 floats move in 16-byte copies, others in 4-byte ones.
// The tile shapes below are those of the main instance, DK = 64.
//
// Tile shapes. A block is one head and BQ = 64 queries: 4 warps, 16 query
// rows each. It streams BK = 32-key tiles of K and V, and the bias that
// (query block, key tile) pair reads (the BQ + BK - 1 diagonal values, or
// the BQ x BK tile of the full bias), through a 2-stage cp.async ring in
// shared memory (36.6 KB per block with the diagonal, 55.0 KB with full
// tiles; one barrier per tile, the next tile's copies in flight while a
// tile is computed), with an online softmax in registers (running row max
// and sum, rescaling the output when the max grows). 3 blocks fit an SM
// (168 registers a thread, the launch bound), so 16 heads x 24 query blocks
// = 384 blocks fill 132 SMs x 3 in one wave. BK = 32 rather than 64 keeps
// the score tile at 16 registers and the kernel free of spills. No score
// ever reaches device memory, nor a bias that was not given.
//
// Fragments (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32; lane =
// 4*g + t, g = lane/4, t = lane%4):
//   A (16x8): a0 (row g, k-slot t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8):  b0 (k-slot t, col g), b1 (t+4, g)
//   C (16x8): c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A sum over k does not care which k-slot holds which k, as long as A and B
// agree. So k-slot t holds element 2t of each 8-wide step and k-slot t+4
// element 2t+1:
//   - S = Q K^T: a0/a2 of a step are Q[g][2t], Q[g][2t+1], adjacent, and
//     b0/b1 are K[g][2t], K[g][2t+1], one 8-byte shared load; a warp's Q
//     fragments (16 rows x DK dims, hi and lo) stay in registers for the
//     whole key loop at DK <= 64, pre-scaled by d^-1/2 (0.125 at d = 64,
//     exact), or are read from Q's rows in shared memory (stride DK + 8, the
//     K rows' bank pattern) at DK = 128 and 256.
//   - O = P V: the S accumulator of keys 8n..8n+7 is already P's A fragment
//     (a0 = c0, a1 = c2, a2 = c1, a3 = c3), so P moves neither through
//     shuffles nor through shared memory; V's b0/b1 are V[2t][g], V[2t+1][g].
// Shared rows are padded so the 32 lanes hit distinct banks: K rows 72
// floats and full-bias rows 40 (8-byte loads: 8g + 2t + {0,1} over a
// half-warp), V rows 68 floats (4-byte loads: 8t + g); at other DK, K
// rows DK + 8 and V rows DV + 4 floats, the same banks. One fp32 load of a
// B element feeds two of the three products (hi to lo*hi and hi*hi, lo to
// hi*lo).
//
// Ragged T and d are masked inside the kernel: K and V rows past T, and
// columns past d, are zero-filled by the copies, keys past T get -inf AFTER
// the gate multiply (no zero or negative gate revives them), diagonal
// indices outside [0, 2T-2] and full-bias entries past T read 0, and rows
// past T and columns past d are computed on zeros and never stored. The caller pads nothing. The full bias's tiles move in
// 16-byte copies when T % 4 == 0 (every row then starts 16-byte aligned),
// else in 4-byte ones.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_D = 256;     // the widest head dim an instance takes
constexpr int BQ = 64;         // queries per block
constexpr int BK = 32;         // keys per tile
constexpr int NT = BK / 8;     // 8-key steps per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int BS = BK + 8;     // full-bias tile row stride in floats
constexpr int BIAS_N = BQ + BK - 1;
constexpr int BIAS_SLOTS = (BIAS_N + 3) / 4 * 4;
constexpr int STAGES = 2;

// The instance of contraction width DK: DV output columns a block, K rows
// of KS floats and V rows of VS in shared memory, Q in shared memory (QS)
// or in registers
template <int DK>
struct Inst {
  static constexpr int DV = DK > 128 ? 128 : DK;
  static constexpr bool QS = DK >= 128;
  static constexpr int KS = DK + 8;
  static constexpr int VS = DV + 4;
  static constexpr int QSS = DK + 8;
  static constexpr int MIN_BLOCKS = QS ? 1 : 3;
};

// a ring stage: K tile, V tile, then the diagonal values or the bias tile
template <int DK, bool FULL_BIAS>
__host__ __device__ constexpr int stage_floats() {
  return BK * Inst<DK>::KS + BK * Inst<DK>::VS + (FULL_BIAS ? BQ * BS : BIAS_SLOTS);
}

// the ring, then Q's rows when they live in shared memory
template <int DK, bool FULL_BIAS>
__host__ __device__ constexpr int smem_bytes() {
  return (STAGES * stage_floats<DK, FULL_BIAS>() + (Inst<DK>::QS ? BQ * Inst<DK>::QSS : 0)) *
         (int)sizeof(float);
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BIAS_N <= BIAS_SLOTS && BIAS_N <= THREADS, "one diagonal value per thread");
static_assert((BS * 4) % 16 == 0, "16-byte aligned shared rows");
static_assert(smem_bytes<256, true>() <= 232448, "the widest instance fits an SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` of 16 (or 4) copied from src, the rest of the slot zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32's result for finite x, in two integer instructions
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32; lo is not formed (and the compiler drops it) for 1 pass
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = PASSES == 3 ? rna_tf32(x - __uint_as_float(hi)) : 0u;
}

// 2^x; results below 2^-126 flush to 0 (weights under 1e-38 of the row max)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in PASSES tensor-core passes: lo*hi + hi*lo + hi*hi, or hi*hi
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  if (PASSES == 3) {
    mma_tf32(c, alo, bh0, bh1);
    mma_tf32(c, ahi, bl0, bl1);
  }
  mma_tf32(c, ahi, bh0, bh1);
}

// Copies rows x W floats (row r of the tile from src + r * d + col0, zeros
// at rows >= nrows and columns >= d - col0) into dst with row stride `stride`:
// 16-byte copies when d % 4 == 0, else 4-byte ones
template <int ROWS, int W>
__device__ __forceinline__ void copy_rows(float* dst, int stride, const float* src, int nrows,
                                          int d, int col0, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * W / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      const bool ok = r < nrows && col0 + c < d;
      cp_async16(dst + r * stride + c, src + (ok ? (size_t)r * d + col0 + c : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * W / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / W, c = idx % W;
      const bool ok = r < nrows && col0 + c < d;
      cp_async4(dst + r * stride + c, src + (ok ? (size_t)r * d + col0 + c : 0), ok ? 4 : 0);
    }
  }
}

// bias: the (H, T, T) bias (FULL_BIAS) or the (H, 2T-1) diagonal table.
// q_scale multiplies Q as it is loaded, s_scale S after the product (one
// of them is 1). WHOLE: d == DK, known when compiling (the main path's
// d = 64, whose d^-1/2 is a power of two), so that instance masks no
// column and keeps the arithmetic it had when 64 was the only head dim.
template <int PASSES, bool FULL_BIAS, int DK, bool WHOLE>
__global__ void __launch_bounds__(THREADS, Inst<DK>::MIN_BLOCKS)
gated_bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ gate, float* __restrict__ out, int T,
                            int d_arg, float q_scale, float s_scale) {
  using I = Inst<DK>;
  constexpr int DV = I::DV, KS = I::KS, VS = I::VS, QSS = I::QSS;
  constexpr int KSTEPS = DK / 8, NV = DV / 8;
  constexpr int STAGE_FLOATS = stage_floats<DK, FULL_BIAS>();
  static_assert(!WHOLE || DK == 64, "the whole instance is the main path's");
  extern __shared__ __align__(16) float smem[];

  const int d = WHOLE ? DK : d_arg;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int col0 = DV < DK ? blockIdx.z * DV : 0;  // this block's output columns
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  const size_t head = (size_t)h * T * d;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* bh = bias + (FULL_BIAS ? (size_t)h * T * T : (size_t)h * (2 * T - 1));
  const bool rows16 = (T & 3) == 0;
  const bool vec = (d & 3) == 0;               // every q, k, v row 16-byte aligned
  const int ntiles = (T + BK - 1) / BK;

  // key tile `tile` -> ring stage `stage`: K and V rows (zeros past T and d)
  // and either bias[q0 + r][k0 + c], r < BQ, c < BK (zeros past T), or
  // diag[T-1 + k0 - q0 - (BQ-1) + n], n < BQ + BK - 1 (zeros outside the table)
  auto load_tile = [&](int tile, int stage) {
    float* Ks = smem + stage * STAGE_FLOATS;
    float* Vs = Ks + BK * KS;
    float* Bs = Vs + BK * VS;
    const int k0 = tile * BK;
    if (DK == DV && vec) {  // K and V rows side by side
#pragma unroll
      for (int i = 0; i < BK * DK / 4 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / (DK / 4), c = (idx % (DK / 4)) * 4;
        const bool ok = k0 + r < T && (WHOLE || c < d);
        const size_t off = ok ? (size_t)(k0 + r) * d + c : 0;
        cp_async16(Ks + r * KS + c, kh + off, ok ? 16 : 0);
        cp_async16(Vs + r * VS + c, vh + off, ok ? 16 : 0);
      }
    } else {
      const int nrows = T - k0;
      copy_rows<BK, DK>(Ks, KS, kh + (size_t)k0 * d, nrows, d, 0, vec, tid);
      copy_rows<BK, DV>(Vs, VS, vh + (size_t)k0 * d, nrows, d, col0, vec, tid);
    }
    if (FULL_BIAS && rows16) {
#pragma unroll
      for (int i = 0; i < BQ * BK / 4 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
        const bool ok = q0 + r < T && k0 + c < T;
        cp_async16(Bs + r * BS + c, bh + (ok ? (size_t)(q0 + r) * T + k0 + c : 0), ok ? 16 : 0);
      }
    } else if (FULL_BIAS) {
#pragma unroll 4
      for (int i = 0; i < BQ * BK / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BK, c = idx % BK;
        const bool ok = q0 + r < T && k0 + c < T;
        cp_async4(Bs + r * BS + c, bh + (ok ? (size_t)(q0 + r) * T + k0 + c : 0), ok ? 4 : 0);
      }
    } else if (tid < BIAS_N) {
      const int idx = T - 1 + k0 - q0 - (BQ - 1) + tid;
      const bool ok = idx >= 0 && idx <= 2 * T - 2;
      cp_async4(Bs + tid, bh + (ok ? idx : 0), ok ? 4 : 0);
    }
  };

  load_tile(0, 0);
  cp_async_commit();

  // this thread's query rows: ii[r] = warp*16 + g + 8r within the block
  const int ii0 = warp * 16 + g;
  bool row_ok[2];
  float gv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_ok[r] = q0 + ii0 + 8 * r < T;
    gv[r] = row_ok[r] ? gate[(size_t)h * T + q0 + ii0 + 8 * r] : 0.f;
  }

  // Q, pre-scaled by q_scale, zeros past T and d: the A fragments of the
  // DK/8 k-steps in registers (hi and lo), or the block's rows in shared
  // memory after the ring, which the first barrier of the key loop publishes
  constexpr int QREG = I::QS ? 1 : KSTEPS;
  uint32_t qhi[QREG][4], qlo[QREG][4];
  float* Qs = smem + STAGES * STAGE_FLOATS;
  if constexpr (I::QS) {
    for (int idx = tid; idx < BQ * DK; idx += THREADS) {
      const int r = idx / DK, c = idx % DK;
      Qs[r * QSS + c] = q0 + r < T && c < d ? q[head + (size_t)(q0 + r) * d + c] * q_scale : 0.f;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      float2 x[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* qrow = q + head + (size_t)(q0 + ii0 + 8 * r) * d;
        const int c = ks * 8 + 2 * t;
        if (WHOLE)
          x[r] = row_ok[r] ? *reinterpret_cast<const float2*>(qrow + c) : make_float2(0.f, 0.f);
        else
          x[r] = make_float2(row_ok[r] && c < d ? qrow[c] : 0.f,
                             row_ok[r] && c + 1 < d ? qrow[c + 1] : 0.f);
      }
      split<PASSES>(x[0].x * q_scale, qhi[ks][0], qlo[ks][0]);
      split<PASSES>(x[1].x * q_scale, qhi[ks][1], qlo[ks][1]);
      split<PASSES>(x[0].y * q_scale, qhi[ks][2], qlo[ks][2]);
      split<PASSES>(x[1].y * q_scale, qhi[ks][3], qlo[ks][3]);
    }
  }

  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of each row sum

  for (int tile = 0; tile < ntiles; ++tile) {
    // one barrier per tile: after it, this tile has landed and every warp is
    // done with the other stage, which then takes the next tile while this
    // one is computed
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < ntiles) {
      load_tile(tile + 1, (tile + 1) & 1);
      cp_async_commit();
    }

    const float* Ks = smem + (tile & 1) * STAGE_FLOATS;
    const float* Vs = Ks + BK * KS;
    const float* Bs = Vs + BK * VS;
    const int k0 = tile * BK;

    // s[n][c]: row ii0 + 8*(c/2), key k0 + 8n + 2t + c%2
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qh[4], ql[4];
      if constexpr (I::QS) {
        const float2 x0 = *reinterpret_cast<const float2*>(Qs + ii0 * QSS + ks * 8 + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(Qs + (ii0 + 8) * QSS + ks * 8 + 2 * t);
        split<PASSES>(x0.x, qh[0], ql[0]);
        split<PASSES>(x1.x, qh[1], ql[1]);
        split<PASSES>(x0.y, qh[2], ql[2]);
        split<PASSES>(x1.y, qh[3], ql[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qh[c] = qhi[ks][c];
          ql[c] = qlo[ks][c];
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kb = *reinterpret_cast<const float2*>(Ks + (n * 8 + g) * KS + ks * 8 + 2 * t);
        uint32_t bh0, bh1, bl0, bl1;
        split<PASSES>(kb.x, bh0, bl0);
        split<PASSES>(kb.y, bh1, bl1);
        mma_passes<PASSES>(s[n], qh, ql, bh0, bh1, bl0, bl1);
      }
    }
    if (!WHOLE && s_scale != 1.f) {  // d^-1/2 not a power of two: scale S, then add the bias
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] *= s_scale;
    }

    // + gate * bias: bias[i][j] = Bs[ii * BS + jj] (full) or Bs[jj - ii + BQ - 1]
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jj = n * 8 + 2 * t, ii = ii0 + 8 * r;
        const float2 b = FULL_BIAS ? *reinterpret_cast<const float2*>(Bs + ii * BS + jj)
                              : make_float2(Bs[jj - ii + BQ - 1], Bs[jj + 1 - ii + BQ - 1]);
        s[n][2 * r] = fmaf(gv[r], b.x, s[n][2 * r]);
        s[n][2 * r + 1] = fmaf(gv[r], b.y, s[n][2 * r + 1]);
      }
    if (k0 + BK > T) {  // keys past T: -inf after the gate multiply
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + n * 8 + 2 * t + (c & 1) >= T) s[n][c] = -INFINITY;
    }

    // online softmax; every tile holds key k0 < T, so each new max is finite
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = ex2((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = ex2((s[n][c] - m[c >> 1]) * LOG2E);
        l[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int dn = 0; dn < NV; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c >> 1];

    // O += P V; P's A fragment for keys 8n..8n+7 is s[n] (see the note above)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t phi[4], plo[4];
      split<PASSES>(s[n][0], phi[0], plo[0]);
      split<PASSES>(s[n][2], phi[1], plo[1]);
      split<PASSES>(s[n][1], phi[2], plo[2]);
      split<PASSES>(s[n][3], phi[3], plo[3]);
      const float* vrow = Vs + (n * 8 + 2 * t) * VS + g;
#pragma unroll
      for (int dn = 0; dn < NV; ++dn) {
        uint32_t bh0, bh1, bl0, bl1;
        split<PASSES>(vrow[dn * 8], bh0, bl0);
        split<PASSES>(vrow[VS + dn * 8], bh1, bl1);
        mma_passes<PASSES>(o[dn], phi, plo, bh0, bh1, bl0, bl1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    if (!row_ok[r]) continue;
    float* orow = out + head + (size_t)(q0 + ii0 + 8 * r) * d + col0 + 2 * t;
#pragma unroll
    for (int dn = 0; dn < NV; ++dn) {
      const float x = o[dn][2 * r] / l[r], y = o[dn][2 * r + 1] / l[r];
      if (WHOLE) {
        *reinterpret_cast<float2*>(orow + dn * 8) = make_float2(x, y);
      } else {
        const int c = col0 + dn * 8 + 2 * t;
        if (c < d) orow[dn * 8] = x;
        if (c + 1 < d) orow[dn * 8 + 1] = y;
      }
    }
  }
}

// Asks for the block's shared memory (past the 48-KB default limit at
// DK = 64 with full tiles and at DK >= 128) and the SM's largest carveout,
// then launches one block per (64 queries, head, DV output columns)
template <int PASSES, bool FULL_BIAS, int DK, bool WHOLE = false>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* gate, float* out, int H, int T, int d, float q_scale,
                   float s_scale, cudaStream_t stream) {
  auto kernel = gated_bias_attention_kernel<PASSES, FULL_BIAS, DK, WHOLE>;
  constexpr int smem = smem_bytes<DK, FULL_BIAS>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int DV = Inst<DK>::DV;
  const dim3 grid((T + BQ - 1) / BQ, H, (d + DV - 1) / DV);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, bias, gate, out, T, d, q_scale, s_scale);
  return cudaGetLastError();
}

// the smallest instance that holds d
template <int PASSES, bool FULL_BIAS>
cudaError_t launch_dim(const float* q, const float* k, const float* v, const float* bias,
                       const float* gate, float* out, int H, int T, int d, float q_scale,
                       float s_scale, cudaStream_t s) {
  if (d == 64)
    return launch<PASSES, FULL_BIAS, 64, true>(q, k, v, bias, gate, out, H, T, d, q_scale,
                                               s_scale, s);
  if (d <= 16)
    return launch<PASSES, FULL_BIAS, 16>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, s);
  if (d <= 32)
    return launch<PASSES, FULL_BIAS, 32>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, s);
  if (d <= 64)
    return launch<PASSES, FULL_BIAS, 64>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, s);
  if (d <= 128)
    return launch<PASSES, FULL_BIAS, 128>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, s);
  return launch<PASSES, FULL_BIAS, 256>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, s);
}

template <bool FULL_BIAS>
int launch_passes(const float* q, const float* k, const float* v, const float* bias,
                  const float* gate, float* out, int H, int T, int d, float q_scale,
                  float s_scale, int passes, void* stream) {
  if (d < 1 || d > MAX_D || H <= 0 || T <= 0 || H > 65535 || T > (1 << 29) ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(passes == 3 ? launch_dim<3, FULL_BIAS>(q, k, v, bias, gate, out, H, T, d, q_scale,
                                                      s_scale, s)
                           : launch_dim<1, FULL_BIAS>(q, k, v, bias, gate, out, H, T, d, q_scale,
                                                      s_scale, s));
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return the cudaError_t of the launch
// (0 = success). d: the head dim, 1..256. q_scale multiplies Q as it is
// loaded and s_scale the product Q K^T (d^-1/2 and 1 when d^-1/2 is a power
// of two, else 1 and d^-1/2). passes: 3 (3xTF32, fp32-grade) or 1 (TF32).
// Pointers must be 16-byte aligned (4-byte for q, k, v, out when d % 4 != 0)
// and the tensors contiguous (checked by the Python wrapper).

// bias: the (H, 2T-1) diagonal table of a Toeplitz bias
int gated_bias_attention_f32(const float* q, const float* k, const float* v, const float* diag,
                             const float* gate, float* out, int H, int T, int d, float q_scale,
                             float s_scale, int passes, void* stream) {
  return launch_passes<false>(q, k, v, diag, gate, out, H, T, d, q_scale, s_scale, passes,
                              stream);
}

// bias: (H, T, T), row-major
int gated_bias_attention_full_f32(const float* q, const float* k, const float* v,
                                  const float* bias, const float* gate, float* out, int H, int T,
                                  int d, float q_scale, float s_scale, int passes, void* stream) {
  return launch_passes<true>(q, k, v, bias, gate, out, H, T, d, q_scale, s_scale, passes, stream);
}

const char* knnsvc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
