// Device code shared by the fused-step kernels (fused_step.cu: K1-K4) and
// the step-anatomy probes (kernel_prof.cu: K5): the argument block, the
// FFMA product routine, the deterministic block sum, the tile and weight
// staging of the first pass and the CTA-ordered sums and Adam update of
// the second.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16
#define THREADS 256

// What stays fixed over a fit (parameter and Adam-state pointers, widths),
// so the host builds it once; x, y and mask are launch arguments.  With
// experts, each pointer is that of expert 0 of its stack.
struct StepArgs {
  float* w[MAX_LAYERS];
  float* b[MAX_LAYERS];
  float* mw[MAX_LAYERS];
  float* vw[MAX_LAYERS];
  float* mb[MAX_LAYERS];
  float* vb[MAX_LAYERS];
  int32_t dims[MAX_LAYERS + 1];
  float w0[MAX_LAYERS];
  int32_t L;
  int32_t B;
  int32_t rows;     // batch rows per CTA
  int32_t stage_w;  // 1: weights and biases staged in shared memory
  int32_t mm_bf16;  // 1: product operands rounded to bf16 (mm_dtype "bfloat16")
};

namespace {

// v rounded to the nearest bf16 (ties to even), back in f32: the value
// JAX's astype(bfloat16) gives.  Two such values multiply exactly in f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out(i, j) = sum_k a(i, k) * b(k, j) for an M x N product, 4x4 outputs per
// thread, k ascending; ep(i, j, acc) consumes each result.  kBf16: each
// operand is rounded to bf16 as it is read (mm_dtype "bfloat16"), and the
// exact product is accumulated in f32 with FFMA.
template <bool kBf16 = false, class AF, class BF, class EP>
__device__ __forceinline__ void mm4x4(int M, int N, int K, AF a, BF b, EP ep) {
  const int tm = (M + 3) >> 2, tn = (N + 3) >> 2;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int i0 = (t / tn) << 2, j0 = (t % tn) << 2;
    float acc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) av[ii] = (i0 + ii < M) ? a(i0 + ii, k) : 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = (j0 + jj < N) ? b(k, j0 + jj) : 0.0f;
      if constexpr (kBf16) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) av[ii] = bf16_round(av[ii]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = bf16_round(bv[jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (i0 + ii < M && j0 + jj < N) ep(i0 + ii, j0 + jj, acc[ii][jj]);
  }
}

// Deterministic block sum of v[0..n): fixed per-thread strides, then a
// fixed tree.  Every thread gets the result.
__device__ float block_sum(const float* v, int n, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s = __fadd_rn(s, v[i]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x >> 1; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int n_params(const StepArgs& a) {
  int p = 0;
  for (int l = 0; l < a.L; ++l) p += a.dims[l] * a.dims[l + 1] + a.dims[l + 1];
  return p;
}

// per-expert element offsets of layer l's weight and bias stacks
__device__ __forceinline__ size_t w_off(const StepArgs& a, int l, int e) {
  return (size_t)e * a.dims[l] * a.dims[l + 1];
}
__device__ __forceinline__ size_t b_off(const StepArgs& a, int l, int e) {
  return (size_t)e * a.dims[l + 1];
}

// A global load; kCG: cached in L2 only, for data that this launch may have
// rewritten from another SM since this SM last read it.
template <bool kCG>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kCG) return __ldcg(p);
  else return *p;
}

// Stage batch rows row0 .. row0+R-1 of x (F wide), y (C wide) and mask into
// xs, ys, ms; rows past a.B are zero and masked out.
__device__ __forceinline__ void stage_tile(const StepArgs& a, int row0, int R, int F, int C,
                                           const float* x, const float* y, const float* mask,
                                           float* xs, float* ys, float* ms) {
  for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
    const int r = i / F;
    xs[i] = (row0 + r < a.B) ? x[(size_t)(row0 + r) * F + (i - r * F)] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C;
    ys[i] = (row0 + r < a.B) ? y[(size_t)(row0 + r) * C + (i - r * C)] : 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    ms[r] = (row0 + r < a.B) ? mask[row0 + r] : 0.0f;
}

// Stage expert e's weights and biases into p: layer by layer, weight then
// bias.
template <bool kCG>
__device__ __forceinline__ void stage_weights(const StepArgs& a, int e, float* p) {
  for (int l = 0; l < a.L; ++l) {
    const int n = a.dims[l] * a.dims[l + 1];
    const float* wg = a.w[l] + w_off(a, l, e);
    const float* bg = a.b[l] + b_off(a, l, e);
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = ld<kCG>(wg + i);
    p += n;
    for (int i = threadIdx.x; i < a.dims[l + 1]; i += blockDim.x) p[i] = ld<kCG>(bg + i);
    p += a.dims[l + 1];
  }
}

// Column `col` of an (n_rows, S) scratch summed in row (CTA) order.
template <bool kCG>
__device__ __forceinline__ float col_sum(const float* scratch, int n_rows, int S, int col) {
  float s = 0.0f;
  for (int c = 0; c < n_rows; ++c) s = __fadd_rn(s, ld<kCG>(scratch + (size_t)c * S + col));
  return s;
}

// Adam on parameter p of expert e (layer by layer, weight then bias) with
// its scaled gradient g: params, m and v in place; c1, c2 the bias
// corrections (1 for none).
template <bool kCG>
__device__ __forceinline__ void adam_update(const StepArgs& a, int e, int p, float g, float lr,
                                            float c1, float c2) {
  float *th = nullptr, *m = nullptr, *v = nullptr;
  int q = p;
  for (int l = 0; l < a.L; ++l) {
    const int nw = a.dims[l] * a.dims[l + 1], nb = a.dims[l + 1];
    if (q < nw) {
      const size_t o = w_off(a, l, e) + q;
      th = a.w[l] + o; m = a.mw[l] + o; v = a.vw[l] + o;
      break;
    }
    q -= nw;
    if (q < nb) {
      const size_t o = b_off(a, l, e) + q;
      th = a.b[l] + o; m = a.mb[l] + o; v = a.vb[l] + o;
      break;
    }
    q -= nb;
  }
  const float m_new = __fadd_rn(__fmul_rn(0.9f, ld<kCG>(m)), __fmul_rn(0.1f, g));
  const float v_new =
      __fadd_rn(__fmul_rn(0.999f, ld<kCG>(v)), __fmul_rn(__fmul_rn(0.001f, g), g));
  const float step = __fdiv_rn(__fmul_rn(lr, __fmul_rn(m_new, c1)),
                               __fadd_rn(sqrtf(__fmul_rn(v_new, c2)), 1e-8f));
  *th = __fsub_rn(ld<kCG>(th), step);
  *m = m_new;
  *v = v_new;
}

}  // namespace
