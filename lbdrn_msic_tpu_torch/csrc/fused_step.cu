// One fused SIREN training step on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel lbdrn_msic_tpu/ops/fused_step.py::
// fused_train_step (body `_kernel`, with `_fwd_bwd`, `_adam`, `sincos`):
// forward through L = nl+1 full-f32 layers (hidden sin(w0 z) and w0 cos(w0 z)
// from one shared Cody-Waite reduction, sigmoid head), masked SSE, the
// hand-derived backward (no dX for layer 0), gradients summed over the
// whole batch, and one Adam update with torch bias correction, in place.
// loss = SSE / (max(sum mask, 1) * C).
//
// Design.  The TPU walks the batch tiles in order and carries the gradient
// sums in VMEM; here CTAs run in parallel, so the step is two launches:
//   pass 1  one CTA per `rows` batch rows (64 at the bench shape: 128 CTAs
//           for B = 8192, one wave on 132 SMs).  x tile, weights, the
//           activations and cos caches live in shared memory (~184 KB at
//           128->64->64->4).  Wider layer sets take fewer rows per CTA and,
//           where even 8 rows do not fit, read the weights from global memory
//           (the host picks; see ops/fused_step.py::cta_layout).  It writes its
//           partial dW/db, its SSE and its mask count to a scratch row of its
//           own.  Rows past B are masked.
//   pass 2  one thread per parameter sums the partials in CTA order, scales
//           by inv_scale and applies Adam to params, m and v in place;
//           thread 0 also writes the loss.
// No float atomics: the step is deterministic run to run.
//
// Bound at the bench shape (B = 8192, 128->64->64->4): about 0.51 GFLOP
// (forward 205.5 M, dW 205.5 M, dH 71.3 M, sincos ~26 M) against about
// 4.7 MB of compulsory traffic (x is 4.2 MB).  In f32 on the CUDA cores
// (67 TFLOP/s on an SXM card) that is ~7.6 us a step: compute-bound.  This
// first version multiplies with FFMA from shared memory in 4x4 register
// tiles and makes no attempt at that bound; the partial-gradient scratch
// (128 x 50.7 KB = 6.5 MB written and read per step, resident in L2) is the
// first thing a faster version removes, then tensor-core (3xTF32) products.
//
// Arithmetic outside the matrix products uses explicitly rounded
// operations (__fmul_rn / __fadd_rn: no FMA contraction), in the operation
// order of the plain PyTorch version, so only summation order differs.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 16
#define THREADS 256

// What stays fixed over a fit (parameter and Adam-state pointers, widths),
// so the host builds it once; x, y and mask are launch arguments.
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
};

namespace {

constexpr float kInvPi = 0.31830987449645996f;
constexpr float kPiHi = 3.14159274101257324f;
constexpr float kPiLo = -8.742277657347586e-08f;
constexpr float kSin0 = 1.0f, kSin1 = -0.16666647791862488f,
                kSin2 = 0.008332899771630764f, kSin3 = -0.00019800907466560602f,
                kSin4 = 2.5905085294652963e-06f;
constexpr float kCos0 = 0.9999999403953552f, kCos1 = -0.4999990463256836f,
                kCos2 = 0.04166358709335327f, kCos3 = -0.001385371433570981f,
                kCos4 = 2.31541689572623e-05f;

// (sin u, cos u) from one shared range reduction; rintf rounds half to even
// like jnp.round / torch.round.
__device__ __forceinline__ void sincos_poly(float u, float* s, float* c) {
  float k = rintf(__fmul_rn(u, kInvPi));
  float r = __fsub_rn(__fsub_rn(u, __fmul_rn(k, kPiHi)), __fmul_rn(k, kPiLo));
  float f = __fmul_rn(k, 0.5f);
  f = __fsub_rn(f, rintf(f));
  float sg = __fsub_rn(1.0f, __fmul_rn(8.0f, __fmul_rn(f, f)));
  float r2 = __fmul_rn(r, r);
  float ps = kSin4, pc = kCos4;
  ps = __fadd_rn(__fmul_rn(ps, r2), kSin3); pc = __fadd_rn(__fmul_rn(pc, r2), kCos3);
  ps = __fadd_rn(__fmul_rn(ps, r2), kSin2); pc = __fadd_rn(__fmul_rn(pc, r2), kCos2);
  ps = __fadd_rn(__fmul_rn(ps, r2), kSin1); pc = __fadd_rn(__fmul_rn(pc, r2), kCos1);
  ps = __fadd_rn(__fmul_rn(ps, r2), kSin0); pc = __fadd_rn(__fmul_rn(pc, r2), kCos0);
  *s = __fmul_rn(__fmul_rn(sg, r), ps);
  *c = __fmul_rn(sg, pc);
}

// out(i, j) = sum_k a(i, k) * b(k, j) for an M x N product, 4x4 outputs per
// thread, k ascending; ep(i, j, acc) consumes each result.
template <class AF, class BF, class EP>
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

// kStageW: weights and biases staged in shared memory (a separate
// instantiation, so that its products read through shared-memory loads)
template <bool kStageW>
__global__ void __launch_bounds__(THREADS) step_partials(StepArgs a, const float* x,
                                                          const float* y, const float* mask,
                                                          float* scratch) {
  extern __shared__ float smem[];
  const int L = a.L, R = a.rows, F = a.dims[0], C = a.dims[L];
  const int row0 = blockIdx.x * R;
  const int P = n_params(a);
  float* part = scratch + (size_t)blockIdx.x * (P + 2);

  int gmax = 0;
  for (int l = 1; l <= L; ++l) gmax = max(gmax, a.dims[l]);
  // shared-memory carve-up (sizes in floats; the wrapper sums the same)
  float* xs = smem;
  float* cur = xs + R * F;
  float* ys = cur;   cur += R * C;
  float* ms = cur;   cur += R;
  float* red = cur;  cur += THREADS;
  float* ga = cur;   cur += R * gmax;
  float* gb = cur;   cur += R * gmax;
  float* wsm = cur;  // [weights then biases of every layer,] then activations

  // stage the batch tile (rows past B are zero and masked out)
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
  if (kStageW) {
    float* p = wsm;
    for (int l = 0; l < L; ++l) {
      const int n = a.dims[l] * a.dims[l + 1];
      for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = a.w[l][i];
      p += n;
      for (int i = threadIdx.x; i < a.dims[l + 1]; i += blockDim.x) p[i] = a.b[l][i];
      p += a.dims[l + 1];
    }
  }
  __syncthreads();

  // layout helpers: layer l's weight and bias (shared memory when staged,
  // else global), its input activation h_l (h_0 = xs) and the cos cache of
  // its output
  float* acts = kStageW ? wsm + P : wsm;  // h_1..h_{L-1}, then cos_0..cos_{L-2}
  auto wl = [&](int l) -> const float* {
    if constexpr (!kStageW) return a.w[l];
    float* p = wsm;
    for (int q = 0; q < l; ++q) p += a.dims[q] * a.dims[q + 1] + a.dims[q + 1];
    return p;
  };
  auto bl = [&](int l) -> const float* {
    if constexpr (kStageW) return wl(l) + a.dims[l] * a.dims[l + 1];
    return a.b[l];
  };
  auto hl = [&](int l) -> float* {  // input of layer l
    if (l == 0) return xs;
    float* p = acts;
    for (int q = 1; q < l; ++q) p += R * a.dims[q];
    return p;
  };
  auto cosl = [&](int l) -> float* {  // w0 * cos of layer l's output, l < L-1
    float* p = acts;
    for (int q = 1; q < L; ++q) p += R * a.dims[q];
    for (int q = 0; q < l; ++q) p += R * a.dims[q + 1];
    return p;
  };

  // ---- forward through the hidden layers
  for (int l = 0; l < L - 1; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    const float* hin = hl(l);
    const float* W = wl(l);
    const float* bias = bl(l);
    float* hout = hl(l + 1);
    float* co = cosl(l);
    const float w0 = a.w0[l];
    mm4x4(R, dout, din,
          [&](int i, int k) { return hin[i * din + k]; },
          [&](int k, int j) { return W[k * dout + j]; },
          [&](int i, int j, float acc) {
            const float u = __fmul_rn(w0, __fadd_rn(acc, bias[j]));
            float s, c;
            sincos_poly(u, &s, &c);
            hout[i * dout + j] = s;
            co[i * dout + j] = __fmul_rn(w0, c);
          });
    __syncthreads();
  }

  // ---- sigmoid head, masked squared error, d(sum se)/dz_last
  {
    const int din = a.dims[L - 1];
    const float* hin = hl(L - 1);
    const float* W = wl(L - 1);
    const float* bias = bl(L - 1);
    mm4x4(R, C, din,
          [&](int i, int k) { return hin[i * din + k]; },
          [&](int k, int j) { return W[k * C + j]; },
          [&](int i, int j, float acc) {
            const float z = __fadd_rn(acc, bias[j]);
            const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
            const float diff = __fmul_rn(__fsub_rn(p, ys[i * C + j]), ms[i]);
            gb[i * C + j] = __fmul_rn(diff, diff);
            ga[i * C + j] = __fmul_rn(__fmul_rn(2.0f, diff),
                                      __fmul_rn(p, __fsub_rn(1.0f, p)));
          });
    __syncthreads();
    const float sse = block_sum(gb, R * C, red);
    const float cnt = block_sum(ms, R, red);
    if (threadIdx.x == 0) {
      part[P] = sse;
      part[P + 1] = cnt;
    }
  }

  // ---- backward: partial dW, db of every layer; dH down to layer 1
  float* g = ga;
  float* gn = gb;
  int off = P;
  for (int l = L - 1; l >= 0; --l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    const float* hin = hl(l);
    const float* W = wl(l);
    off -= din * dout + dout;
    float* dW = part + off;
    float* db = dW + din * dout;
    const float* gc = g;
    mm4x4(din, dout, R,
          [&](int i, int k) { return hin[k * din + i]; },
          [&](int k, int j) { return gc[k * dout + j]; },
          [&](int i, int j, float acc) { dW[i * dout + j] = acc; });
    for (int j = threadIdx.x; j < dout; j += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = __fadd_rn(s, gc[r * dout + j]);
      db[j] = s;
    }
    if (l > 0) {
      const float* co = cosl(l - 1);
      float* gw = gn;
      mm4x4(R, din, dout,
            [&](int i, int k) { return gc[i * dout + k]; },
            [&](int k, int j) { return W[j * dout + k]; },
            [&](int i, int j, float acc) { gw[i * din + j] = __fmul_rn(acc, co[i * din + j]); });
    }
    __syncthreads();
    float* t = g; g = gn; gn = t;
  }
}

__global__ void step_adam(StepArgs a, const float* scratch, int n_cta, float* loss,
                          float lr, float c1, float c2) {
  const int P = n_params(a);
  const int S = P + 2;
  const int C = a.dims[a.L];
  float cnt = 0.0f;
  for (int c = 0; c < n_cta; ++c) cnt = __fadd_rn(cnt, scratch[(size_t)c * S + P + 1]);
  const float inv_scale = __fdiv_rn(1.0f, __fmul_rn(fmaxf(cnt, 1.0f), (float)C));
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p == 0) {
    float sse = 0.0f;
    for (int c = 0; c < n_cta; ++c) sse = __fadd_rn(sse, scratch[(size_t)c * S + P]);
    *loss = __fmul_rn(sse, inv_scale);
  }
  if (p >= P) return;
  float g = 0.0f;
  for (int c = 0; c < n_cta; ++c) g = __fadd_rn(g, scratch[(size_t)c * S + p]);
  g = __fmul_rn(g, inv_scale);

  // locate the parameter: layer by layer, weight then bias
  float *th = nullptr, *m = nullptr, *v = nullptr;
  int q = p;
  for (int l = 0; l < a.L; ++l) {
    const int nw = a.dims[l] * a.dims[l + 1], nb = a.dims[l + 1];
    if (q < nw) { th = a.w[l] + q; m = a.mw[l] + q; v = a.vw[l] + q; break; }
    q -= nw;
    if (q < nb) { th = a.b[l] + q; m = a.mb[l] + q; v = a.vb[l] + q; break; }
    q -= nb;
  }
  const float m_new = __fadd_rn(__fmul_rn(0.9f, *m), __fmul_rn(0.1f, g));
  const float v_new = __fadd_rn(__fmul_rn(0.999f, *v), __fmul_rn(__fmul_rn(0.001f, g), g));
  const float step = __fdiv_rn(__fmul_rn(lr, __fmul_rn(m_new, c1)),
                               __fadd_rn(sqrtf(__fmul_rn(v_new, c2)), 1e-8f));
  *th = __fsub_rn(*th, step);
  *m = m_new;
  *v = v_new;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int lbdrn_smem_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

// One training step: partials over n_cta CTAs, then the reduction + Adam.
// Returns cudaGetLastError() after the launches (0 on success).
int lbdrn_fused_step(const StepArgs* args, const float* x, const float* y, const float* mask,
                     float* scratch, int n_cta, int smem_bytes, float* loss, float lr,
                     float c1, float c2, void* stream) {
  static int smem_set[2] = {0, 0};  // opted-in size per instantiation
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int staged = args->stage_w ? 1 : 0;
  const void* fn = staged ? (const void*)step_partials<true> : (const void*)step_partials<false>;
  if (smem_bytes > smem_set[staged]) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[staged] = smem_bytes;
  }
  int P = 0;
  for (int l = 0; l < args->L; ++l) P += args->dims[l] * args->dims[l + 1] + args->dims[l + 1];
  if (staged)
    step_partials<true><<<n_cta, THREADS, smem_bytes, s>>>(*args, x, y, mask, scratch);
  else
    step_partials<false><<<n_cta, THREADS, smem_bytes, s>>>(*args, x, y, mask, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_adam<<<(P + 255) / 256, 256, 0, s>>>(*args, scratch, n_cta, loss, lr, c1, c2);
  return (int)cudaGetLastError();
}

}  // extern "C"
