// Fused SIREN training steps on Hopper (sm_90a), CUDA C++: one network
// (K1), E independent networks in one launch pair (K2), and k sequential
// steps of one (K3) or E (K4) networks in one persistent launch.
//
// Replaces four Pallas TPU kernels of lbdrn_msic_tpu/ops/fused_step.py:
//   K1 fused_train_step  (body `_kernel`, with `_fwd_bwd`, `_adam`, `sincos`)
//   K2 fused_expert_step (body `_kernel_experts`: K1 per expert, grid (E, tiles))
//   K3 fused_multi_step  (body `_kernel_multi`: k K1 steps, grid (k,))
//   K4 fused_expert_multi_step (body `_kernel_expert_multi`: K3 per expert,
//      grid (E, k), one mask per step shared by the experts)
// One step of one network is:
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
// Experts (K2).  Both passes take the expert from blockIdx.y: grid
// (n_cta, E) for the partials, (ceil(P/256), E) for the reduction + Adam.
// Every per-expert array is an expert-major stack ((E, in, out) weights,
// (E, out) biases and their m, v; (E, B, F) x; (E, B, C) y; (E, n_cta, P+2)
// scratch; (E,) loss), so expert e is K1's computation at offset e times
// the array's per-expert size; the mask's per-expert stride is an argument
// (0 when one (B,) mask is shared).  The count, and so inv_scale, is per
// expert; lr, c1 and c2 are shared.  K1 is the E = 1 launch: its offsets
// are all 0, and expert e of K2 is bit-identical to K1 on expert e's slices
// (same code, same rows per CTA, same CTA-ordered sums).
//
// Multi-step (K3, K4).  The TPU kernels keep params and Adam state in VMEM
// over k grid steps to save a runtime's per-call overhead; here what k
// steps in one launch save is the host's per-step work (two launches, a
// batch gather and the schedule a step).  One cooperative launch of
// min(E * n_tiles, resident CTAs) persistent CTAs runs, for each step s:
//   1. the CTAs stride over the (expert, row tile) items; item (e, t) is
//      exactly K2's CTA (t, e): same rows, same code, same scratch row;
//   2. grid barrier;
//   3. the grid's threads stride over the E * P parameters: each sums its
//      partials in tile order, takes inv_scale from the tiles' counts and
//      applies Adam exactly as pass 2 does; parameter 0 writes loss[s, e];
//   4. grid barrier.
// So every step is bit-identical to K2's (and, per expert, K1's).  Data
// that the launch itself rewrites (params, m, v, the partials) is read with
// ld.global.cg after the barriers: from L2, never from a stale L1 line or
// the read-only path.  lr, c1, c2 of step s come from a (k, 3) table; the
// batch of step s lies at x + s * x_step (strides are arguments, so any
// step- or expert-major layout works).  The barrier is an arrival counter
// and a generation word in global memory (the pattern of cooperative_groups'
// grid sync, written out so that the -shared build needs no relocatable
// device code); the cooperative launch refuses a grid that is not wholly
// resident, and the grid is sized by the occupancy query, so it cannot
// deadlock.  At the bench widths one 184 KB CTA fits an SM: K3 (128 items)
// is one wave, K4 at E = 4 (512 items) loops ~3.9 items per CTA.
//
// Bound at the bench shape (B = 8192, 128->64->64->4): about 0.51 GFLOP
// (forward 205.5 M, dW 205.5 M, dH 71.3 M, sincos ~26 M) against about
// 4.7 MB of compulsory traffic (x is 4.2 MB).  In f32 on the CUDA cores
// (67 TFLOP/s on an SXM card) that is ~7.6 us a step: compute-bound.  This
// first version multiplies with FFMA from shared memory in 4x4 register
// tiles and makes no attempt at that bound; the partial-gradient scratch
// (128 x 50.7 KB = 6.5 MB written and read per step, resident in L2) is the
// first thing a faster version removes, then tensor-core (3xTF32) products.
// K2 does E times that work and traffic: at the sweep's E = 4, 512 CTAs
// (3.9 waves on 132 SMs) and a ~30 us bound.  K3/K4 do k times K1/K2's.
//
// Arithmetic outside the matrix products uses explicitly rounded
// operations (__fmul_rn / __fadd_rn: no FMA contraction), in the operation
// order of the plain PyTorch version, so only summation order differs.
//
// mm_dtype "bfloat16" (StepArgs.mm_bf16, every kernel above): a second
// instantiation of the first pass rounds each product operand to bf16 as
// mm4x4 reads it, where the JAX kernels cast both operands of each dot, and
// multiplies on FFMA.  The product of two bf16 values is exact in f32, so
// only the summation order differs from JAX's bf16 dot with f32
// accumulation.  Tensor-core bf16 products belong to the redesign.

#include "step_common.cuh"

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

// The first pass for one work item: expert e's row tile t (batch rows
// t*rows .. t*rows+rows-1).  Stages the tile, runs forward, masked SSE and
// backward, and writes the item's partial dW/db, SSE and mask count to
// scratch row e * n_tiles + t.  x, y, mask: expert e's batch.  kStageW:
// weights and biases staged in shared memory (a separate instantiation, so
// that its products read through shared-memory loads).  kBf16: every
// product operand rounded to bf16 as it is read (mm_dtype "bfloat16", where
// the JAX kernel casts both operands of each dot); the false instantiation
// is the f32 code unchanged.
template <bool kStageW, bool kCG, bool kBf16>
__device__ __forceinline__ void partials_item(const StepArgs& a, int e, int t, int n_tiles,
                                              const float* x, const float* y,
                                              const float* mask, float* scratch,
                                              float* smem) {
  const int L = a.L, R = a.rows, F = a.dims[0], C = a.dims[L];
  const int row0 = t * R;
  const int P = n_params(a);
  float* part = scratch + ((size_t)e * n_tiles + t) * (P + 2);

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

  stage_tile(a, row0, R, F, C, x, y, mask, xs, ys, ms);
  if (kStageW) stage_weights<kCG>(a, e, wsm);
  __syncthreads();

  // layout helpers: layer l's weight and bias (shared memory when staged,
  // else global), its input activation h_l (h_0 = xs) and the cos cache of
  // its output
  float* acts = kStageW ? wsm + P : wsm;  // h_1..h_{L-1}, then cos_0..cos_{L-2}
  auto wl = [&](int l) -> const float* {
    if constexpr (!kStageW) return a.w[l] + w_off(a, l, e);
    float* p = wsm;
    for (int q = 0; q < l; ++q) p += a.dims[q] * a.dims[q + 1] + a.dims[q + 1];
    return p;
  };
  auto bl = [&](int l) -> const float* {
    if constexpr (kStageW) return wl(l) + a.dims[l] * a.dims[l + 1];
    return a.b[l] + b_off(a, l, e);
  };
  // a read of a weight or bias: shared memory when staged, else global
  auto rw = [&](const float* p) -> float {
    if constexpr (kStageW) return *p;
    else return ld<kCG>(p);
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
    mm4x4<kBf16>(R, dout, din,
          [&](int i, int k) { return hin[i * din + k]; },
          [&](int k, int j) { return rw(W + k * dout + j); },
          [&](int i, int j, float acc) {
            const float u = __fmul_rn(w0, __fadd_rn(acc, rw(bias + j)));
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
    mm4x4<kBf16>(R, C, din,
          [&](int i, int k) { return hin[i * din + k]; },
          [&](int k, int j) { return rw(W + k * C + j); },
          [&](int i, int j, float acc) {
            const float z = __fadd_rn(acc, rw(bias + j));
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
    mm4x4<kBf16>(din, dout, R,
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
      mm4x4<kBf16>(R, din, dout,
            [&](int i, int k) { return gc[i * dout + k]; },
            [&](int k, int j) { return rw(W + j * dout + k); },
            [&](int i, int j, float acc) { gw[i * din + j] = __fmul_rn(acc, co[i * din + j]); });
    }
    __syncthreads();
    float* t = g; g = gn; gn = t;
  }
}

// The second pass for one parameter p of expert e: sum its partials over
// the n_tiles items in tile order, scale by inv_scale (from the items' mask
// counts, summed likewise) and apply Adam to it, its m and its v in place;
// p == 0 also writes the expert's loss.  scratch: expert e's (n_tiles, P+2)
// partials.
template <bool kCG>
__device__ __forceinline__ void adam_param(const StepArgs& a, int e, int p,
                                           const float* scratch, int n_tiles, float* loss,
                                           float lr, float c1, float c2) {
  const int P = n_params(a);
  const int S = P + 2;
  const int C = a.dims[a.L];
  const float cnt = col_sum<kCG>(scratch, n_tiles, S, P + 1);
  const float inv_scale = __fdiv_rn(1.0f, __fmul_rn(fmaxf(cnt, 1.0f), (float)C));
  if (p == 0) *loss = __fmul_rn(col_sum<kCG>(scratch, n_tiles, S, P), inv_scale);
  adam_update<kCG>(a, e, p, __fmul_rn(col_sum<kCG>(scratch, n_tiles, S, p), inv_scale), lr, c1,
                   c2);
}

// K1/K2 pass 1: CTA (blockIdx.x, blockIdx.y) is item (expert y, tile x).
template <bool kStageW, bool kBf16>
__global__ void __launch_bounds__(THREADS) step_partials(StepArgs a, const float* x,
                                                          const float* y, const float* mask,
                                                          int mask_stride, float* scratch) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int F = a.dims[0], C = a.dims[a.L];
  partials_item<kStageW, false, kBf16>(a, e, blockIdx.x, gridDim.x,
                                       x + (size_t)e * a.B * F, y + (size_t)e * a.B * C,
                                       mask + (size_t)e * mask_stride, scratch, smem);
}

// K1/K2 pass 2: one thread per (parameter, expert y).
__global__ void step_adam(StepArgs a, const float* scratch, int n_cta, float* loss,
                          float lr, float c1, float c2) {
  const int P = n_params(a);
  const int e = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  adam_param<false>(a, e, p, scratch + (size_t)e * n_cta * (P + 2), n_cta, loss + e, lr, c1,
                    c2);
}

// Grid-wide barrier over n_blocks co-resident CTAs: bar[0] counts
// arrivals, bar[1] is the generation the last arrival advances.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == n_blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// K3/K4: k steps of E experts in one cooperative launch (see the header).
// Strides in elements: *_es between two experts' batches, *_ss between two
// steps' (mask_es = 0: one mask per step shared by the experts).  sched:
// (k, 3) lr, c1, c2; loss: (k, E).
template <bool kStageW, bool kBf16>
__global__ void __launch_bounds__(THREADS)
    multi_step(StepArgs a, int E, int k, const float* x, long long x_es, long long x_ss,
               const float* y, long long y_es, long long y_ss, const float* mask,
               long long mask_es, long long mask_ss, float* scratch, int n_tiles,
               const float* sched, float* loss, unsigned int* bar) {
  extern __shared__ float smem[];
  const int P = n_params(a);
  const int items = E * n_tiles;
  const int n_threads = gridDim.x * blockDim.x;
  for (int s = 0; s < k; ++s) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = it / n_tiles;
      partials_item<kStageW, true, kBf16>(a, e, it - e * n_tiles, n_tiles,
                                          x + s * x_ss + e * x_es, y + s * y_ss + e * y_es,
                                          mask + s * mask_ss + e * mask_es, scratch, smem);
    }
    grid_sync(bar, gridDim.x);
    const float lr = sched[3 * s], c1 = sched[3 * s + 1], c2 = sched[3 * s + 2];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < E * P; i += n_threads) {
      const int e = i / P;
      adam_param<true>(a, e, i - e * P, scratch + (size_t)e * n_tiles * (P + 2), n_tiles,
                       loss + (size_t)s * E + e, lr, c1, c2);
    }
    if (s + 1 < k) grid_sync(bar, gridDim.x);
  }
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

// One training step of E experts (E = 1: K1): partials over (n_cta, E)
// CTAs, then the reduction + Adam.  `mask_stride`: elements between two
// experts' masks (0: one shared (B,) mask).  Returns cudaGetLastError()
// after the launches (0 on success).
int lbdrn_fused_step(const StepArgs* args, int E, const float* x, const float* y,
                     const float* mask, int mask_stride, float* scratch, int n_cta,
                     int smem_bytes, float* loss, float lr, float c1, float c2,
                     void* stream) {
  using Partials = void (*)(StepArgs, const float*, const float*, const float*, int, float*);
  // instantiation 2 * stage_w + mm_bf16, and its opted-in shared memory
  static const Partials fns[4] = {step_partials<false, false>, step_partials<false, true>,
                                  step_partials<true, false>, step_partials<true, true>};
  static int smem_set[4] = {0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inst = (args->stage_w ? 2 : 0) + (args->mm_bf16 ? 1 : 0);
  const Partials fn = fns[inst];
  if (smem_bytes > smem_set[inst]) {
    cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[inst] = smem_bytes;
  }
  int P = 0;
  for (int l = 0; l < args->L; ++l) P += args->dims[l] * args->dims[l + 1] + args->dims[l + 1];
  const dim3 grid1(n_cta, E), grid2((P + 255) / 256, E);
  fn<<<grid1, THREADS, smem_bytes, s>>>(*args, x, y, mask, mask_stride, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_adam<<<grid2, 256, 0, s>>>(*args, scratch, n_cta, loss, lr, c1, c2);
  return (int)cudaGetLastError();
}

// k training steps of E experts (E = 1: K3) in one cooperative launch of
// min(E * n_tiles, CTAs resident at once) CTAs.  Strides as `multi_step`
// takes them; sched: (k, 3) device table of lr, c1, c2; loss: (k, E)
// step-major; bar: two zeroed uint32 words.  *grid receives the CTA count.
// Returns 0 on success, else a CUDA error code (the cooperative launch's
// own when the grid cannot be resident).
int lbdrn_fused_multi_step(const StepArgs* args, int E, int k, const float* x,
                           long long x_es, long long x_ss, const float* y, long long y_es,
                           long long y_ss, const float* mask, long long mask_es,
                           long long mask_ss, float* scratch, int n_tiles, int smem_bytes,
                           const float* sched, float* loss, unsigned int* bar, void* stream,
                           int* grid) {
  // instantiation 2 * stage_w + mm_bf16, and its opted-in shared memory
  static const void* fns[4] = {(const void*)multi_step<false, false>,
                               (const void*)multi_step<false, true>,
                               (const void*)multi_step<true, false>,
                               (const void*)multi_step<true, true>};
  static int smem_set[4] = {0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inst = (args->stage_w ? 2 : 0) + (args->mm_bf16 ? 1 : 0);
  const void* fn = fns[inst];
  cudaError_t e;
  if (smem_bytes > smem_set[inst]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[inst] = smem_bytes;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int items = E * n_tiles;
  int n_blocks = per_sm * sms;
  if (items < n_blocks) n_blocks = items;
  *grid = n_blocks;
  StepArgs a = *args;
  void* kargs[] = {&a,    &E,       &k,       &x,       &x_es,    &x_ss,
                   &y,    &y_es,    &y_ss,    &mask,    &mask_es, &mask_ss,
                   &scratch, &n_tiles, &sched, &loss,   &bar};
  e = cudaLaunchCooperativeKernel(fn, dim3(n_blocks), dim3(THREADS), kargs, smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
