// Step-anatomy probes of the fused SIREN training step on Hopper (sm_90a),
// CUDA C++ (K5).
//
// Replaces the Pallas TPU kernel of scripts/profiling/kernel_prof.py
// (`run_steps`, body `make_kernel`): variants of one fused forward/backward
// /Adam step, each run as a 512-step loop on one fixed batch (B = 8192,
// 128 -> 64 -> 64 -> 4, f32, lr 1e-3, Adam with c1 = c2 = 1 every step), to
// see what each part of the step costs.  This source scales loss and
// gradients by inv = 1/(B*C) whatever the mask, as the JAX probe does;
// prod_* below take K1's 1/(max(sum mask, 1)*C), the same for the probe's
// mask of ones.  The variants of this source (the host maps
// the JAX names onto them, lbdrn_msic_tpu_torch/profiling/kernel_prof.py):
//   full_t       exact sinf forward, cosf backward, FFMA products; the
//                backward's transposed weights W^T staged in shared memory
//                (the TPU probe is the layout of the transposed operand)
//   full_dg      the same function reading W in place with swapped indices
//   tile2048     full_dg at a quarter of the rows per CTA (a launch
//                argument), as the JAX variant is at a quarter of the batch
//                per grid step: a per-CTA-overhead probe, same function
//   fast_full    full_t with the 2pi-period polynomial sin/cos
//   prec_default the TPU's one-pass reduced-precision product; here one-pass
//                TF32 on the tensor cores
//   prec_high    the TPU's three-pass product; here 3xTF32
//                (big*big + big*small + small*big, small terms first)
//   fwd_notrans  forward only: identity activations, linear head, the
//                unscaled masked SSE as the loss; params, m and v unchanged
// prod_f32 and prod_bf16 are K1 itself (csrc/fused_step.cu, mm_dtype None /
// "bfloat16", c1 = c2 = 1), as the JAX variants call the production
// `_fwd_bwd`.
//
// Tensor-core products use mma.sync m16n8k8 tf32 with f32 accumulation,
// the instruction that wmma's tf32 m16n16k8 fragments compile to; its
// fragment layouts are documented, so the operands load through the same
// element accessors as the FFMA routine and the ragged edges of this
// network (the head's N = 4, the head's dH depth K = 4) are masked in
// registers instead of staged into padded copies.  Each operand is rounded
// with cvt.rna.tf32.f32.  wgmma and TMA belong to the redesign.
//
// Design: K1's (csrc/fused_step.cu), templated on activation, product and
// forward-only.  Pass 1: one CTA per `rows` batch rows stages its tile and
// every weight in shared memory, runs the variant's forward/backward and
// writes partial dW/db and SSE to its own scratch row.  Pass 2: one thread
// per parameter sums the partials in CTA order, scales by inv and applies
// Adam with the given c1, c2; thread 0 writes the loss.  No float atomics:
// deterministic run to run, as K1.  Arithmetic outside the products uses
// explicitly rounded operations in the plain version's order.
//
// Bound at B = 8192: the products are 482 MFLOP (forward, dW, dH) against
// ~4.7 MB of compulsory traffic.  FFMA variants ~7.6 us (67 TFLOP/s f32);
// TF32 at 495 TFLOP/s needs ~1 us, 3xTF32 ~3 us, so both are bound by the
// bytes (~1.4 us at 3.35 TB/s) or by their CUDA-core work; fwd_notrans does
// the forward's 206 MFLOP only.

#include "step_common.cuh"

namespace {

enum Act { kExact = 0, kPoly = 1, kIdentity = 2 };
enum Prod { kF32 = 0, kTF32 = 1, k3xTF32 = 2 };

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kP0 = 6.283183466e+00f, kP1 = -4.134148036e+01f, kP2 = 8.159765788e+01f,
                kP3 = -7.659492822e+01f, kP4 = 4.126992957e+01f, kP5 = -1.237249482e+01f;

// The 2pi-period polynomial sin of kernel_prof.py (`_fast_sin`): t = x/2pi
// reduced to [-1/2, 1/2] (rintf: half to even, as jnp.round), odd degree-11
// polynomial in t.
__device__ __forceinline__ float fast_sin(float x) {
  float t = __fmul_rn(x, kInv2Pi);
  t = __fsub_rn(t, rintf(t));
  const float t2 = __fmul_rn(t, t);
  float p = kP5;
  p = __fadd_rn(__fmul_rn(p, t2), kP4);
  p = __fadd_rn(__fmul_rn(p, t2), kP3);
  p = __fadd_rn(__fmul_rn(p, t2), kP2);
  p = __fadd_rn(__fmul_rn(p, t2), kP1);
  p = __fadd_rn(__fmul_rn(p, t2), kP0);
  return __fmul_rn(t, p);
}

// (sin u, cos u) of the variant's activation
template <int kAct>
__device__ __forceinline__ void act(float u, float* s, float* c) {
  if constexpr (kAct == kPoly) {
    *s = fast_sin(u);
    *c = fast_sin(__fadd_rn(u, kHalfPi));
  } else {
    *s = sinf(u);
    *c = cosf(u);
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16x8, row) * b (8x8, col) on the tensor cores, tf32 in, f32 out
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out(i, j) = sum_k a(i, k) * b(k, j) on the tensor cores: each warp takes
// 16 x 8 output tiles in turn and walks k in steps of 8.  Fragment layouts
// of m16n8k8 (lane = 4 * group + t): a0 (group, t), a1 (group + 8, t),
// a2 (group, t + 4), a3 (group + 8, t + 4); b0 (t, group), b1 (t + 4,
// group); d0, d1 (group, 2t, 2t + 1), d2, d3 (group + 8, ...).  Elements
// past M, N or K read as 0.  k3x: 3xTF32, the residual a - tf32(a) carried
// in a second tf32 term.
template <bool k3x, class AF, class BF, class EP>
__device__ __forceinline__ void mm_tc(int M, int N, int K, AF a, BF b, EP ep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int tm = (M + 15) >> 4, tn = (N + 7) >> 3;
  for (int t = warp; t < tm * tn; t += n_warps) {
    const int r0 = ((t / tn) << 4) + grp, r1 = r0 + 8, n = ((t % tn) << 3) + grp;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int c0 = k0 + tq, c1 = c0 + 4;
      const float av[4] = {(r0 < M && c0 < K) ? a(r0, c0) : 0.0f,
                           (r1 < M && c0 < K) ? a(r1, c0) : 0.0f,
                           (r0 < M && c1 < K) ? a(r0, c1) : 0.0f,
                           (r1 < M && c1 < K) ? a(r1, c1) : 0.0f};
      const float bv[2] = {(c0 < K && n < N) ? b(c0, n) : 0.0f,
                           (c1 < K && n < N) ? b(c1, n) : 0.0f};
      uint32_t ab[4], bb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ab[i] = tf32(av[i]);
#pragma unroll
      for (int i = 0; i < 2; ++i) bb[i] = tf32(bv[i]);
      if constexpr (k3x) {
        uint32_t as[4], bs[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) as[i] = tf32(__fsub_rn(av[i], __uint_as_float(ab[i])));
#pragma unroll
        for (int i = 0; i < 2; ++i) bs[i] = tf32(__fsub_rn(bv[i], __uint_as_float(bb[i])));
        mma_tf32(d, as, bb);
        mma_tf32(d, ab, bs);
      }
      mma_tf32(d, ab, bb);
    }
    const int j0 = ((t % tn) << 3) + 2 * tq;
    if (r0 < M && j0 < N) ep(r0, j0, d[0]);
    if (r0 < M && j0 + 1 < N) ep(r0, j0 + 1, d[1]);
    if (r1 < M && j0 < N) ep(r1, j0, d[2]);
    if (r1 < M && j0 + 1 < N) ep(r1, j0 + 1, d[3]);
  }
}

// the variant's product routine
template <int kProd, class AF, class BF, class EP>
__device__ __forceinline__ void mm(int M, int N, int K, AF a, BF b, EP ep) {
  if constexpr (kProd == kF32) mm4x4(M, N, K, a, b, ep);
  else mm_tc<kProd == k3xTF32>(M, N, K, a, b, ep);
}

// Pass 1: CTA t runs batch rows t*rows .. t*rows+rows-1 and writes its
// partial dW/db (layer by layer, weight then bias), its SSE and its mask
// count to scratch row t.  Shared memory (floats, the host sums the same):
// x tile, y tile, mask, reduction buffer, two gradient buffers of rows x
// max width, every weight and bias, [W^T of layers 1.. when kStageWT], the
// hidden activations, their w0*cos caches.
template <int kAct, int kProd, bool kFwdOnly, bool kStageWT>
__global__ void __launch_bounds__(THREADS) prof_partials(StepArgs a, const float* x,
                                                          const float* y, const float* mask,
                                                          float* scratch) {
  extern __shared__ float smem[];
  const int L = a.L, R = a.rows, F = a.dims[0], C = a.dims[L];
  const int row0 = blockIdx.x * R;
  const int P = n_params(a);
  float* part = scratch + (size_t)blockIdx.x * (P + 2);

  int gmax = 0, n_wt = 0;
  for (int l = 1; l <= L; ++l) gmax = max(gmax, a.dims[l]);
  for (int l = 1; l < L; ++l) n_wt += a.dims[l] * a.dims[l + 1];
  float* xs = smem;
  float* cur = xs + R * F;
  float* ys = cur;   cur += R * C;
  float* ms = cur;   cur += R;
  float* red = cur;  cur += THREADS;
  float* ga = cur;   cur += R * gmax;
  float* gb = cur;   cur += R * gmax;
  float* wsm = cur;  cur += P;
  float* wts = cur;  if (kStageWT) cur += n_wt;
  float* acts = cur;  // h_1..h_{L-1}, then cos_0..cos_{L-2}

  stage_tile(a, row0, R, F, C, x, y, mask, xs, ys, ms);
  stage_weights<false>(a, 0, wsm);
  if (kStageWT) {  // W^T (dout x din) of the layers the backward multiplies by
    float* q = wts;
    for (int l = 1; l < L; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1], n = din * dout;
      for (int i = threadIdx.x; i < n; i += blockDim.x) q[(i % dout) * din + i / dout] = a.w[l][i];
      q += n;
    }
  }
  __syncthreads();

  auto wl = [&](int l) -> const float* {
    const float* p = wsm;
    for (int q = 0; q < l; ++q) p += a.dims[q] * a.dims[q + 1] + a.dims[q + 1];
    return p;
  };
  auto wtl = [&](int l) -> const float* {  // W^T of layer l >= 1
    const float* p = wts;
    for (int q = 1; q < l; ++q) p += a.dims[q] * a.dims[q + 1];
    return p;
  };
  auto hl = [&](int l) -> float* {
    if (l == 0) return xs;
    float* p = acts;
    for (int q = 1; q < l; ++q) p += R * a.dims[q];
    return p;
  };
  auto cosl = [&](int l) -> float* {
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
    const float* bias = W + din * dout;
    float* hout = hl(l + 1);
    float* co = cosl(l);
    const float w0 = a.w0[l];
    mm<kProd>(R, dout, din,
              [&](int i, int k) { return hin[i * din + k]; },
              [&](int k, int j) { return W[k * dout + j]; },
              [&](int i, int j, float acc) {
                const float z = __fadd_rn(acc, bias[j]);
                if constexpr (kAct == kIdentity) {
                  hout[i * dout + j] = z;
                } else {
                  float s, c;
                  act<kAct>(__fmul_rn(w0, z), &s, &c);
                  hout[i * dout + j] = s;
                  co[i * dout + j] = __fmul_rn(w0, c);
                }
              });
    __syncthreads();
  }

  // ---- head, masked squared error, d(sum se)/dz_last
  {
    const int din = a.dims[L - 1];
    const float* hin = hl(L - 1);
    const float* W = wl(L - 1);
    const float* bias = W + din * C;
    mm<kProd>(R, C, din,
              [&](int i, int k) { return hin[i * din + k]; },
              [&](int k, int j) { return W[k * C + j]; },
              [&](int i, int j, float acc) {
                const float z = __fadd_rn(acc, bias[j]);
                if constexpr (kFwdOnly) {  // linear head
                  const float diff = __fmul_rn(__fsub_rn(z, ys[i * C + j]), ms[i]);
                  gb[i * C + j] = __fmul_rn(diff, diff);
                } else {
                  const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
                  const float diff = __fmul_rn(__fsub_rn(p, ys[i * C + j]), ms[i]);
                  gb[i * C + j] = __fmul_rn(diff, diff);
                  ga[i * C + j] = __fmul_rn(__fmul_rn(2.0f, diff),
                                            __fmul_rn(p, __fsub_rn(1.0f, p)));
                }
              });
    __syncthreads();
    const float sse = block_sum(gb, R * C, red);
    const float cnt = block_sum(ms, R, red);
    if (threadIdx.x == 0) {
      part[P] = sse;
      part[P + 1] = cnt;
    }
  }
  if constexpr (kFwdOnly) return;

  // ---- backward: partial dW, db of every layer; dH down to layer 1
  float* g = ga;
  float* gn = gb;
  int off = P;
  for (int l = L - 1; l >= 0; --l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    const float* hin = hl(l);
    off -= din * dout + dout;
    float* dW = part + off;
    float* db = dW + din * dout;
    const float* gc = g;
    mm<kProd>(din, dout, R,
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
      const float* W = wl(l);
      const float* WT = kStageWT ? wtl(l) : nullptr;
      mm<kProd>(R, din, dout,
                [&](int i, int k) { return gc[i * dout + k]; },
                [&](int k, int j) { return kStageWT ? WT[k * din + j] : W[j * dout + k]; },
                [&](int i, int j, float acc) {
                  gw[i * din + j] = __fmul_rn(acc, co[i * din + j]);
                });
    }
    __syncthreads();
    float* t = g; g = gn; gn = t;
  }
}

// Pass 2: one thread per parameter sums its partials in CTA order, scales
// by inv and applies Adam (c1, c2 given) in place; thread 0 writes the loss
// (SSE * inv; the unscaled SSE and no update for the forward-only variant).
__global__ void prof_adam(StepArgs a, const float* scratch, int n_cta, float* loss, float lr,
                          float c1, float c2, float inv, int fwd_only) {
  const int P = n_params(a);
  const int S = P + 2;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  if (p == 0) {
    const float sse = col_sum<false>(scratch, n_cta, S, P);
    *loss = fwd_only ? sse : __fmul_rn(sse, inv);
  }
  if (fwd_only) return;
  adam_update<false>(a, 0, p, __fmul_rn(col_sum<false>(scratch, n_cta, S, p), inv), lr, c1, c2);
}

using Partials = void (*)(StepArgs, const float*, const float*, const float*, float*);

// the instantiation of each kernel id (lbdrn_kprof_step's `kernel`)
constexpr int kKernels = 6;
const Partials kPartials[kKernels] = {
    prof_partials<kExact, kF32, false, true>,     // 0 full_t
    prof_partials<kExact, kF32, false, false>,    // 1 full_dg, tile2048
    prof_partials<kPoly, kF32, false, true>,      // 2 fast_full
    prof_partials<kExact, kTF32, false, true>,    // 3 prec_default
    prof_partials<kExact, k3xTF32, false, true>,  // 4 prec_high
    prof_partials<kIdentity, kF32, true, false>,  // 5 fwd_notrans
};

}  // namespace

extern "C" {

// One step of probe `kernel` (see kPartials): partials over n_cta CTAs of
// args->rows rows, then the reduction + Adam.  scratch: (n_cta, P + 2).
// Returns cudaGetLastError() after the launches (0 on success).
int lbdrn_kprof_step(const StepArgs* args, int kernel, const float* x, const float* y,
                     const float* mask, float* scratch, int n_cta, int smem_bytes, float* loss,
                     float lr, float c1, float c2, float inv, void* stream) {
  static int smem_set[kKernels] = {0};  // opted-in size per instantiation
  if (kernel < 0 || kernel >= kKernels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Partials fn = kPartials[kernel];
  if (smem_bytes > smem_set[kernel]) {
    cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[kernel] = smem_bytes;
  }
  fn<<<n_cta, THREADS, smem_bytes, s>>>(*args, x, y, mask, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int P = 0;
  for (int l = 0; l < args->L; ++l) P += args->dims[l] * args->dims[l + 1] + args->dims[l + 1];
  const int fwd_only = kernel == 5;
  prof_adam<<<fwd_only ? 1 : (P + 255) / 256, 256, 0, s>>>(*args, scratch, n_cta, loss, lr, c1,
                                                          c2, inv, fwd_only);
  return (int)cudaGetLastError();
}

}  // extern "C"
