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
// Two passes.  The TPU walks the batch tiles in order and carries the
// gradient sums in VMEM; here CTAs run in parallel, so a step is two
// launches:
//   pass 1  `step_partials`: one CTA per `rows` batch rows (64 at the bench
//           shape: 128 CTAs for B = 8192, one wave on 132 SMs, one 205 KB
//           CTA of 8 warps per SM).  It writes its partial dW/db, SSE and
//           mask count to a scratch row of its own (no float atomics).
//   pass 2  `step_adam`: one CTA per 30 parameters (423 at the bench
//           widths) sums the partial rows in a fixed two-level order and
//           applies Adam to params, m and v in place.
// Bound at the bench shape (B = 8192, 128->64->64->4): about 0.51 GFLOP
// (forward 205.5 M, dW 205.5 M, dH 71.3 M, sincos ~26 M) against about 4.7
// MB of compulsory traffic: ~7.6 us a step on the CUDA cores (67 TFLOP/s),
// compute-bound.  The first design took ~98 us, and its probes (K5)
// showed the time was not in the products but in fixed work per CTA:
// staging through dependent scalar loads before the first product, a
// 16-way bank conflict in the dH product, scalar operand reads, a serial
// 128-row walk in pass 2, serial bias sums.  This design (~44 us on an
// H100 SXM, PERF.md) answers each in turn:
//
// 1. Asynchronous staging.  Thread 0 initialises one mbarrier per layer;
//    warp 0 issues TMA 1-D bulk copies (cp.async.bulk ... complete_tx) of
//    the x rows, of each layer's weights and bias, and of the y and mask
//    rows.  Barrier 0 covers x, W0 and b0, barrier l W_l and b_l, the last
//    one also y and mask, so layer 0's product starts as soon as x and W0
//    have landed while the later layers' weights are still in flight.
//    Rows past B are zero-filled in shared memory, not copied; an array
//    whose address or size is not a 16-byte multiple (an odd head width, a
//    ragged tile's y and mask) goes by 4-byte cp.async instead.  Each CTA
//    copies the weights for itself: clusters of 2 and 4 CTAs sharing one
//    multicast copy measured slower (PERF.md), so there are none.
// 2. Operands without conflicts.  Activations, gradients and the x tile lie
//    in shared memory at a row stride that is a multiple of 4 and not of 32
//    (`row_stride`), and every product (`mmv`, step_async.cuh) reads 16-byte
//    float4s: along k for a row-major left operand, whose 4 rows a thread
//    owns are strided so that the rows one warp instruction reads sit on
//    different banks; along i for a transposed one (x^T, h^T in dW); along j
//    for the right operand, one row per instruction.  The dH product reads a
//    W^T of layers 1.. staged (transposed in 4x4 register blocks) after the
//    forward, not W in place.  Full tiles run an unrolled loop with no
//    bounds test.  The bias-gradient column sums spread over all 256
//    threads in a fixed tree (`col_sums`).  Widths whose weights do not fit
//    beside 8 rows read them from global memory (a second instantiation;
//    its dH product keeps mm4x4 on W in place).
// 3. The reduction.  Pass 2 sums each parameter's partial rows in groups
//    of TILE_GROUP tiles, each group in tile order, then the group sums in
//    order (`two_level_sum`): 8 warps read 8 groups at once, each lane one
//    column (30 parameters, the SSE and the mask count a CTA, so one round
//    serves the loss too), and the order is fixed by the tile count alone.
//    It is launched with programmatic dependent launch: pass 1 lets it
//    launch at once and it waits (griddepcontrol.wait) before reading the
//    partials, so its launch and start hide under pass 1.
// 4. Products: FFMA.  3xTF32 on mma.sync m16n8k8, fragments read from the
//    same layouts, measured 5-6 % slower at the bench shape (PERF.md).
// What bounds the step now: pass 1, ~38 of the ~44 us (chip_smoke.py's
// pass split), whose products take ~1.9 M FMA a CTA against ~8 us of FFMA
// issue at the card's rate; and, at K2's E = 4, pass 2's reads of the 26 MB
// of partials.

// Arithmetic outside the matrix products uses explicitly rounded
// operations (__fmul_rn / __fadd_rn: no FMA contraction), in the operation
// order of the plain PyTorch version, so only summation order differs.
//
// Experts (K2).  Both passes take the expert from blockIdx.y: grid
// (n_cta, E) for the partials, (ceil(P/30), E) for the reduction + Adam.
// Every per-expert array is an expert-major stack ((E, in, out) weights,
// (E, out) biases and their m, v; (E, B, F) x; (E, B, C) y; (E, n_cta, S)
// scratch; (E,) loss), so expert e is K1's computation at offset e times
// the array's per-expert size; the mask's per-expert stride is an argument
// (0 when one (B,) mask is shared).  The count, and so inv_scale, is per
// expert; lr, c1 and c2 are shared.  K1 is the E = 1 launch, and expert e
// of K2 is bit-identical to K1 on expert e's slices (same code, same rows
// per CTA, same sums).  K2 does E times K1's work: at the sweep's E = 4,
// 512 CTAs (3.9 waves) and a ~30 us bound.
//
// Multi-step (K3, K4).  One cooperative launch of min(E * n_tiles, resident
// CTAs) persistent CTAs runs, for each step s: the CTAs stride over the
// (expert, row tile) items, item (e, t) exactly K2's CTA (t, e); grid
// barrier; the grid's warps stride over K2's pass-2 chunks, one chunk a
// warp (`adam_chunk_warp`: the same sums in the same order as pass 2's
// CTA-wide `adam_chunk`, without its CTA barriers); grid barrier.  So every
// step is bit-identical to K2's (and, per expert, K1's).  The mbarriers are
// initialised once and their phase parity flips with each item a CTA runs;
// each item starts with a proxy fence (the Adam phase wrote the params with
// generic stores that the next bulk copies read) and a CTA barrier.  Data
// that the launch rewrites is read through L2
// (bulk copies, ld.global.cg).  lr, c1, c2 of step s come from a (k, 3)
// table; the batch of step s lies at x + s * x_step.  The grid barrier is an
// arrival counter and a generation word in global memory; the cooperative
// launch refuses a grid that is not wholly resident, and the grid is sized
// by the occupancy query, so it cannot deadlock.
//
// mm_dtype "bfloat16" (StepArgs.mm_bf16, every kernel above): a second
// instantiation rounds each product operand to bf16 as it is read, where
// the JAX kernels cast both operands of each dot, and multiplies on FFMA.
// The product of two bf16 values is exact in f32, so only the summation
// order differs from JAX's bf16 dot with f32 accumulation.

#include "step_async.cuh"

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

// A product with the thread-tile height that keeps the threads busy: 4 x 4
// tiles where there are at least 128 of them, else 1 x 4.
template <bool kBf16, bool kATrans, int kBSrc, class EP>
__device__ __forceinline__ void mm(int M, int N, int K, const float* A, int lda, const float* B,
                                   int ldb, EP ep) {
  if (((M + 3) >> 2) * ((N + 3) >> 2) >= THREADS / 2)
    mmv<kBf16, kATrans, 4, kBSrc>(M, N, K, A, lda, B, ldb, ep);
  else
    mmv<kBf16, kATrans, 1, kBSrc>(M, N, K, A, lda, B, ldb, ep);
}

// The first pass for one work item: expert e's row tile t (batch rows
// t*rows .. t*rows+rows-1).  Stages the tile asynchronously, runs forward,
// masked SSE and backward, and writes the item's partial dW/db, SSE and
// mask count to scratch row e * n_tiles + t (row stride S).  x, y, mask:
// expert e's batch.  bars: a.L initialised mbarriers at the start of smem;
// parity: the phase this item completes on them.  kStageW: weights,
// biases and W^T staged in shared memory (else read from global memory).
// kCG: global data that this launch rewrites is read through L2 only.
// kBf16: product operands rounded to bf16.
template <bool kStageW, bool kCG, bool kBf16>
__device__ __forceinline__ void partials_item(const StepArgs& a, int e, int t, int n_tiles,
                                              int S, const float* x, const float* y,
                                              const float* mask, float* scratch, float* smem,
                                              uint32_t parity) {
  const int L = a.L, R = a.rows, F = a.dims[0], C = a.dims[L];
  const int row0 = t * R;
  const int nrows = max(0, min(R, a.B - row0));
  const int P = n_params(a);
  constexpr int kBSrc = kStageW ? 0 : (kCG ? 2 : 1);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);

  // shared-memory carve-up (floats; ops/fused_step.py::smem_bytes sums the same)
  int ldg = 0;
  for (int l = 1; l <= L; ++l) ldg = max(ldg, row_stride(a.dims[l]));
  const int ldx = row_stride(F);
  float* xs = smem + round4(2 * L);
  float* ys = xs + R * ldx;
  float* ms = ys + round4(R * C);
  float* red = ms + round4(R);
  float* ga = red + THREADS;
  float* gb = ga + R * ldg;
  float* wsm = gb + R * ldg;  // [weights, biases,] [W^T of layers 1..,] activations
  float* wts = wsm;
  if (kStageW)
    for (int l = 0; l < L; ++l) wts += round4(a.dims[l] * a.dims[l + 1]) + round4(a.dims[l + 1]);
  float* acts = wts;
  if (kStageW)
    for (int l = 1; l < L; ++l) acts += a.dims[l + 1] * row_stride(a.dims[l]);

  auto wl = [&](int l) -> float* {  // layer l's staged weight, then its bias
    float* p = wsm;
    for (int q = 0; q < l; ++q) p += round4(a.dims[q] * a.dims[q + 1]) + round4(a.dims[q + 1]);
    return p;
  };
  auto wg = [&](int l) -> const float* { return a.w[l] + w_off(a, l, e); };
  auto bg = [&](int l) -> const float* { return a.b[l] + b_off(a, l, e); };
  auto wtl = [&](int l) -> float* {  // W^T of layer l >= 1: dout rows of row_stride(din)
    float* p = wts;
    for (int q = 1; q < l; ++q) p += a.dims[q + 1] * row_stride(a.dims[q]);
    return p;
  };
  auto hl = [&](int l) -> float* {  // input of layer l (row stride row_stride(dims[l]))
    if (l == 0) return xs;
    float* p = acts;
    for (int q = 1; q < l; ++q) p += R * row_stride(a.dims[q]);
    return p;
  };
  auto cosl = [&](int l) -> float* {  // w0 * cos of layer l's output, l < L-1
    float* p = acts;
    for (int q = 1; q < L; ++q) p += R * row_stride(a.dims[q]);
    for (int q = 0; q < l; ++q) p += R * row_stride(a.dims[q + 1]);
    return p;
  };

  // ---- staging: the previous item's generic accesses of shared memory
  // (and, in K3/K4, the Adam phase's stores to the params) come before
  // this item's bulk copies
  fence_proxy_async();
  __syncthreads();
  const float* xsrc = x + (size_t)row0 * F;
  const float* ysrc = y + (size_t)row0 * C;
  const float* msrc = mask + row0;
  const bool x_bulk = nrows > 0 && bulk_ok(xs, xsrc, (size_t)F * 4);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int l = 0; l < L; ++l) {
        uint32_t tx = 0;
        if (l == 0 && x_bulk) tx += (uint32_t)nrows * F * 4;
        if (kStageW) {
          const int din = a.dims[l], dout = a.dims[l + 1];
          tx += bulk_bytes(wl(l), wg(l), din * dout) +
                bulk_bytes(wl(l) + round4(din * dout), bg(l), dout);
        }
        if (l == L - 1) tx += bulk_bytes(ys, ysrc, nrows * C) + bulk_bytes(ms, msrc, nrows);
        mbar_arrive_tx(&bars[l], tx);
      }
      if (kStageW)
        for (int l = 0; l < L; ++l) {
          const int din = a.dims[l], dout = a.dims[l + 1];
          float* wd = wl(l);
          float* bd = wd + round4(din * dout);
          const uint32_t nw = bulk_bytes(wd, wg(l), din * dout), nb = bulk_bytes(bd, bg(l), dout);
          if (nw) bulk_copy(wd, wg(l), nw, &bars[l]);
          if (nb) bulk_copy(bd, bg(l), nb, &bars[l]);
        }
      const uint32_t ny = bulk_bytes(ys, ysrc, nrows * C), nm = bulk_bytes(ms, msrc, nrows);
      if (ny) bulk_copy(ys, ysrc, ny, &bars[L - 1]);
      if (nm) bulk_copy(ms, msrc, nm, &bars[L - 1]);
    }
    __syncwarp();
    if (x_bulk)
      for (int r = threadIdx.x; r < nrows; r += 32)
        bulk_copy(xs + r * ldx, xsrc + (size_t)r * F, F * 4, &bars[0]);
  }
  // the cp.async route, and zeros for the rows past B
  if (!x_bulk)
    for (int i = threadIdx.x; i < nrows * F; i += blockDim.x) {
      const int r = i / F;
      cp_async4(xs + r * ldx + (i - r * F), xsrc + i);
    }
  for (int i = threadIdx.x; i < (R - nrows) * F; i += blockDim.x) {
    const int r = i / F;
    xs[(nrows + r) * ldx + (i - r * F)] = 0.0f;
  }
  copy_fallback(ys, ysrc, nrows * C);
  copy_fallback(ms, msrc, nrows);
  for (int i = nrows * C + threadIdx.x; i < R * C; i += blockDim.x) ys[i] = 0.0f;
  for (int i = nrows + threadIdx.x; i < R; i += blockDim.x) ms[i] = 0.0f;
  if (kStageW)
    for (int l = 0; l < L; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1];
      copy_fallback(wl(l), wg(l), din * dout);
      copy_fallback(wl(l) + round4(din * dout), bg(l), dout);
    }
  cp_async_wait_all();
  __syncthreads();
  float* part = scratch + ((size_t)e * n_tiles + t) * S;

  // ---- forward through the hidden layers
  for (int l = 0; l < L - 1; ++l) {
    mbar_wait(&bars[l], parity);
    const int din = a.dims[l], dout = a.dims[l + 1];
    const int ldi = row_stride(din), ldo = row_stride(dout);
    const float* W = kStageW ? wl(l) : wg(l);
    const float* bias = kStageW ? wl(l) + round4(din * dout) : bg(l);
    float* hout = hl(l + 1);
    float* co = cosl(l);
    const float w0 = a.w0[l];
    mm<kBf16, false, kBSrc>(R, dout, din, hl(l), ldi, W, dout, [&](int i, int j, float acc) {
      const float bj = kStageW ? bias[j] : ld<kCG>(bias + j);
      const float u = __fmul_rn(w0, __fadd_rn(acc, bj));
      float s, c;
      sincos_poly(u, &s, &c);
      hout[i * ldo + j] = s;
      co[i * ldo + j] = __fmul_rn(w0, c);
    });
    __syncthreads();
  }

  // ---- sigmoid head, masked squared error, d(sum se)/dz_last
  {
    mbar_wait(&bars[L - 1], parity);
    const int din = a.dims[L - 1], ldc = row_stride(C);
    const float* W = kStageW ? wl(L - 1) : wg(L - 1);
    const float* bias = kStageW ? wl(L - 1) + round4(din * C) : bg(L - 1);
    mm<kBf16, false, kBSrc>(R, C, din, hl(L - 1), row_stride(din), W, C,
                            [&](int i, int j, float acc) {
      const float bj = kStageW ? bias[j] : ld<kCG>(bias + j);
      const float z = __fadd_rn(acc, bj);
      const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      const float diff = __fmul_rn(__fsub_rn(p, ys[i * C + j]), ms[i]);
      gb[i * C + j] = __fmul_rn(diff, diff);
      ga[i * ldc + j] = __fmul_rn(__fmul_rn(2.0f, diff), __fmul_rn(p, __fsub_rn(1.0f, p)));
    });
    // W^T of layers 1.. for the dH products, in 4 x 4 register blocks
    if (kStageW)
      for (int l = 1; l < L; ++l) {
        const int din = a.dims[l], dout = a.dims[l + 1], ldt = row_stride(din);
        const float* W = wl(l);
        float* WT = wtl(l);
        if (((din | dout) & 3) == 0) {
          const int nk = dout >> 2;
          for (int b = threadIdx.x; b < (din >> 2) * nk; b += blockDim.x) {
            const int jb = b / nk, kb = b - jb * nk;
            float4 r[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              r[rr] = *reinterpret_cast<const float4*>(W + (4 * jb + rr) * dout + 4 * kb);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              *reinterpret_cast<float4*>(WT + (4 * kb + c) * ldt + 4 * jb) =
                  make_float4(comp(r[0], c), comp(r[1], c), comp(r[2], c), comp(r[3], c));
          }
        } else {
          for (int i = threadIdx.x; i < din * dout; i += blockDim.x) {
            const int j = i / dout;
            WT[(i - j * dout) * ldt + j] = W[i];
          }
        }
      }
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
    const int ldi = row_stride(din), ldgl = row_stride(dout);
    off -= din * dout + dout;
    float* dW = part + off;
    float* db = dW + din * dout;
    const float* gc = g;
    mm<kBf16, true, 0>(din, dout, R, hl(l), ldi, gc, ldgl,
                       [&](int i, int j, float acc) { dW[i * dout + j] = acc; });
    col_sums(gc, R, dout, ldgl, db);
    if (l > 0) {
      const float* co = cosl(l - 1);
      float* gw = gn;
      auto ep = [&](int i, int j, float acc) { gw[i * ldi + j] = __fmul_rn(acc, co[i * ldi + j]); };
      if constexpr (kStageW) {
        mm<kBf16, false, 0>(R, din, dout, gc, ldgl, wtl(l), ldi, ep);
      } else {
        const float* W = wg(l);
        mm4x4<kBf16>(R, din, dout, [&](int i, int k) { return gc[i * ldgl + k]; },
                     [&](int k, int j) { return ld<kCG>(W + j * dout + k); }, ep);
      }
    }
    __syncthreads();
    float* tmp = g; g = gn; gn = tmp;
  }
}

// initialise the item barriers (one per layer) at the start of smem
__device__ __forceinline__ void init_bars(const StepArgs& a, float* smem) {
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
    for (int l = 0; l < a.L; ++l) mbar_init(&bars[l], 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// K1/K2 pass 1: CTA (blockIdx.x, blockIdx.y) is item (expert y, tile x).
template <bool kStageW, bool kBf16>
__global__ void __launch_bounds__(THREADS) step_partials(StepArgs a, const float* x,
                                                          const float* y, const float* mask,
                                                          int mask_stride, float* scratch,
                                                          int n_tiles, int S) {
  extern __shared__ __align__(16) float smem[];
  pdl_launch_dependents();  // pass 2 may launch now; it waits for this grid's end
  init_bars(a, smem);
  const int e = blockIdx.y;
  const int F = a.dims[0], C = a.dims[a.L];
  partials_item<kStageW, false, kBf16>(a, e, blockIdx.x, n_tiles, S, x + (size_t)e * a.B * F,
                                       y + (size_t)e * a.B * C, mask + (size_t)e * mask_stride,
                                       scratch, smem, 0);
}

// K1/K2 pass 2: CTA (x, y) is chunk x of expert y.
__global__ void __launch_bounds__(THREADS) step_adam(StepArgs a, const float* scratch,
                                                     int n_tiles, int S, float* loss, float lr,
                                                     float c1, float c2) {
  __shared__ float red[THREADS];
  pdl_wait();
  const int e = blockIdx.y;
  adam_chunk<false>(a, e, blockIdx.x, scratch + (size_t)e * n_tiles * S, n_tiles, S, loss + e,
                    lr, c1, c2, red);
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
               long long mask_es, long long mask_ss, float* scratch, int n_tiles, int S,
               const float* sched, float* loss, unsigned int* bar) {
  extern __shared__ __align__(16) float smem[];
  init_bars(a, smem);
  const int P = n_params(a);
  const int items = E * n_tiles, n_chunks = (P + ADAM_COLS - 1) / ADAM_COLS;
  uint32_t done = 0;                    // items this CTA has run: the barriers' phase
  for (int s = 0; s < k; ++s) {
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++done) {
      const int e = it / n_tiles;
      partials_item<kStageW, true, kBf16>(a, e, it - e * n_tiles, n_tiles, S,
                                          x + s * x_ss + e * x_es, y + s * y_ss + e * y_es,
                                          mask + s * mask_ss + e * mask_es, scratch, smem,
                                          done & 1);
    }
    grid_sync(bar, gridDim.x);
    const float lr = sched[3 * s], c1 = sched[3 * s + 1], c2 = sched[3 * s + 2];
    const int n_warps = gridDim.x * (THREADS / 32);
    for (int c = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); c < E * n_chunks;
         c += n_warps) {
      const int e = c / n_chunks;
      adam_chunk_warp<true>(a, e, c - e * n_chunks, scratch + (size_t)e * n_tiles * S, n_tiles,
                            S, loss + (size_t)s * E + e, lr, c1, c2);
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

// One training step of E experts (E = 1: K1): partials over (n_tiles, E)
// CTAs, then the reduction + Adam over
// (ceil(P / 30), E) CTAs, launched as a programmatic dependent of the
// first.  `mask_stride`: elements between two experts' masks (0: one
// shared (B,) mask).  scratch: (E, n_tiles, S) floats.  Returns 0 on
// success, else the CUDA error code of the refused launch or attribute.
int lbdrn_fused_step(const StepArgs* args, int E, const float* x, const float* y,
                     const float* mask, int mask_stride, float* scratch, int n_tiles, int S,
                     int smem_bytes, float* loss, float lr, float c1, float c2, void* stream) {
  using Partials =
      void (*)(StepArgs, const float*, const float*, const float*, int, float*, int, int);
  // instantiation 2 * stage_w + mm_bf16, and its opted-in shared memory
  static const Partials fns[4] = {
      step_partials<false, false>, step_partials<false, true>, step_partials<true, false>,
      step_partials<true, true>};
  static int smem_set[4] = {0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inst = (args->stage_w ? 2 : 0) + (args->mm_bf16 ? 1 : 0);
  const Partials fn = fns[inst];
  cudaError_t e;
  if (smem_bytes > smem_set[inst]) {
    e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[inst] = smem_bytes;
  }
  int P = 0;
  for (int l = 0; l < args->L; ++l) P += args->dims[l] * args->dims[l + 1] + args->dims[l + 1];
  StepArgs a = *args;

  fn<<<dim3(n_tiles, E), THREADS, smem_bytes, s>>>(a, x, y, mask, mask_stride, scratch, n_tiles,
                                                   S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg2 = {};
  cfg2.gridDim = dim3((P + ADAM_COLS - 1) / ADAM_COLS, E);
  cfg2.blockDim = dim3(THREADS);
  cfg2.dynamicSmemBytes = 0;
  cfg2.stream = s;
  cfg2.attrs = pdl;
  cfg2.numAttrs = 1;
  const float* sc = scratch;
  e = cudaLaunchKernelEx(&cfg2, step_adam, a, sc, n_tiles, S, loss, lr, c1, c2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// k training steps of E experts (E = 1: K3) in one cooperative launch of
// min(E * n_tiles, CTAs resident at once) CTAs.  Strides as `multi_step`
// takes them; scratch: (E, n_tiles, S) floats; sched: (k, 3) device table
// of lr, c1, c2; loss: (k, E) step-major; bar: two zeroed uint32 words.
// *grid receives the CTA count.  Returns 0 on success, else a CUDA error
// code (the cooperative launch's own when the grid cannot be resident).
int lbdrn_fused_multi_step(const StepArgs* args, int E, int k, const float* x,
                           long long x_es, long long x_ss, const float* y, long long y_es,
                           long long y_ss, const float* mask, long long mask_es,
                           long long mask_ss, float* scratch, int n_tiles, int S, int smem_bytes,
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
  void* kargs[] = {&a,       &E,       &k,    &x,       &x_es,   &x_ss,   &y,
                   &y_es,    &y_ss,    &mask, &mask_es, &mask_ss, &scratch, &n_tiles,
                   &S,       &sched,   &loss, &bar};
  e = cudaLaunchCooperativeKernel(fn, dim3(n_blocks), dim3(THREADS), kargs, smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
