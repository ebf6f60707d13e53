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
// mask of ones.  The variants of this source (the host maps the JAX names
// onto them, lbdrn_msic_tpu_torch/profiling/kernel_prof.py):
//   full_t       exact sinf forward, cosf backward, FFMA products; the
//                backward's transposed weights W^T staged in shared memory
//                (the TPU probe is the layout of the transposed operand)
//   full_dg      the same function reading W in place: the dH product takes
//                W's rows along k (`mm_nt`), the same FMA chain in k order,
//                so full_dg is full_t bit for bit
//   tile2048     full_dg at a quarter of the rows per CTA (a launch
//                argument), as the JAX variant is at a quarter of the batch
//                per grid step: a per-CTA fixed-cost probe, same function
//   fast_full    full_t with the 2pi-period polynomial sin/cos
//   prec_default the TPU's one-pass reduced-precision product; here one-pass
//                TF32 on wgmma
//   prec_high    the TPU's three-pass product; here 3xTF32 on wgmma
//                (big*big + big*small + small*big, small terms first)
//   fwd_notrans  forward only: identity activations, linear head, the
//                unscaled masked SSE as the loss; params, m and v unchanged
// prod_f32 and prod_bf16 are K1 itself (csrc/fused_step.cu, mm_dtype None /
// "bfloat16", c1 = c2 = 1), as the JAX variants call the production
// `_fwd_bwd`.
//
// Design: every variant is K1's Hopper step (csrc/fused_step.cu) with the
// one factor its JAX probe names changed, so that the
// difference from prod_f32 reads as that factor's cost.  From
// step_async.cuh it takes the TMA 1-D bulk copies on one mbarrier per
// layer, the `row_stride` layouts, the `mmv` float4 FFMA product, the
// bias-gradient `col_sums` and the two-level pass-2 sum with the Adam
// update; the rows past B and the cp.async route of K1 are not needed,
// since the host takes only widths, rows and pointers whose every copy is
// a 16-byte multiple and a batch that is a whole number of CTA tiles.
//   Pass 1: one CTA per `rows` batch rows writes its partial dW/db, SSE and
//           mask count to its own scratch row (no float atomics).
//   Pass 2: `prof_adam`, K1's two-level sum over the partial rows (one CTA
//           per 30 parameters plus SSE and count), scaled by inv, Adam with
//           c1 = c2 = 1; launched as a programmatic dependent of pass 1.
//
// The tensor-core variants (prec_*; the bench widths only, 64 rows a CTA)
// run every product on wgmma.mma_async m64nNk8 tf32 with f32 accumulation:
// one warp group per 64-row M tile, the CTA's two warp groups splitting N
// (the head's N = 8 and its dW, on warp group 0 alone).  For 32-bit types
// wgmma reads shared-memory operands K-major only, so the right operand B
// of every product lies in shared memory in the no-swizzle K-major core
// layout (`core_off`: 8 x 4 tf32 core matrices of 128 contiguous bytes)
// and the left operand A comes from registers, which a thread loads from
// any layout.  Each product is oriented so that every matrix has one core
// layout (n = the index the matrix is B's N by, k = its depth):
//   forward  z = h W           A h (row, in)          B W^T: (out, in)
//   head dW  dW = h^T g        A h^T (in, row)        B g: (out, row)
//   dH       dH^T = W g^T      A W (in, out)          B g: (row, out)
//   dW       dW^T = g^T h      A g^T (out, row)       B h: (in, row)
//   layer 0  dW0 = x^T g0      A x^T (in, row)        B g0: (out, row)
// so the hidden activations are written in (in, row), g1 in (row, out), g0
// in (out, row), the head's g in both (it is 64 x 4), and W^T once (A of
// dH reads W from the W^T planes).  TMA lands x and the raw weights; the
// threads write each B operand once, rounded with cvt.rna.tf32.f32 (the
// tensor core truncates, the plain version rounds ties away): the weights
// at staging (into the planes' own region, through registers), h and g in
// the epilogue that makes them.  The head's N = 4 and its dH depth 4 are
// padded to 8 with zeros that are written.  3xTF32: each B operand is
// written as two planes, big = rna(v) and small = rna(v - big), once; the
// A side is split in registers as each fragment is loaded (its planes,
// where it has them, are read instead), since big and small planes of
// every operand do not fit in 227 KB beside x (the carve-up is mirrored by
// kernel_prof.py::smem_bytes: 224,256 B at 3xTF32, 161,792 B at TF32).
// Each k step issues small*big and big*small before big*big.  Regions are
// reused as operands die: W0^T's planes hold h2, cos1 and the head's g
// after the first product, g1 then overwrites h2 and g0 overwrites h1.
// The bias gradients are `col_sums` of each g kept raw in f32.
//
// Bound at B = 8192: the products are 482 MFLOP (forward, dW, dH) against
// ~4.7 MB of compulsory traffic.  FFMA variants ~7.6 us (67 TFLOP/s f32);
// TF32 at 495 TFLOP/s needs ~1 us, 3xTF32 ~3 us, so both are bound by the
// bytes (~1.4 us at 3.35 TB/s) or by their CUDA-core work; fwd_notrans does
// the forward's 206 MFLOP only.

#include "step_async.cuh"

namespace {

enum Act { kExact = 0, kPoly = 1, kIdentity = 2 };

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

// one mbarrier per layer at the start of smem, initialised before any use
__device__ __forceinline__ uint64_t* init_bars(int L, float* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int l = 0; l < L; ++l) mbar_init(&bars[l], 1);
    fence_mbar_init();
  }
  __syncthreads();
  return bars;
}

// ---------------------------------------------------------------- FFMA pass 1

// K1's product dispatch: 4 x 4 thread tiles where there are at least 128
// of them, else 1 x 4; both operands in shared memory.
template <bool kATrans, class EP>
__device__ __forceinline__ void mm(int M, int N, int K, const float* A, int lda, const float* B,
                                   int ldb, EP ep) {
  if (((M + 3) >> 2) * ((N + 3) >> 2) >= THREADS / 2)
    mmv<false, kATrans, 4, 0>(M, N, K, A, lda, B, ldb, ep);
  else
    mmv<false, kATrans, 1, 0>(M, N, K, A, lda, B, ldb, ep);
}

// out(i, j) = sum_k A[i * lda + k] * B[j * ldb + k]: the right operand read
// in place along k (full_dg's dH on W).  mmv's arithmetic, k ascending with
// FFMA from 0 for each output, so it gives mmv's bits on the transposed
// operand.  Each thread takes kTM x 4 outputs, rows ti + ii * ceil(M / 4)
// and columns tj + jj * ceil(N / 4) (strided, so that the rows of B that
// one warp instruction reads, at a `row_stride`, fall on different banks);
// full tiles read float4s along k, edge tiles and the k tail scalars in
// the same order.
template <int kTM, class EP>
__device__ __forceinline__ void mm_nt_tiles(int M, int N, int K, const float* A, int lda,
                                            const float* B, int ldb, EP ep) {
  const int tm = kTM == 4 ? (M + 3) >> 2 : M, tn = (N + 3) >> 2;
  const bool vec = ((lda | ldb) & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) & 15) == 0;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int ti = t / tn, tj = t - ti * tn;
    int rows[kTM], cols[4];
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii) rows[ii] = ti + ii * tm;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) cols[jj] = tj + jj * tn;
    float acc[kTM][4];
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
    int k = 0;
    if (vec && rows[kTM - 1] < M && cols[3] < N) {
      for (; k + 4 <= K; k += 4) {
        float4 av[kTM], bv[4];
#pragma unroll
        for (int ii = 0; ii < kTM; ++ii)
          av[ii] = *reinterpret_cast<const float4*>(A + rows[ii] * lda + k);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bv[jj] = *reinterpret_cast<const float4*>(B + cols[jj] * ldb + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[ii][jj] = fmaf(comp(av[ii], kk), comp(bv[jj], kk), acc[ii][jj]);
      }
    }
    for (; k < K; ++k) {
      float av[kTM], bv[4];
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) av[ii] = rows[ii] < M ? A[rows[ii] * lda + k] : 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = cols[jj] < N ? B[cols[jj] * ldb + k] : 0.0f;
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (rows[ii] < M && cols[jj] < N) ep(rows[ii], cols[jj], acc[ii][jj]);
  }
}

template <class EP>
__device__ __forceinline__ void mm_nt(int M, int N, int K, const float* A, int lda,
                                      const float* B, int ldb, EP ep) {
  if (((M + 3) >> 2) * ((N + 3) >> 2) >= THREADS / 2)
    mm_nt_tiles<4>(M, N, K, A, lda, B, ldb, ep);
  else
    mm_nt_tiles<1>(M, N, K, A, lda, B, ldb, ep);
}

// Pass 1 of the FFMA variants: CTA t runs batch rows t*rows ..
// t*rows+rows-1 and writes its partial dW/db (layer by layer, weight then
// bias), SSE and mask count to scratch row t (stride S).  K1's staging and
// carve-up (floats, each array 16-byte aligned; kernel_prof.py::smem_bytes
// sums the same): mbarriers, the x tile at row_stride(F), y, mask, the
// block-sum buffer, two gradient buffers at the widest row_stride, every
// weight and bias (kNT: W of layers 1.. as din rows at row_stride(dout),
// copied row by row), W^T of layers 1.. when kStageWT (dout rows at
// row_stride(din), transposed after the head as K1 does), the hidden
// activations and, unless kFwdOnly, their w0*cos caches.  At most 128
// registers a thread (two CTAs an SM), so that tile2048's 16-row CTAs,
// 86 KB each, can pair on an SM.
template <int kAct, bool kFwdOnly, bool kStageWT, bool kNT>
__global__ void __launch_bounds__(THREADS, 2)
    prof_ffma(StepArgs a, const float* x, const float* y, const float* mask, float* scratch,
              int S) {
  extern __shared__ __align__(16) float smem[];
  pdl_launch_dependents();  // pass 2 may launch now; it waits for this grid's end
  const int L = a.L, R = a.rows, F = a.dims[0], C = a.dims[L];
  const int row0 = blockIdx.x * R;
  const int P = n_params(a);
  uint64_t* bars = init_bars(L, smem);

  int ldg = 0;
  for (int l = 1; l <= L; ++l) ldg = max(ldg, row_stride(a.dims[l]));
  const int ldx = row_stride(F);
  float* xs = smem + round4(2 * L);
  float* ys = xs + R * ldx;
  float* ms = ys + round4(R * C);
  float* red = ms + round4(R);
  float* ga = red + THREADS;
  float* gb = ga + R * ldg;
  float* wsm = gb + R * ldg;
  auto wld = [&](int l) -> int {  // row stride of layer l's staged weight
    return kNT && l > 0 ? row_stride(a.dims[l + 1]) : a.dims[l + 1];
  };
  auto wsz = [&](int l) -> int {
    return kNT && l > 0 ? a.dims[l] * wld(l) : round4(a.dims[l] * a.dims[l + 1]);
  };
  auto wl = [&](int l) -> float* {  // layer l's staged weight, then its bias
    float* p = wsm;
    for (int q = 0; q < l; ++q) p += wsz(q) + round4(a.dims[q + 1]);
    return p;
  };
  float* wts = wl(L);
  float* acts = wts;
  if (kStageWT)
    for (int l = 1; l < L; ++l) acts += a.dims[l + 1] * row_stride(a.dims[l]);
  auto wtl = [&](int l) -> float* {  // W^T of layer l >= 1
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

  // ---- staging: barrier 0 covers x, W0 and b0, barrier l W_l and b_l, the
  // last one also y and mask
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int l = 0; l < L; ++l) {
        const int din = a.dims[l], dout = a.dims[l + 1];
        uint32_t tx = (uint32_t)(din * dout + dout) * 4;
        if (l == 0) tx += (uint32_t)R * F * 4;
        if (l == L - 1) tx += (uint32_t)(R * C + R) * 4;
        mbar_arrive_tx(&bars[l], tx);
      }
      for (int l = 0; l < L; ++l) {
        const int din = a.dims[l], dout = a.dims[l + 1];
        if (!(kNT && l > 0)) bulk_copy(wl(l), a.w[l], din * dout * 4, &bars[l]);
        bulk_copy(wl(l) + wsz(l), a.b[l], dout * 4, &bars[l]);
      }
      bulk_copy(ys, y + (size_t)row0 * C, R * C * 4, &bars[L - 1]);
      bulk_copy(ms, mask + row0, R * 4, &bars[L - 1]);
    }
    __syncwarp();
    for (int r = threadIdx.x; r < R; r += 32)
      bulk_copy(xs + r * ldx, x + (size_t)(row0 + r) * F, F * 4, &bars[0]);
    if (kNT)
      for (int l = 1; l < L; ++l) {
        const int dout = a.dims[l + 1];
        for (int r = threadIdx.x; r < a.dims[l]; r += 32)
          bulk_copy(wl(l) + r * wld(l), a.w[l] + r * dout, dout * 4, &bars[l]);
      }
  }
  float* part = scratch + (size_t)blockIdx.x * S;

  // ---- forward through the hidden layers
  for (int l = 0; l < L - 1; ++l) {
    mbar_wait(&bars[l], 0);
    const int din = a.dims[l], dout = a.dims[l + 1], ldo = row_stride(dout);
    const float* W = wl(l);
    const float* bias = W + wsz(l);
    float* hout = hl(l + 1);
    float* co = cosl(l);
    const float w0 = a.w0[l];
    mm<false>(R, dout, din, hl(l), row_stride(din), W, wld(l), [&](int i, int j, float acc) {
      const float z = __fadd_rn(acc, bias[j]);
      if constexpr (kAct == kIdentity) {
        hout[i * ldo + j] = z;
      } else {
        float s, c;
        act<kAct>(__fmul_rn(w0, z), &s, &c);
        hout[i * ldo + j] = s;
        co[i * ldo + j] = __fmul_rn(w0, c);
      }
    });
    __syncthreads();
  }

  // ---- head, masked squared error, d(sum se)/dz_last
  {
    mbar_wait(&bars[L - 1], 0);
    const int din = a.dims[L - 1], ldc = row_stride(C);
    const float* W = wl(L - 1);
    const float* bias = W + wsz(L - 1);
    mm<false>(R, C, din, hl(L - 1), row_stride(din), W, wld(L - 1), [&](int i, int j, float acc) {
      const float z = __fadd_rn(acc, bias[j]);
      if constexpr (kFwdOnly) {  // linear head
        const float diff = __fmul_rn(__fsub_rn(z, ys[i * C + j]), ms[i]);
        gb[i * C + j] = __fmul_rn(diff, diff);
      } else {
        const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
        const float diff = __fmul_rn(__fsub_rn(p, ys[i * C + j]), ms[i]);
        gb[i * C + j] = __fmul_rn(diff, diff);
        ga[i * ldc + j] = __fmul_rn(__fmul_rn(2.0f, diff), __fmul_rn(p, __fsub_rn(1.0f, p)));
      }
    });
    // W^T of layers 1.. for the dH products, in 4 x 4 register blocks
    if (kStageWT)
      for (int l = 1; l < L; ++l) {
        const int din = a.dims[l], dout = a.dims[l + 1], ldt = row_stride(din), nk = dout >> 2;
        const float* Wl = wl(l);
        float* WT = wtl(l);
        for (int b = threadIdx.x; b < (din >> 2) * nk; b += blockDim.x) {
          const int jb = b / nk, kb = b - jb * nk;
          float4 r[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            r[rr] = *reinterpret_cast<const float4*>(Wl + (4 * jb + rr) * dout + 4 * kb);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(WT + (4 * kb + c) * ldt + 4 * jb) =
                make_float4(comp(r[0], c), comp(r[1], c), comp(r[2], c), comp(r[3], c));
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
  if constexpr (kFwdOnly) return;

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
    mm<true>(din, dout, R, hl(l), ldi, gc, ldgl,
             [&](int i, int j, float acc) { dW[i * dout + j] = acc; });
    col_sums(gc, R, dout, ldgl, db);
    if (l > 0) {
      const float* co = cosl(l - 1);
      float* gw = gn;
      auto ep = [&](int i, int j, float acc) { gw[i * ldi + j] = __fmul_rn(acc, co[i * ldi + j]); };
      if constexpr (kStageWT) mm<false>(R, din, dout, gc, ldgl, wtl(l), ldi, ep);
      else mm_nt(R, din, dout, gc, ldgl, wl(l), wld(l), ep);
    }
    __syncthreads();
    float* t = g; g = gn; gn = t;
  }
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v's tf32 parts: big = rna(v), and with k3x small = rna(v - big)
template <bool k3x>
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  if constexpr (k3x) small = tf32(__fsub_rn(v, __uint_as_float(big)));
}

// write v's parts at o of a B operand's planes (small at + plane)
template <bool k3x>
__device__ __forceinline__ void put(float* pl, int plane, int o, float v) {
  uint32_t big, small = 0;
  split<k3x>(v, big, small);
  pl[o] = __uint_as_float(big);
  if constexpr (k3x) pl[plane + o] = __uint_as_float(small);
}

// Element (n, k) of an N x K operand in wgmma's no-swizzle K-major layout:
// 8 x 4 core matrices (8 rows n of 16 bytes, 4 consecutive k) of 128
// contiguous bytes; the K / 4 core matrices of one 8-row group follow each
// other (leading byte offset 128), the 8-row groups lie 32 K bytes apart
// (stride byte offset).  Mirrored by kernel_prof.py::core_offset.
__device__ __forceinline__ int core_off(int n, int k, int K) {
  return (n >> 3) * (8 * K) + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// the shared-memory matrix descriptor of such an operand at p (16-byte
// aligned): start address, leading and stride byte offsets (in 16-byte
// units), no swizzle
__device__ __forceinline__ uint64_t desc(const float* p, int K) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((32 * K) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// order this thread's generic-proxy writes of shared memory before the
// async proxy's reads (wgmma operands)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// keep the compiler from moving accesses of the accumulators across wgmma
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 8, tf32, registers) * B (8 x N, tf32, shared
// memory through descriptor b)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 8 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// This warp group's 64 x N tile d = A (64 x K) B (K x N) on wgmma.
// a(i, k, big, small): the tf32 parts of A's element (tile row i, k), for
// the fragment layout of m64nNk8 tf32 (warp q of the group rows 16 q ..,
// lane 4 g + t: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)).
// bb, bs: B's big and small planes (N x K, core layout) at the tile's
// first column.  The fragments of up to 8 k steps are loaded, then their
// products issued and waited for.
template <int N, int K, bool k3x, class AF>
__device__ __forceinline__ void wg_mm(float (&d)[N / 2], AF a, const float* bb, const float* bs) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2),
            t = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  constexpr int kSteps = K / 8, kChunk = kSteps < 8 ? kSteps : 8;
  static_assert(K % 8 == 0 && kSteps % kChunk == 0, "depth");
#pragma unroll
  for (int c = 0; c < kSteps; c += kChunk) {
    uint32_t ab[kChunk][4], as[kChunk][4];
#pragma unroll
    for (int s = 0; s < kChunk; ++s)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        a(r0 + 8 * (v & 1), 8 * (c + s) + t + 4 * (v >> 1), ab[s][v], as[s][v]);
    fence_regs(d);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const uint64_t db = desc(bb + 64 * (c + s), K);
      if constexpr (k3x) {
        wgmma<N>(d, as[s], db);
        wgmma<N>(d, ab[s], desc(bs + 64 * (c + s), K));
      }
      wgmma<N>(d, ab[s], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(d);
  }
}

// ep(i, j, v) for each element of this warp group's 64 x N accumulator:
// d[4 jb + 2 h + e] is (tile row 16 q + g + 8 h, column 8 jb + 2 t + e)
template <int N, class EP>
__device__ __forceinline__ void wg_store(const float (&d)[N / 2], EP ep) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2),
            c0 = 2 * (lane & 3);
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb)
#pragma unroll
    for (int v = 0; v < 4; ++v) ep(r0 + 8 * (v >> 1), 8 * jb + c0 + (v & 1), d[4 * jb + v]);
}

// The bench widths of the tensor-core variants: 64 rows, 128 -> 64 -> 64
// -> 4, the head padded to 8.
constexpr int kR = 64, kF = 128, kH = 64, kC = 4, kNC = 8;
constexpr int kLdx = kF + 4, kLdh = kH + 4;  // row_stride(kF), row_stride(kH)

// W (K x N, row-major, raw) lying at the start of dst -> the planes of its
// transpose (NP x K, core layout, rows N.. zero).  Every thread reads its
// share into registers before any thread writes.
template <int K, int N, int NP, bool k3x>
__device__ __forceinline__ void convert_wt(float* dst) {
  constexpr int kPer = NP * K / THREADS;
  static_assert(NP * K % THREADS == 0, "share");
  float v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * THREADS, k = i / NP, n = i - k * NP;
    v[q] = n < N ? dst[k * N + n] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * THREADS, k = i / NP, n = i - k * NP;
    put<k3x>(dst, NP * K, core_off(n, k, K), v[q]);
  }
}

// Pass 1 of the tensor-core variants (see the header).  Carve-up (floats,
// every region a multiple of 32; P = planes, 2 for k3x): mbarriers (32),
// x (kR x kLdx), y, mask, the block-sum buffer, the biases (64 + 64 + 32),
// region A (W0^T's planes; then h2's planes, cos1, the head's g as (out,
// row) and as (row, out); g1 over h2), W1^T's and W2^T's planes, h1's
// planes (g0 over them), cos0, two raw gradient buffers (kR x kLdh).
template <bool k3x>
__global__ void __launch_bounds__(THREADS) prof_tc(StepArgs a, const float* x, const float* y,
                                                   const float* mask, float* scratch, int S) {
  extern __shared__ __align__(16) float smem[];
  pdl_launch_dependents();
  constexpr int P = k3x ? 2 : 1;
  constexpr int kW0 = kH * kF, kW1 = kH * kH, kW2 = kNC * kH, kHp = kH * kR, kG2 = kNC * kR,
                kCos = kR * kLdh;
  constexpr int kAfter = P * kHp + kCos + 2 * P * kG2;  // h2, cos1, the head's g
  constexpr int kRegA = P * kW0 > kAfter ? P * kW0 : kAfter;
  const int row0 = blockIdx.x * kR;
  const int n_par = n_params(a);
  uint64_t* bars = init_bars(3, smem);
  float* xs = smem + 32;
  float* ys = xs + kR * kLdx;
  float* ms = ys + kR * kC;
  float* red = ms + kR;
  float* bias = red + THREADS;  // b0 at 0, b1 at 64, b2 at 128
  float* w0t = bias + 160;      // region A
  float* h2 = w0t;
  float* cos1 = h2 + P * kHp;
  float* g2o = cos1 + kCos;     // head g as (out, row): N 8, K kR
  float* g2r = g2o + P * kG2;   // head g as (row, out): N kR, K 8
  float* g1 = w0t;              // (row, out): N kR, K kH
  float* w1t = w0t + kRegA;
  float* w2t = w1t + P * kW1;
  float* h1 = w2t + P * kW2;    // (in, row): N kH, K kR
  float* g0 = h1;               // (out, row): N kH, K kR
  float* cos0 = h1 + P * kHp;
  float* gra = cos0 + kCos;     // raw g2 (stride kC), then raw g0 (stride kLdh)
  float* grb = gra + kCos;      // the head's squared errors, then raw g1
  const int wg = threadIdx.x >> 7;
  float* part = scratch + (size_t)blockIdx.x * S;
  float* dW0 = part;
  float* db0 = dW0 + kF * kH;
  float* dW1 = db0 + kH;
  float* db1 = dW1 + kH * kH;
  float* dW2 = db1 + kH;
  float* db2 = dW2 + kH * kC;

  // ---- staging: barrier 0 x, W0, b0; 1 W1, b1; 2 W2, b2, y, mask.  The
  // raw weights land at the start of their planes.
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&bars[0], (kR * kF + kF * kH + kH) * 4);
      mbar_arrive_tx(&bars[1], (kH * kH + kH) * 4);
      mbar_arrive_tx(&bars[2], (kH * kC + kC + kR * kC + kR) * 4);
      bulk_copy(w0t, a.w[0], kF * kH * 4, &bars[0]);
      bulk_copy(bias, a.b[0], kH * 4, &bars[0]);
      bulk_copy(w1t, a.w[1], kH * kH * 4, &bars[1]);
      bulk_copy(bias + 64, a.b[1], kH * 4, &bars[1]);
      bulk_copy(w2t, a.w[2], kH * kC * 4, &bars[2]);
      bulk_copy(bias + 128, a.b[2], kC * 4, &bars[2]);
      bulk_copy(ys, y + (size_t)row0 * kC, kR * kC * 4, &bars[2]);
      bulk_copy(ms, mask + row0, kR * 4, &bars[2]);
    }
    __syncwarp();
    for (int r = threadIdx.x; r < kR; r += 32)
      bulk_copy(xs + r * kLdx, x + (size_t)(row0 + r) * kF, kF * 4, &bars[0]);
  }
  mbar_wait(&bars[0], 0);
  convert_wt<kF, kH, kH, k3x>(w0t);
  fence_async_smem();
  __syncthreads();

  auto x_rows = [&](int i, int k, uint32_t& b, uint32_t& s) { split<k3x>(xs[i * kLdx + k], b, s); };
  // A from planes: element (i, k) of A is (n, k') = nk(i, k) of the planes at pl
  auto planes = [&](const float* pl, int plane, int K, bool swap) {
    return [=](int i, int k, uint32_t& b, uint32_t& s) {
      const int o = swap ? core_off(k, i, K) : core_off(i, k, K);
      b = __float_as_uint(pl[o]);
      if constexpr (k3x) s = __float_as_uint(pl[plane + o]);
    };
  };

  // ---- layer 0: z = x W0, warp group wg columns 32 wg ..; h1 as (in, row)
  {
    float d[16];
    const int n0 = 32 * wg;
    wg_mm<32, kF, k3x>(d, x_rows, w0t + n0 * kF, w0t + kW0 + n0 * kF);
    const float w0 = a.w0[0];
    wg_store<32>(d, [&](int i, int j, float acc) {
      const int o = n0 + j;
      float s, c;
      act<kExact>(__fmul_rn(w0, __fadd_rn(acc, bias[o])), &s, &c);
      put<k3x>(h1, kHp, core_off(o, i, kR), s);
      cos0[i * kLdh + o] = __fmul_rn(w0, c);
    });
  }
  mbar_wait(&bars[1], 0);
  convert_wt<kH, kH, kH, k3x>(w1t);
  mbar_wait(&bars[2], 0);
  convert_wt<kH, kC, kNC, k3x>(w2t);
  fence_async_smem();
  __syncthreads();

  // ---- layer 1: z = h1 W1; h2 as (in, row) over W0^T
  {
    float d[16];
    const int n0 = 32 * wg;
    wg_mm<32, kH, k3x>(d, planes(h1, kHp, kR, true), w1t + n0 * kH, w1t + kW1 + n0 * kH);
    const float w0 = a.w0[1];
    wg_store<32>(d, [&](int i, int j, float acc) {
      const int o = n0 + j;
      float s, c;
      act<kExact>(__fmul_rn(w0, __fadd_rn(acc, bias[64 + o])), &s, &c);
      put<k3x>(h2, kHp, core_off(o, i, kR), s);
      cos1[i * kLdh + o] = __fmul_rn(w0, c);
    });
  }
  fence_async_smem();
  __syncthreads();

  // ---- head (warp group 0): sigmoid, masked squared error, g written raw
  // and as both operands, zero in the padded columns
  if (wg == 0) {
    float d[4];
    wg_mm<8, kH, k3x>(d, planes(h2, kHp, kR, true), w2t, w2t + kW2);
    wg_store<8>(d, [&](int i, int j, float acc) {
      float gv = 0.0f;
      if (j < kC) {
        const float z = __fadd_rn(acc, bias[128 + j]);
        const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
        const float diff = __fmul_rn(__fsub_rn(p, ys[i * kC + j]), ms[i]);
        grb[i * kC + j] = __fmul_rn(diff, diff);
        gv = __fmul_rn(__fmul_rn(2.0f, diff), __fmul_rn(p, __fsub_rn(1.0f, p)));
        gra[i * kC + j] = gv;
      }
      put<k3x>(g2o, kG2, core_off(j, i, kR), gv);
      put<k3x>(g2r, kG2, core_off(i, j, kNC), gv);
    });
  }
  fence_async_smem();
  __syncthreads();
  {
    const float sse = block_sum(grb, kR * kC, red);
    const float cnt = block_sum(ms, kR, red);
    if (threadIdx.x == 0) {
      part[n_par] = sse;
      part[n_par + 1] = cnt;
    }
  }
  col_sums(gra, kR, kC, kC, db2);

  // ---- head dW = h2^T g (warp group 0)
  if (wg == 0) {
    float d[4];
    wg_mm<8, kR, k3x>(d, planes(h2, kHp, kR, false), g2o, g2o + kG2);
    wg_store<8>(d, [&](int i, int j, float acc) {
      if (j < kC) dW2[i * kC + j] = acc;
    });
  }
  __syncthreads();  // h2 is read; g1 overwrites it

  // ---- dH^T = W2 g^T (depth 8), times cos1: g1 raw and as (row, out)
  {
    float d[16];
    const int n0 = 32 * wg;
    wg_mm<32, kNC, k3x>(d, planes(w2t, kW2, kH, true), g2r + n0 * kNC, g2r + kG2 + n0 * kNC);
    wg_store<32>(d, [&](int i, int j, float acc) {
      const int r = n0 + j;
      const float v = __fmul_rn(acc, cos1[r * kLdh + i]);
      grb[r * kLdh + i] = v;
      put<k3x>(g1, kHp, core_off(r, i, kH), v);
    });
  }
  fence_async_smem();
  __syncthreads();
  col_sums(grb, kR, kH, kLdh, db1);

  // ---- dW1^T = g1^T h1, warp group wg inputs 32 wg ..
  {
    float d[16];
    const int n0 = 32 * wg;
    wg_mm<32, kR, k3x>(d, planes(g1, kHp, kH, true), h1 + n0 * kR, h1 + kHp + n0 * kR);
    wg_store<32>(d, [&](int i, int j, float acc) { dW1[(n0 + j) * kH + i] = acc; });
  }
  __syncthreads();  // h1 is read; g0 overwrites it

  // ---- dH^T = W1 g1^T, times cos0: g0 raw and as (out, row)
  {
    float d[16];
    const int n0 = 32 * wg;
    wg_mm<32, kH, k3x>(d, planes(w1t, kW1, kH, true), g1 + n0 * kH, g1 + kHp + n0 * kH);
    wg_store<32>(d, [&](int i, int j, float acc) {
      const int r = n0 + j;
      const float v = __fmul_rn(acc, cos0[r * kLdh + i]);
      gra[r * kLdh + i] = v;
      put<k3x>(g0, kHp, core_off(i, r, kR), v);
    });
  }
  fence_async_smem();
  __syncthreads();
  col_sums(gra, kR, kH, kLdh, db0);

  // ---- dW0 = x^T g0, warp group wg inputs 64 wg .. (two M tiles)
  {
    float d[32];
    const int f0 = 64 * wg;
    wg_mm<64, kR, k3x>(
        d, [&](int i, int k, uint32_t& b, uint32_t& s) { split<k3x>(xs[k * kLdx + f0 + i], b, s); },
        g0, g0 + kHp);
    wg_store<64>(d, [&](int i, int j, float acc) { dW0[(f0 + i) * kH + j] = acc; });
  }
}

// ---------------------------------------------------------------- pass 2

// K1's second pass with K5's scaling: CTA c sums chunk c's parameters (and
// the SSE) over the n_tiles partial rows in the two-level order, scales by
// inv and applies Adam (c1 = c2 = 1) in place; chunk 0 writes the loss
// (SSE * inv; the unscaled SSE and no update for the forward-only variant,
// launched as one CTA).
__global__ void __launch_bounds__(THREADS) prof_adam(StepArgs a, const float* scratch,
                                                     int n_tiles, int S, float* loss, float lr,
                                                     float inv, int fwd_only) {
  __shared__ float red[THREADS];
  pdl_wait();
  const int P = n_params(a), col = chunk_col(a, blockIdx.x);
  const float s = two_level_sum<false>(scratch, n_tiles, S, col, col < P + 2, red);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float sse = __shfl_sync(0xffffffffu, s, ADAM_COLS);
    if (!fwd_only && lane < ADAM_COLS && col < P)
      adam_update<false>(a, 0, col, __fmul_rn(s, inv), lr, 1.0f, 1.0f);
    if (blockIdx.x == 0 && lane == 0) *loss = fwd_only ? sse : __fmul_rn(sse, inv);
  }
}

using Partials = void (*)(StepArgs, const float*, const float*, const float*, float*, int);

// the instantiation of each kernel id (lbdrn_kprof_step's `kernel`)
constexpr int kKernels = 6;
constexpr int kFwdOnlyKernel = 5;
const Partials kPartials[kKernels] = {
    prof_ffma<kExact, false, true, false>,     // 0 full_t
    prof_ffma<kExact, false, false, true>,     // 1 full_dg, tile2048
    prof_ffma<kPoly, false, true, false>,      // 2 fast_full
    prof_tc<false>,                            // 3 prec_default
    prof_tc<true>,                             // 4 prec_high
    prof_ffma<kIdentity, true, false, false>,  // 5 fwd_notrans
};

}  // namespace

extern "C" {

// One step of probe `kernel` (see kPartials): pass 1 over n_tiles CTAs of
// args->rows rows, then the reduction + Adam as its programmatic
// dependent.  scratch: (n_tiles, S) floats.  Returns 0 on success, else
// the CUDA error code of the refused launch or attribute.
int lbdrn_kprof_step(const StepArgs* args, int kernel, const float* x, const float* y,
                     const float* mask, float* scratch, int n_tiles, int S, int smem_bytes,
                     float* loss, float lr, float inv, void* stream) {
  static int smem_set[kKernels] = {0};  // opted-in size per instantiation
  if (kernel < 0 || kernel >= kKernels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Partials fn = kPartials[kernel];
  cudaError_t e;
  if (smem_bytes > smem_set[kernel]) {
    e = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[kernel] = smem_bytes;
  }
  StepArgs a = *args;
  fn<<<n_tiles, THREADS, smem_bytes, s>>>(a, x, y, mask, scratch, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  int P = 0;
  for (int l = 0; l < a.L; ++l) P += a.dims[l] * a.dims[l + 1] + a.dims[l + 1];
  const int fwd_only = kernel == kFwdOnlyKernel;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fwd_only ? 1 : (P + ADAM_COLS - 1) / ADAM_COLS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const float* sc = scratch;
  e = cudaLaunchKernelEx(&cfg, prof_adam, a, sc, n_tiles, S, loss, lr, inv, fwd_only);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
