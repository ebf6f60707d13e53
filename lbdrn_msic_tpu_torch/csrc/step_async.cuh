// Device code of the Hopper design of the fused-step kernels (fused_step.cu:
// K1-K4): asynchronous staging (TMA bulk copies completing on mbarriers,
// cp.async for arrays that are not 16-byte multiples),
// the shared-memory row strides that keep a warp's 16-byte operand reads
// free of bank conflicts, the vectorised FFMA product, the bias-gradient
// column sums in a fixed tree, and the two-level cross-tile reduction with
// the Adam update of the second pass.
#pragma once

#include "step_common.cuh"

#define TILE_GROUP 16  // tiles summed in order into one group sum (two-level reduction)
#define ADAM_COLS 30   // parameters per CTA chunk of the second pass (+ SSE, count: one warp)

namespace {

// ---------------------------------------------------------------- layout

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Row stride (floats) of an activation, gradient or x tile of width n in
// shared memory: a multiple of 4 (16-byte rows for float4 reads) that is
// not a multiple of 32, so that two rows a warp reads in one instruction
// fall on different banks.  Mirrored by ops/fused_step.py::row_stride.
__host__ __device__ __forceinline__ int row_stride(int n) {
  const int r = round4(n);
  return (r % 32 == 0) ? r + 4 : r;
}

// A copy of `bytes` from global `src` to shared `dst` goes as one TMA bulk
// copy when both addresses and the size are 16-byte multiples, else as
// 4-byte cp.async copies spread over the CTA's threads.
__device__ __forceinline__ bool bulk_ok(const void* dst, const void* src, size_t bytes) {
  return ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also raises the barrier's expected transaction bytes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// order this thread's earlier generic-proxy accesses before later
// async-proxy ones (bulk copies), in shared and global memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// programmatic dependent launch: let the next grid on the stream start
// launching / wait until the previous grid has completed and flushed
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// ---------------------------------------------------------------- staging

// The bytes of n floats from global src to shared dst when they go as one
// bulk copy (counted into a barrier's expect_tx, then issued); 0 when they
// are none or take the cp.async route (copy_fallback).
__device__ __forceinline__ uint32_t bulk_bytes(float* dst, const float* src, int n) {
  return (n > 0 && bulk_ok(dst, src, (size_t)n * 4)) ? (uint32_t)n * 4 : 0u;
}

// The cp.async half of the route: every thread copies its strided share
// of an array that cannot go as one bulk copy.
__device__ __forceinline__ void copy_fallback(float* dst, const float* src, int n) {
  if (n <= 0 || bulk_ok(dst, src, (size_t)n * 4)) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

template <bool kCG>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (kCG) return __ldcg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 round4_bf16(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
}

// ---------------------------------------------------------------- product

// out(i, j) = sum_k a(i, k) * b(k, j), k ascending with FFMA, for an M x N
// output; ep(i, j, acc) consumes each result.  A lies in shared memory:
// kATrans false, a(i, k) = A[i * lda + k] (row-major, read as float4 along
// k); true, a(i, k) = A[k * lda + i] (read as float4 along i).  B is
// row-major, b(k, j) = B[k * ldb + j], in shared memory (kBSrc 0) or
// global memory (1; 2 through L2 only, for data the launch rewrites), read
// as float4 along j.  Each thread takes kTM x 4 output tiles (kTM 1, 4 or,
// without kATrans, 8): columns 4 tj .. 4 tj + 3; rows, with kATrans, 4 ti
// .. 4 ti + 3, else ti + ii * ceil(M / kTM) (strided, so that the two to
// four rows one warp instruction reads are neighbours and, at a row stride
// of `row_stride`, on different banks).  Full tiles run the vector loop with no bounds test; edge tiles
// (and operands that are not 16-byte aligned) a scalar loop in the same k
// order, so both give the same bits.  kBf16: each operand rounded to bf16
// as it is read.
template <bool kBf16, bool kATrans, int kTM, int kBSrc, class EP>
__device__ __forceinline__ void mmv(int M, int N, int K, const float* A, int lda, const float* B,
                                    int ldb, EP ep) {
  static_assert(kTM == 1 || kTM == 4 || (kTM == 8 && !kATrans), "row tile of 1, 4 or 8");
  const int tm = kTM == 8 ? (M + 7) >> 3 : kTM == 4 ? (M + 3) >> 2 : M, tn = (N + 3) >> 2;
  const int rs = kATrans || kTM == 1 ? 1 : tm;  // row step inside a tile (NN, 4 or 8 rows)
  const bool vec = ((lda | ldb) & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) & 15) == 0;
  auto ldb_ = [&](const float* p) -> float {
    if constexpr (kBSrc == 2) return __ldcg(p);
    else return *p;
  };
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int ti = t / tn, j0 = (t - ti * tn) << 2;
    int rows[kTM];
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii) rows[ii] = kATrans && kTM == 4 ? 4 * ti + ii : ti + ii * rs;
    float acc[kTM][4];
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
    const bool full = vec && j0 + 3 < N && rows[kTM - 1] < M;
    int k = 0;
    if (full) {
      if constexpr (kATrans) {
#pragma unroll 4
        for (; k < K; ++k) {
          float4 bv = ld4<kBSrc == 2>(B + (size_t)k * ldb + j0);
          if constexpr (kBf16) bv = round4_bf16(bv);
          if constexpr (kTM == 4) {
            float4 av = *reinterpret_cast<const float4*>(A + k * lda + rows[0]);
            if constexpr (kBf16) av = round4_bf16(av);
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[ii][jj] = fmaf(comp(av, ii), comp(bv, jj), acc[ii][jj]);
          } else {
            float av = A[k * lda + rows[0]];
            if constexpr (kBf16) av = bf16_round(av);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[0][jj] = fmaf(av, comp(bv, jj), acc[0][jj]);
          }
        }
      } else {
        for (; k + 4 <= K; k += 4) {
          float4 av[kTM], bv[4];
#pragma unroll
          for (int ii = 0; ii < kTM; ++ii) {
            av[ii] = *reinterpret_cast<const float4*>(A + rows[ii] * lda + k);
            if constexpr (kBf16) av[ii] = round4_bf16(av[ii]);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            bv[kk] = ld4<kBSrc == 2>(B + (size_t)(k + kk) * ldb + j0);
            if constexpr (kBf16) bv[kk] = round4_bf16(bv[kk]);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[ii][jj] = fmaf(comp(av[ii], kk), comp(bv[kk], jj), acc[ii][jj]);
        }
      }
    }
    // the k tail of a full tile, or the whole of an edge tile
    for (; k < K; ++k) {
      float av[kTM], bv[4];
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) {
        const int i = rows[ii];
        av[ii] = i < M ? (kATrans ? A[k * lda + i] : A[i * lda + k]) : 0.0f;
        if constexpr (kBf16) av[ii] = bf16_round(av[ii]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        bv[jj] = j0 + jj < N ? ldb_(B + (size_t)k * ldb + j0 + jj) : 0.0f;
        if constexpr (kBf16) bv[jj] = bf16_round(bv[jj]);
      }
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (rows[ii] < M && j0 + jj < N) ep(rows[ii], j0 + jj, acc[ii][jj]);
  }
}

// ---------------------------------------------------------------- sums

// Column sums of an R x N row-major array (row stride ld) in shared
// memory, out[j] = sum over rows, over all of the CTA's threads in a fixed
// order: T threads per column (the largest power of two <= THREADS / N, at
// most 32, consecutive lanes), thread q of a column summing rows q, q + T,
// ... in order, then a butterfly over the T lanes.  Every thread of the
// CTA must call it.
__device__ __forceinline__ void col_sums(const float* g, int R, int N, int ld, float* out) {
  int T = 1;
  while (2 * T * N <= THREADS && 2 * T <= 32) T *= 2;
  const int per = THREADS / T;  // columns one pass of the CTA covers
  for (int c0 = 0; c0 < N; c0 += per) {
    const int j = c0 + threadIdx.x / T, q = threadIdx.x % T;
    float s = 0.0f;
    if (j < N)
      for (int r = q; r < R; r += T) s = __fadd_rn(s, g[r * ld + j]);
    for (int h = 1; h < T; h <<= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, h));
    if (j < N && q == 0) out[j] = s;
  }
}

// Two-level sum of one column per lane of an (n_rows, S) array: rows in
// groups of TILE_GROUP, each group summed in row order, then the group sums
// in group order.  The CTA's 8 warps take 8 groups at a time (lane c of
// each its column col, where `valid`); warp 0 folds their sums in.  The
// order is fixed by n_rows alone.  Every thread must call it; the result is
// valid in warp 0.  red: 8 * 32 floats.
template <bool kCG>
__device__ __forceinline__ float two_level_sum(const float* scratch, int n_rows, int S, int col,
                                               bool valid, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, n_w = blockDim.x >> 5;
  const int n_groups = (n_rows + TILE_GROUP - 1) / TILE_GROUP;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_groups; g0 += n_w) {
    const int g = g0 + w;
    float s = 0.0f;
    if (valid && g < n_groups) {
      const float* p = scratch + (size_t)g * TILE_GROUP * S + col;
      const int rows = min(TILE_GROUP, n_rows - g * TILE_GROUP);
      if (rows == TILE_GROUP) {
        float v[TILE_GROUP];
#pragma unroll
        for (int r = 0; r < TILE_GROUP; ++r) v[r] = ld<kCG>(p + (size_t)r * S);
#pragma unroll
        for (int r = 0; r < TILE_GROUP; ++r) s = __fadd_rn(s, v[r]);
      } else {
        for (int r = 0; r < rows; ++r) s = __fadd_rn(s, ld<kCG>(p + (size_t)r * S));
      }
    }
    red[w * 32 + lane] = s;
    __syncthreads();
    if (w == 0)
      for (int q = 0; q < n_w && g0 + q < n_groups; ++q) total = __fadd_rn(total, red[q * 32 + lane]);
    __syncthreads();
  }
  return total;
}

// The same sum in the same order by one warp alone (lane c its column):
// the groups one after the other, two at a time in flight.  For callers
// that run one chunk per warp (K3/K4's Adam phase).
template <bool kCG>
__device__ __forceinline__ float warp_two_level_sum(const float* scratch, int n_rows, int S,
                                                    int col, bool valid) {
  float total = 0.0f;
  if (!valid) return total;
  const float* p = scratch + col;
  int r0 = 0;
  for (; r0 + 2 * TILE_GROUP <= n_rows; r0 += 2 * TILE_GROUP) {
    float v[2 * TILE_GROUP];
#pragma unroll
    for (int r = 0; r < 2 * TILE_GROUP; ++r) v[r] = ld<kCG>(p + (size_t)(r0 + r) * S);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TILE_GROUP; ++r) s = __fadd_rn(s, v[h * TILE_GROUP + r]);
      total = __fadd_rn(total, s);
    }
  }
  for (; r0 < n_rows; r0 += TILE_GROUP) {
    float s = 0.0f;
    for (int r = r0; r < min(r0 + TILE_GROUP, n_rows); ++r) s = __fadd_rn(s, ld<kCG>(p + (size_t)r * S));
    total = __fadd_rn(total, s);
  }
  return total;
}

// The scratch column lane (threadIdx.x & 31) of chunk `chunk` sums.
__device__ __forceinline__ int chunk_col(const StepArgs& a, int chunk) {
  const int lane = threadIdx.x & 31;
  return lane < ADAM_COLS ? chunk * ADAM_COLS + lane : n_params(a) + lane - ADAM_COLS;
}

// A warp's Adam step on the chunk from its lanes' column sums s (lanes
// ADAM_COLS, + 1: SSE and count).
template <bool kCG>
__device__ __forceinline__ void chunk_adam(const StepArgs& a, int e, int chunk, int col, float s,
                                           float* loss, float lr, float c1, float c2) {
  const int lane = threadIdx.x & 31;
  const float sse = __shfl_sync(0xffffffffu, s, ADAM_COLS);
  const float cnt = __shfl_sync(0xffffffffu, s, ADAM_COLS + 1);
  const float inv_scale = __fdiv_rn(1.0f, __fmul_rn(fmaxf(cnt, 1.0f), (float)a.dims[a.L]));
  if (lane < ADAM_COLS && col < n_params(a))
    adam_update<kCG>(a, e, col, __fmul_rn(s, inv_scale), lr, c1, c2);
  if (chunk == 0 && lane == 0) *loss = __fmul_rn(sse, inv_scale);
}

// The second pass for chunk `chunk` of expert e: lanes 0 .. ADAM_COLS - 1
// take parameters chunk * ADAM_COLS + lane, lanes ADAM_COLS and + 1 the
// masked SSE and the mask count (scratch columns P, P + 1), all in one
// `two_level_sum` over the n_tiles partial rows; then warp 0 scales the
// gradients by inv_scale and applies Adam to params, m and v in place, and
// chunk 0 writes the loss.  scratch: expert e's (n_tiles, S) partials.
// red: 8 * 32 floats.  Every thread must call it.
template <bool kCG>
__device__ __forceinline__ void adam_chunk(const StepArgs& a, int e, int chunk,
                                           const float* scratch, int n_tiles, int S, float* loss,
                                           float lr, float c1, float c2, float* red) {
  const int col = chunk_col(a, chunk);
  const float s = two_level_sum<kCG>(scratch, n_tiles, S, col, col < n_params(a) + 2, red);
  if (threadIdx.x < 32) chunk_adam<kCG>(a, e, chunk, col, s, loss, lr, c1, c2);
}

// adam_chunk by one warp (lanes as there), with `warp_two_level_sum`: the
// same bits.
template <bool kCG>
__device__ __forceinline__ void adam_chunk_warp(const StepArgs& a, int e, int chunk,
                                                const float* scratch, int n_tiles, int S,
                                                float* loss, float lr, float c1, float c2) {
  const int col = chunk_col(a, chunk);
  const float s = warp_two_level_sum<kCG>(scratch, n_tiles, S, col, col < n_params(a) + 2);
  chunk_adam<kCG>(a, e, chunk, col, s, loss, lr, c1, c2);
}

}  // namespace
