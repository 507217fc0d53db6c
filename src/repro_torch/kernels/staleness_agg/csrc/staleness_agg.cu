// Staleness-aware aggregation (SAA, paper Eq. 2) and its server step for
// Hopper (sm_90a), plain fp32 CUDA cores.
//
// Replaces the six TPU Pallas entry points in
// src/repro/kernels/staleness_agg/staleness_agg.py.  For every cell s:
//
//   n_f    = max(sum_i fresh[s,i], 1)             (fresh NOT masked by valid)
//   u_hat  = sum_{i fresh} U[s,i,:] / n_f
//   num_i  = sum_d (u_hat - (U[s,i,d] + n_f u_hat)/(n_f + 1))^2
//   den    = sum_d u_hat^2
//   lam_i  = fresh ? 0 : num_i / (den + EPS)
//   lam_max over stale & valid rows; w_i by the scaling rule, fresh -> 1,
//   invalid -> 0, normalised by max(sum w, EPS)
//   agg[s,:] = sum_i w_i U[s,i,:]
//
// Entry points (plain C, loaded with ctypes):
//   saa_cluster_fused_apply      one launch: partials, weights, apply
//   saa_cluster_fused_aggregate  one launch: partials, weights, aggregate
//                                (the server step at the round pipeline's
//                                shapes: Pallas sweep_fused_staleness_apply,
//                                sweep_fused_staleness_aggregate and, at
//                                S = 1, fused_staleness_apply and
//                                fused_staleness_aggregate)
//   saa_sweep_fused_apply        the same two functions as a chain of three
//   saa_sweep_fused_aggregate    launches: partials -> weights -> apply (the
//                                server step at large D)
//   saa_cluster_deviation_partials
//                                one launch: partials, summed through
//                                distributed shared memory (Pallas
//                                deviation_partials)
//   saa_deviation_partials       the same as a chain: partials ->
//                                partials_sum (at large D)
//   saa_weighted_aggregate       aggregate on given weights, its own
//                                narrow-tiled kernel (Pallas
//                                weighted_aggregate)
//   saa_empty                    one empty block: the launch floor
//
// What bounds it.  The work is O(S n D) flops on O(S n D) bytes (about 8
// flops per 4-byte element), far below the card's flop-to-byte ratio, so
// at large D it is memory.  At the round pipeline's shapes (n ~ 10-16,
// D = 14336: 7 chunks of 2048 columns, U under 1 MB, ~0.0002 ms of bytes)
// it is launch latency: the Eq. 2 weights depend on a reduction over all
// of D before any column can be aggregated, and Hopper blocks run in no
// order and share nothing, so without clusters that reduction costs two
// extra launches (the chain below).
//
// The cluster kernel (saa_cluster), for the Pallas kernels' fused server
// step (sweep_fused_staleness_apply / _aggregate, fused_staleness_apply /
// _aggregate).  One thread block cluster per cell:
// grid (C, S), cluster (C, 1, 1), C <= 8 (the portable cluster size).  Each
// block owns K = ceil(nchunks / 8) consecutive 2048-column chunks (C =
// ceil(nchunks / K), so no block is idle):
//   1. it copies its chunks' rows of U into shared memory once (one 1-D
//      bulk asynchronous copy of 8 KB a row slice, completing on an
//      mbarrier; when n K 8 KB does not fit, it reads U from L2 instead),
//      and leaves each chunk's deviation partials in its shared memory;
//   2. cluster barrier; every block sums all chunks' partials in chunk
//      order through distributed shared memory (map_shared_rank) and forms
//      the weights itself (identical inputs, identical weights); rank 0
//      writes them out;
//   3. every block aggregates (or applies) its own columns from shared
//      memory; a last cluster barrier keeps each block's partials alive
//      until every block has read them.
// So the server step is one launch, U is read from device memory once, and
// there is no scratch in device memory.  What is left at the main shape is
// a chain of latencies inside the launch (staging, the partials' trees,
// two cluster barriers, the weights; chip_smoke.py prints the phases).
// Past 16 chunks (three a block) one cluster of at most 8 SMs streams U
// more slowly than the chain's nchunks blocks, so the wrapper takes the
// chain there (ops.variant).
//
// The partials cluster kernel (saa_partials_cluster, for the Pallas
// deviation_partials) is that kernel's first phase with nothing after it:
// grid (C, 1), cluster (C, 1, 1), the same chunk split; each block streams
// its chunks' rows from device memory once (U is read once, so it is not
// staged) and keeps their partials in its shared memory; after a cluster
// barrier rank 0 fetches every chunk's partials through distributed shared
// memory and sums them in chunk order with saa_partials_sum's code, then
// writes num (n,) and den (); a last cluster barrier keeps each block's
// partials alive until rank 0 has read them.  One launch, no scratch in
// device memory, no atomics; the chain (saa_partials, saa_partials_sum)
// stays past 16 chunks, as for the server step.
//
// The chain: 1. saa_partials, grid (D / 2048, S), writes each chunk's
// partials to scratch (S, nchunks, n) / (S, nchunks); 2. saa_weights, grid
// (S), sums them in chunk order and forms the weights; 3. saa_apply, grid
// (D / 2048, S), reads U again and aggregates or applies.
//
// Bit for bit.  Both variants run the same device functions: the same
// thread-to-column map (256 threads x two float4 a chunk, coalesced 16-byte
// accesses), the same per-chunk trees (warp shuffles, then a fixed-order
// sum over the block's warps), the same chunk-order sums, the same weight
// code and the same rounding of every product and sum (explicit
// intrinsics, so the compiler cannot contract them differently in the two
// kernels); only where U and the partials are read from differs.  So the cluster kernel equals the chain
// bitwise, with no atomics anywhere, and results are reproducible run to
// run.  The accumulation is one code path for both modes, and the in-place
// step rounds the product and the sum separately (__fmul_rn, __fadd_rn, no
// FMA contraction), so the apply mode equals the aggregate mode followed
// by torch's `params + lr * agg` bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 2048;          // columns per chunk: 256 threads x 8
constexpr int kRows = 4;             // rows of U a partials step takes together
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr float kEps = 1e-12f;

// the cluster entry points' own failures (CUDA's errors are positive)
constexpr int kErrNoCluster = -1;    // the cluster cannot be scheduled
constexpr int kErrSharedMem = -2;    // the partials exceed shared memory

enum Rule { kEqual = 0, kDynsgd = 1, kAdasgd = 2, kRelay = 3 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum in a fixed order (lane tree, then warps 0..kWarps-1).
// Every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < kWarps; ++k) t += red[k];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int k = 1; k < kWarps; ++k) t = fmaxf(t, red[k]);
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The arithmetic both variants share rounds every product and sum on its
// own (__fmul_rn, __fadd_rn, explicit __fmaf_rn): the compiler contracts a
// plain `a * b + c` into a fused multiply-add or not by the code around it,
// which differs between the kernels, and the variants must agree bitwise.
// The mix (u + n_f h) / (n_f + 1) multiplies by the rounded reciprocal
// rcp = 1 / (n_f + 1) (within an ulp of the division, and a division per
// element was most of the partials' time).
__device__ __forceinline__ float sq_dev(float h, float u, float nf, float rcp) {
  const float mixed = __fmul_rn(__fadd_rn(u, __fmul_rn(nf, h)), rcp);
  const float d = __fsub_rn(h, mixed);
  return __fmul_rn(d, d);
}

// one row's deviation over this thread's 8 columns, in column order
__device__ __forceinline__ float row_dev(float4 h0, float4 h1, float4 a,
                                         float4 b, float nf, float rcp) {
  float p = sq_dev(h0.x, a.x, nf, rcp);
  p = __fadd_rn(p, sq_dev(h0.y, a.y, nf, rcp));
  p = __fadd_rn(p, sq_dev(h0.z, a.z, nf, rcp));
  p = __fadd_rn(p, sq_dev(h0.w, a.w, nf, rcp));
  p = __fadd_rn(p, sq_dev(h1.x, b.x, nf, rcp));
  p = __fadd_rn(p, sq_dev(h1.y, b.y, nf, rcp));
  p = __fadd_rn(p, sq_dev(h1.z, b.z, nf, rcp));
  return __fadd_rn(p, sq_dev(h1.w, b.w, nf, rcp));
}

__device__ __forceinline__ float sum_sq(float4 a, float4 b) {
  float t = __fmul_rn(a.x, a.x);
  t = __fadd_rn(t, __fmul_rn(a.y, a.y));
  t = __fadd_rn(t, __fmul_rn(a.z, a.z));
  t = __fadd_rn(t, __fmul_rn(a.w, a.w));
  t = __fadd_rn(t, __fmul_rn(b.x, b.x));
  t = __fadd_rn(t, __fmul_rn(b.y, b.y));
  t = __fadd_rn(t, __fmul_rn(b.z, b.z));
  return __fadd_rn(t, __fmul_rn(b.w, b.w));
}

__device__ __forceinline__ float fresh_count(const uint8_t* fr, int n) {
  int nfresh = 0;
  for (int i = 0; i < n; ++i) nfresh += fr[i] ? 1 : 0;
  return (float)max(nfresh, 1);
}

// One chunk's deviation partials.  Row i of the chunk starts at base + i *
// stride (global memory or shared memory alike); this thread owns its
// columns 4t..4t+3 and 1024+4t..+3.  Returns the denominator partial (every
// thread gets it) and writes the per-row numerator partials to num[0..n).
// row_red: n * kWarps floats of shared memory.
__device__ float chunk_partials(const float* base, size_t stride,
                                const uint8_t* fr, int n, float nf,
                                float* row_red, float* red, float* num) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = threadIdx.x * 4, col1 = col0 + kCols / 2;
  float4 h0 = make_float4(0.f, 0.f, 0.f, 0.f), h1 = h0;
  for (int i = 0; i < n; ++i) {
    if (!fr[i]) continue;
    const float4 a = ld4(base + (size_t)i * stride + col0);
    const float4 b = ld4(base + (size_t)i * stride + col1);
    h0.x += a.x; h0.y += a.y; h0.z += a.z; h0.w += a.w;
    h1.x += b.x; h1.y += b.y; h1.z += b.z; h1.w += b.w;
  }
  h0.x /= nf; h0.y /= nf; h0.z /= nf; h0.w /= nf;
  h1.x /= nf; h1.y /= nf; h1.z /= nf; h1.w /= nf;

  const float den = block_sum(sum_sq(h0, h1), red);

  // kRows rows at a time, their warp trees interleaved (each row's sum is
  // the same as alone; the rows' shuffles overlap instead of waiting)
  const float rcp = __fdiv_rn(1.f, nf + 1.f);
  int i = 0;
  for (; i + kRows <= n; i += kRows) {
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      p[r] = row_dev(h0, h1, ld4(base + (size_t)(i + r) * stride + col0),
                     ld4(base + (size_t)(i + r) * stride + col1), nf, rcp);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] += __shfl_down_sync(0xffffffffu, p[r], o);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < kRows; ++r) row_red[(i + r) * kWarps + warp] = p[r];
  }
  for (; i < n; ++i) {
    const float p = warp_sum(row_dev(h0, h1, ld4(base + (size_t)i * stride + col0),
                                     ld4(base + (size_t)i * stride + col1), nf, rcp));
    if (lane == 0) row_red[i * kWarps + warp] = p;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += row_red[i * kWarps + k];
    num[i] = t;
  }
  return den;
}

// Row i's numerator partials summed over the chunks in chunk order, kBatch
// chunks' loads issued together: from device memory a plain loop came out
// of the compiler with each load waiting for the one before it (the chain
// takes 8); from shared memory one at a time (the cluster kernel, where a
// batch cost registers and spilled).  The sum is the same either way.
template <int kBatch, class NumAt>
__device__ __forceinline__ float chunk_order_sum(NumAt num_at, int i,
                                                 int nchunks) {
  float t = 0.f;
  int c = 0;
  for (; c + kBatch <= nchunks; c += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = num_at(c + k, i);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) t += v[k];
  }
  for (; c < nchunks; ++c) t += num_at(c, i);
  return t;
}

// A cell's partials summed over the chunks in chunk order; den_at(c) and
// num_at(c, i) read chunk c's partials wherever they lie.  Returns den
// (every thread gets it) and writes num_i for the rows i this thread owns
// (i = threadIdx.x, + kThreads, ...) to num[i].
template <int kBatch, class DenAt, class NumAt>
__device__ float sum_partials(DenAt den_at, NumAt num_at, int n, int nchunks,
                              float* num, float* red) {
  float den = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) den += den_at(c);
  den = block_sum(den, red);
  for (int i = threadIdx.x; i < n; i += kThreads)
    num[i] = chunk_order_sum<kBatch>(num_at, i, nchunks);
  return den;
}

__device__ float rule_weight(int rule, int tau, float lam, float lam_max,
                             float beta) {
  const float t1 = (float)tau + 1.f;
  switch (rule) {
    case kEqual: return 1.f;
    case kDynsgd: return 1.f / t1;
    case kAdasgd: return expf(-t1);
    default: {
      const float damp = 1.f / t1;
      const float boost = 1.f - expf(-lam / fmaxf(lam_max, kEps));
      return __fadd_rn(__fmul_rn(1.f - beta, damp), __fmul_rn(beta, boost));
    }
  }
}

// The Eq. 2 weights of one cell.  On entry lam[i] holds num_i for the rows
// this thread owns; on return w[i] holds the normalised weight of those
// rows (lam and w: n floats of shared memory each).
__device__ void cell_weights(float den, float* lam, float* w,
                             const uint8_t* fresh, const int* tau,
                             const uint8_t* valid, float beta, int n, int rule,
                             float* red) {
  float lmax = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool f = fresh[i] != 0;
    const float l = f ? 0.f : lam[i] / (den + kEps);
    lam[i] = l;
    if (!f && valid[i]) lmax = fmaxf(lmax, l);
  }
  lmax = block_max(lmax, red);

  float wsum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float wi = fresh[i] ? 1.f : rule_weight(rule, tau[i], lam[i], lmax, beta);
    wi = valid[i] ? wi : 0.f;
    w[i] = wi;
    wsum += wi;
  }
  wsum = fmaxf(block_sum(wsum, red), kEps);
  for (int i = threadIdx.x; i < n; i += kThreads) w[i] = w[i] / wsum;
}

// A cell's normalised Eq. 2 weights into w[0..n) from its chunks' partials
// (den_at(c), num_at(c, i)), summed in chunk order.  When every row and
// every chunk fit in one warp, warp 0 alone does it with warp trees: the
// block-wide trees give the same values there (the other warps contribute
// exact zeros to each sum, and to each maximum of non-negative values),
// without the block barriers.  Either way the caller synchronises before
// other threads read w.
template <int kBatch, class DenAt, class NumAt>
__device__ void partials_to_weights(DenAt den_at, NumAt num_at, int n,
                                    int nchunks, float* lam, float* w,
                                    const uint8_t* fresh, const int* tau,
                                    const uint8_t* valid, float beta, int rule,
                                    float* red) {
  if (n > 32 || nchunks > 32) {
    const float den = sum_partials<kBatch>(den_at, num_at, n, nchunks, lam, red);
    cell_weights(den, lam, w, fresh, tau, valid, beta, n, rule, red);
    return;
  }
  if (threadIdx.x >= 32) return;
  const int i = threadIdx.x;
  float den = 0.f;
  if (i < nchunks) den += den_at(i);
  den = __shfl_sync(0xffffffffu, warp_sum(den), 0);
  float l = 0.f, lmax = 0.f;
  if (i < n) {
    const float t = chunk_order_sum<kBatch>(num_at, i, nchunks);
    l = fresh[i] ? 0.f : t / (den + kEps);
    if (!fresh[i] && valid[i]) lmax = fmaxf(lmax, l);
  }
  lmax = __shfl_sync(0xffffffffu, warp_max(lmax), 0);
  float wi = 0.f, wsum = 0.f;
  if (i < n) {
    wi = fresh[i] ? 1.f : rule_weight(rule, tau[i], l, lmax, beta);
    wi = valid[i] ? wi : 0.f;
    wsum += wi;
  }
  wsum = fmaxf(__shfl_sync(0xffffffffu, warp_sum(wsum), 0), kEps);
  if (i < n) w[i] = wi / wsum;
}

// This thread's columns of one chunk: sum_i ws[i] U[i] over rows i in
// fixed order (explicit fused multiply-adds); rows as in chunk_partials.
// Then the aggregate goes to agg_c (the chunk's first column of the output
// row), or, with agg_c == nullptr, params_c += lr * aggregate in place
// (with loaded: p0, p1 already hold this thread's params_c columns).
__device__ __forceinline__ void chunk_apply(const float* base, size_t stride,
                                            const float* ws, int n,
                                            float* agg_c, float* params_c,
                                            float lr, bool loaded = false,
                                            float4 p0 = float4(),
                                            float4 p1 = float4()) {
  const int col0 = threadIdx.x * 4, col1 = col0 + kCols / 2;
  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
  for (int i = 0; i < n; ++i) {
    const float wi = ws[i];
    const float4 a = ld4(base + (size_t)i * stride + col0);
    const float4 b = ld4(base + (size_t)i * stride + col1);
    a0.x = __fmaf_rn(wi, a.x, a0.x); a0.y = __fmaf_rn(wi, a.y, a0.y);
    a0.z = __fmaf_rn(wi, a.z, a0.z); a0.w = __fmaf_rn(wi, a.w, a0.w);
    a1.x = __fmaf_rn(wi, b.x, a1.x); a1.y = __fmaf_rn(wi, b.y, a1.y);
    a1.z = __fmaf_rn(wi, b.z, a1.z); a1.w = __fmaf_rn(wi, b.w, a1.w);
  }
  if (agg_c != nullptr) {
    st4(agg_c + col0, a0);
    st4(agg_c + col1, a1);
    return;
  }
  float4 p = loaded ? p0 : ld4(params_c + col0);
  float4 q = loaded ? p1 : ld4(params_c + col1);
  p.x = __fadd_rn(p.x, __fmul_rn(lr, a0.x));
  p.y = __fadd_rn(p.y, __fmul_rn(lr, a0.y));
  p.z = __fadd_rn(p.z, __fmul_rn(lr, a0.z));
  p.w = __fadd_rn(p.w, __fmul_rn(lr, a0.w));
  q.x = __fadd_rn(q.x, __fmul_rn(lr, a1.x));
  q.y = __fadd_rn(q.y, __fmul_rn(lr, a1.y));
  q.z = __fadd_rn(q.z, __fmul_rn(lr, a1.z));
  q.w = __fadd_rn(q.w, __fmul_rn(lr, a1.w));
  st4(params_c + col0, p);
  st4(params_c + col1, q);
}

// ---------------------------------------------------------------------------
// The chain
// ---------------------------------------------------------------------------

// 1. Deviation partials.  Dynamic shared memory: n * kWarps floats.
__global__ void __launch_bounds__(kThreads)
saa_partials(const float* __restrict__ u, const uint8_t* __restrict__ fresh,
             float* __restrict__ num_part, float* __restrict__ den_part,
             int n, int d, int nchunks) {
  extern __shared__ float row_red[];
  __shared__ float red[kWarps];
  const int c = blockIdx.x, s = blockIdx.y;
  const uint8_t* fr = fresh + (size_t)s * n;
  const float den = chunk_partials(
      u + (size_t)s * n * d + (size_t)c * kCols, d, fr, n, fresh_count(fr, n),
      row_red, red, num_part + ((size_t)s * nchunks + c) * n);
  if (threadIdx.x == 0) den_part[(size_t)s * nchunks + c] = den;
}

// 2. Eq. 2 weights, one block per cell; cell s's beta is beta[s * stride].
// Dynamic shared memory: 2 n floats.
__global__ void __launch_bounds__(kThreads)
saa_weights(const float* __restrict__ num_part,
            const float* __restrict__ den_part,
            const uint8_t* __restrict__ fresh, const int* __restrict__ tau,
            const uint8_t* __restrict__ valid, const float* __restrict__ beta,
            int beta_stride, float* __restrict__ w_out, int n, int nchunks,
            int rule) {
  extern __shared__ float sm[];
  float* lam = sm;
  float* w = sm + n;
  __shared__ float red[kWarps];
  const int s = blockIdx.x;
  const size_t row0 = (size_t)s * n;
  const float* np = num_part + (size_t)s * nchunks * n;
  const float* dp = den_part + (size_t)s * nchunks;
  partials_to_weights<8>(
      [=](int c) { return __ldg(dp + c); },
      [=](int c, int i) { return __ldg(np + (size_t)c * n + i); }, n, nchunks, lam, w,
      fresh + row0, tau + row0, valid + row0, beta[(size_t)s * beta_stride],
      rule, red);
  for (int i = threadIdx.x; i < n; i += kThreads) w_out[row0 + i] = w[i];
}

// Deviation partials of one cell summed over the chunks: num (n,), den ().
__global__ void __launch_bounds__(kThreads)
saa_partials_sum(const float* __restrict__ num_part,
                 const float* __restrict__ den_part, float* __restrict__ num,
                 float* __restrict__ den, int n, int nchunks) {
  __shared__ float red[kWarps];
  const float t = sum_partials<8>(
      [=](int c) { return __ldg(den_part + c); },
      [=](int c, int i) { return __ldg(num_part + (size_t)c * n + i); }, n,
      nchunks, num, red);
  if (threadIdx.x == 0) *den = t;
}

// 3. Weighted aggregate of each cell's rows.  With agg != nullptr it is
// written to agg (S, D); otherwise params (S, D) += lr_s * aggregate in
// place, lr_s = scal[2 s + 1].  Dynamic shared memory: n floats.
__global__ void __launch_bounds__(kThreads)
saa_apply(float* __restrict__ params, const float* __restrict__ u,
          const float* __restrict__ w, const float* __restrict__ scal,
          float* __restrict__ agg, int n, int d) {
  extern __shared__ float ws[];
  const int c = blockIdx.x, s = blockIdx.y;
  for (int i = threadIdx.x; i < n; i += kThreads) ws[i] = w[(size_t)s * n + i];
  __syncthreads();
  const size_t off = (size_t)s * d + (size_t)c * kCols;
  chunk_apply(u + (size_t)s * n * d + (size_t)c * kCols, d, ws, n,
              agg != nullptr ? agg + off : nullptr,
              agg != nullptr ? nullptr : params + off,
              agg != nullptr ? 0.f : scal[2 * s + 1]);
}

// ---------------------------------------------------------------------------
// The weighted aggregate on given weights (Pallas weighted_aggregate)
// ---------------------------------------------------------------------------

// out (d,) = w @ U on one cell.  One warp a block, four columns a thread:
// 128 columns a block, so D = 14336 gives 112 blocks on the 132 SMs, where
// the chain's saa_apply (2048 columns a block, eight a thread) gives 7.
// kWaggRows rows' loads are issued together before their multiply-adds (of
// 8 and 16 rows, and 1, 2 or 4 columns a thread, tried on the H100, 8 rows
// of four columns held up best from the main shape to n = 64, D = 2^20; 16
// rows took twice the registers and streamed the large shape more slowly).
// Each column's sum is chunk_apply's: __fmaf_rn over rows 0..n-1 in order
// from +0, so the result equals saa_apply's aggregate (and the cluster
// kernel's) bit for bit.
constexpr int kWaggThreads = 32;
constexpr int kWaggCols = 4 * kWaggThreads;
constexpr int kWaggRows = 8;

__global__ void __launch_bounds__(kWaggThreads)
saa_weighted_agg(const float* __restrict__ w, const float* __restrict__ u,
                 float* __restrict__ out, int n, int d) {
  const float* col = u + (size_t)blockIdx.x * kWaggCols + threadIdx.x * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += kWaggRows) {
    float4 r[kWaggRows];
    float wi[kWaggRows];
#pragma unroll
    for (int k = 0; k < kWaggRows; ++k) {
      if (i0 + k < n) {
        r[k] = ld4(col + (size_t)(i0 + k) * d);
        wi[k] = __ldg(w + i0 + k);
      }
    }
#pragma unroll
    for (int k = 0; k < kWaggRows; ++k) {
      if (i0 + k < n) {
        acc.x = __fmaf_rn(wi[k], r[k].x, acc.x);
        acc.y = __fmaf_rn(wi[k], r[k].y, acc.y);
        acc.z = __fmaf_rn(wi[k], r[k].z, acc.z);
        acc.w = __fmaf_rn(wi[k], r[k].w, acc.w);
      }
    }
  }
  st4(out + (size_t)blockIdx.x * kWaggCols + threadIdx.x * 4, acc);
}

// ---------------------------------------------------------------------------
// The cluster kernel
// ---------------------------------------------------------------------------

// Built with -DSAA_PHASE_STAMPS (chip_smoke.py does, into a copy of the
// library), block x of cell 0 records the device clock (%globaltimer, ns)
// at each phase boundary k of saa_cluster; saa_phase_stamps reads them.
constexpr int kStamps = 9;
#ifdef SAA_PHASE_STAMPS
__device__ unsigned long long g_stamps[kMaxCluster][kStamps];
#define SAA_STAMP(k)                                                      \
  do {                                                                    \
    if (threadIdx.x == 0 && blockIdx.y == 0) {                            \
      unsigned long long t_;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) :: "memory");  \
      g_stamps[blockIdx.x][k] = t_;                                       \
    }                                                                     \
  } while (0)
#else
#define SAA_STAMP(k) do {} while (0)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The cluster barrier in two halves: arrive (this block is done reading
// the others' shared memory) and wait.  The arrive is relaxed: every value
// read from another block was stored into this block's shared memory
// before it, so each read has returned before the arrive issues.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory of one block, in floats: [U: K n kCols, if resident]
// [num partials: K n][den partials: K][row_red: n kWarps][lam: n][w: n]
// [all chunks' partials: nchunks (n + 1)][tau: n][fresh, valid: 2 n bytes].
__host__ __device__ __forceinline__ size_t cluster_floats(int per, int nchunks,
                                                          int n, bool resident) {
  return (resident ? (size_t)per * n * kCols : 0) + (size_t)per * (n + 1)
         + (size_t)n * kWarps + 2 * (size_t)n + (size_t)nchunks * (n + 1)
         + (size_t)n + ((size_t)n + 1) / 2;
}

// One cell per cluster (grid (C, S), cluster (C, 1, 1)); block rank r owns
// chunks [r K, min(r K + K, nchunks)).  beta_s = beta[s * beta_stride];
// with agg != nullptr the aggregate goes to agg (S, D), otherwise params
// (S, D) += scal[2 s + 1] * aggregate in place.  resident: U's rows of the
// block's chunks are staged in shared memory, else read from L2.
__global__ void __launch_bounds__(kThreads)
saa_cluster(float* __restrict__ params, const float* __restrict__ u,
            const uint8_t* __restrict__ fresh, const int* __restrict__ tau,
            const uint8_t* __restrict__ valid, const float* __restrict__ beta,
            int beta_stride, const float* __restrict__ scal,
            float* __restrict__ w_out, float* __restrict__ agg, int n, int d,
            int per, int resident, int rule) {
  extern __shared__ __align__(128) float sm[];
  __shared__ float red[kWarps];
  __shared__ __align__(8) uint64_t bar;
  SAA_STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), s = blockIdx.y;
  const int nchunks = d / kCols;
  const int c0 = rank * per, c1 = min(c0 + per, nchunks);
  float* u_sm = sm;
  float* part_num = sm + (resident ? (size_t)per * n * kCols : 0);
  float* part_den = part_num + (size_t)per * n;
  float* row_red = part_den + per;
  float* lam = row_red + (size_t)n * kWarps;
  float* w = lam + n;
  float* all = w + n;               // chunk c's partials: all[c (n + 1) ..]
  int* tau_s = reinterpret_cast<int*>(all + (size_t)nchunks * (n + 1));
  uint8_t* fr_s = reinterpret_cast<uint8_t*>(tau_s + n);
  uint8_t* va_s = fr_s + n;
  const size_t row0 = (size_t)s * n;
  const float* us = u + row0 * d;
  const int col0 = threadIdx.x * 4;

  // 1. the block's rows of U into shared memory; meanwhile the cell's
  // masks, its scalars and this thread's first params, then the partials
  const uint32_t b = smem_u32(&bar);
  if (resident && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t bytes = (uint32_t)((c1 - c0) * n * kCols * sizeof(float));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    for (int c = c0; c < c1; ++c)
      for (int i = 0; i < n; ++i)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(u_sm + ((size_t)(c - c0) * n + i) * kCols)),
               "l"(reinterpret_cast<uint64_t>(us + (size_t)i * d + (size_t)c * kCols)),
               "r"((uint32_t)(kCols * sizeof(float))), "r"(b)
            : "memory");
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    fr_s[i] = fresh[row0 + i];
    va_s[i] = valid[row0 + i];
    tau_s[i] = tau[row0 + i];
  }
  const float beta_s = beta[(size_t)s * beta_stride];
  const float lr = agg != nullptr ? 0.f : scal[2 * s + 1];
  float4 p0 = float4(), p1 = float4();
  if (agg == nullptr) {
    const float* pc = params + (size_t)s * d + (size_t)c0 * kCols;
    p0 = ld4(pc + col0);
    p1 = ld4(pc + col0 + kCols / 2);
  }
  __syncthreads();                 // the masks and the barrier are in place
  if (resident) mbar_wait(b, 0);
  SAA_STAMP(1);
  const float nf = fresh_count(fr_s, n);
  SAA_STAMP(2);
  for (int c = c0; c < c1; ++c) {
    const float* base = resident ? u_sm + (size_t)(c - c0) * n * kCols
                                 : us + (size_t)c * kCols;
    const float den = chunk_partials(base, resident ? kCols : d, fr_s, n, nf,
                                     row_red, red, part_num + (size_t)(c - c0) * n);
    if (threadIdx.x == 0) part_den[c - c0] = den;
  }
  SAA_STAMP(3);
  cluster.sync();                  // every chunk's partials are in place
  SAA_STAMP(4);

  // 2. all chunks' partials, fetched at once from the blocks that own them,
  // then summed in chunk order
  for (int k = threadIdx.x; k < nchunks * (n + 1); k += kThreads) {
    const int c = k / (n + 1), i = k % (n + 1);
    const int at = c % per;
    all[k] = i < n ? cluster.map_shared_rank(part_num, c / per)[(size_t)at * n + i]
                   : cluster.map_shared_rank(part_den, c / per)[at];
  }
  cluster_arrive();                // done with the other blocks' memory
  __syncthreads();                 // every chunk's partials are in all
  SAA_STAMP(5);
  partials_to_weights<1>(
      [&](int c) { return all[(size_t)c * (n + 1) + n]; },
      [&](int c, int i) { return all[(size_t)c * (n + 1) + i]; }, n, nchunks,
      lam, w, fr_s, tau_s, va_s, beta_s, rule, red);
  if (rank == 0)
    for (int i = threadIdx.x; i < n; i += kThreads) w_out[row0 + i] = w[i];
  __syncthreads();                 // every row's weight is in w
  SAA_STAMP(6);

  // 3. the block's own columns
  for (int c = c0; c < c1; ++c) {
    const size_t off = (size_t)s * d + (size_t)c * kCols;
    chunk_apply(resident ? u_sm + (size_t)(c - c0) * n * kCols
                         : us + (size_t)c * kCols,
                resident ? kCols : d, w, n,
                agg != nullptr ? agg + off : nullptr,
                agg != nullptr ? nullptr : params + off, lr,
                agg == nullptr && c == c0, p0, p1);
  }
  SAA_STAMP(7);
  cluster_wait();                  // no block leaves while another reads it
  SAA_STAMP(8);
}

// Shared memory of one block of saa_partials_cluster, in floats: [num
// partials: K n][den partials: K][row_red: n kWarps][all chunks' partials:
// nchunks (n + 1), read by rank 0 only].
__host__ __device__ __forceinline__ size_t partials_cluster_floats(int per,
                                                                   int nchunks,
                                                                   int n) {
  return (size_t)per * (n + 1) + (size_t)n * kWarps + (size_t)nchunks * (n + 1);
}

// One cell's deviation partials in one cluster (grid (C, 1), cluster (C, 1,
// 1)); block rank r owns chunks [r K, min(r K + K, nchunks)).  Each chunk's
// partials are chunk_partials' (as saa_partials'); rank 0 sums them in
// chunk order with sum_partials (as saa_partials_sum), so num and den equal
// the chain's bit for bit.
__global__ void __launch_bounds__(kThreads)
saa_partials_cluster(const float* __restrict__ u,
                     const uint8_t* __restrict__ fresh, float* __restrict__ num,
                     float* __restrict__ den, int n, int d, int per) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nchunks = d / kCols;
  const int c0 = rank * per, c1 = min(c0 + per, nchunks);
  float* part_num = sm;
  float* part_den = part_num + (size_t)per * n;
  float* row_red = part_den + per;
  float* all = row_red + (size_t)n * kWarps;

  const float nf = fresh_count(fresh, n);
  for (int c = c0; c < c1; ++c) {
    const float dn = chunk_partials(u + (size_t)c * kCols, d, fresh, n, nf,
                                    row_red, red, part_num + (size_t)(c - c0) * n);
    if (threadIdx.x == 0) part_den[c - c0] = dn;
  }
  cluster.sync();                  // every chunk's partials are in place
  if (rank == 0)                   // fetched at once from their owners
    for (int k = threadIdx.x; k < nchunks * (n + 1); k += kThreads) {
      const int c = k / (n + 1), i = k % (n + 1);
      const int at = c % per;
      all[k] = i < n ? cluster.map_shared_rank(part_num, c / per)[(size_t)at * n + i]
                     : cluster.map_shared_rank(part_den, c / per)[at];
    }
  cluster_arrive();                // rank 0 is done with the others' memory
  if (rank == 0) {
    __syncthreads();               // every chunk's partials are in all
    const float t = sum_partials<1>(
        [=](int c) { return all[(size_t)c * (n + 1) + n]; },
        [=](int c, int i) { return all[(size_t)c * (n + 1) + i]; }, n, nchunks,
        num, red);
    if (threadIdx.x == 0) *den = t;
  }
  cluster_wait();                  // no block leaves while rank 0 reads it
}

__global__ void saa_empty_kernel() {}

#define SAA_RETURN_IF_FAILED()                         \
  do {                                                 \
    const cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;             \
  } while (0)

// partials then weights, shared by the two fused chains
int launch_weights(const float* u, const uint8_t* fresh, const int* tau,
                   const uint8_t* valid, const float* beta, int beta_stride,
                   float* w_out, float* num_part, float* den_part, int s,
                   int n, int d, int rule, cudaStream_t st) {
  const int nchunks = d / kCols;
  saa_partials<<<dim3(nchunks, s), kThreads, (size_t)n * kWarps * sizeof(float), st>>>(
      u, fresh, num_part, den_part, n, d, nchunks);
  SAA_RETURN_IF_FAILED();
  saa_weights<<<s, kThreads, (size_t)2 * n * sizeof(float), st>>>(
      num_part, den_part, fresh, tau, valid, beta, beta_stride, w_out, n,
      nchunks, rule);
  SAA_RETURN_IF_FAILED();
  return 0;
}

// Per cluster kernel and device: the shared memory a block may take (set
// once as the kernel's limit), and per (cluster size, shared memory)
// whether such a cluster can be scheduled at all
// (cudaOccupancyMaxActiveClusters, asked once per configuration).
constexpr int kMaxDevices = 64;
constexpr int kMaxConfigs = 64;
struct ClusterConfig { int csize; size_t smem; bool ok; };
struct DeviceState {
  bool ready = false;
  int err = 0;
  size_t budget = 0;
  int nconfigs = 0;
  ClusterConfig configs[kMaxConfigs];
};
enum ClusterKernel { kServerStep = 0, kPartials = 1 };
DeviceState g_devices[2][kMaxDevices];
std::mutex g_mutex;

int cluster_budget(const void* func, DeviceState& ds, int dev, size_t* budget) {
  if (!ds.ready) {
    int optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, func);
    if (e == cudaSuccess) {
      ds.budget = (size_t)optin - fa.sharedSizeBytes;
      e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ds.budget);
    }
    ds.err = (int)e;
    ds.ready = true;
  }
  *budget = ds.budget;
  return ds.err;
}

int cluster_ok(const void* func, DeviceState& ds, const cudaLaunchConfig_t& cfg,
               int csize, bool* ok) {
  for (int k = 0; k < ds.nconfigs; ++k)
    if (ds.configs[k].csize == csize && ds.configs[k].smem == cfg.dynamicSmemBytes) {
      *ok = ds.configs[k].ok;
      return 0;
    }
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, func, &cfg);
  if (e != cudaSuccess) return (int)e;
  *ok = clusters > 0;
  if (ds.nconfigs < kMaxConfigs)
    ds.configs[ds.nconfigs++] = {csize, cfg.dynamicSmemBytes, *ok};
  return 0;
}

// The launch configuration of a cluster kernel over nchunks chunks of S
// cells: K = ceil(nchunks / 8) chunks a block, C = ceil(nchunks / K) blocks
// a cluster.  Returns the current device (or a CUDA error, negated, below 0).
int cluster_config(int nchunks, int s, cudaStream_t st, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, int* per) {
  *per = (nchunks + kMaxCluster - 1) / kMaxCluster;
  const int csize = (nchunks + *per - 1) / *per;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(csize, s);
  cfg->blockDim = dim3(kThreads);
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return dev;
}

int launch_cluster(float* params, const float* u, const uint8_t* fresh,
                   const int* tau, const uint8_t* valid, const float* beta,
                   int beta_stride, const float* scal, float* w_out,
                   float* agg, int s, int n, int d, int rule, cudaStream_t st) {
  const int nchunks = d / kCols;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int per = 0;
  const int dev = cluster_config(nchunks, s, st, &cfg, attr, &per);
  if (dev < 0) return -dev;
  const void* func = (const void*)saa_cluster;
  DeviceState& ds = g_devices[kServerStep][dev];
  bool ok = false;
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    size_t budget = 0;
    int err = cluster_budget(func, ds, dev, &budget);
    if (err) return err;
    const size_t full = cluster_floats(per, nchunks, n, true) * sizeof(float);
    const size_t lean = cluster_floats(per, nchunks, n, false) * sizeof(float);
    if (lean > budget) return kErrSharedMem;
    resident = full <= budget;
    cfg.dynamicSmemBytes = resident ? full : lean;
    err = cluster_ok(func, ds, cfg, attr[0].val.clusterDim.x, &ok);
    if (err) return err;
  }
  if (!ok) return kErrNoCluster;
  return (int)cudaLaunchKernelEx(&cfg, saa_cluster, params, u, fresh, tau,
                                 valid, beta, beta_stride, scal, w_out, agg,
                                 n, d, per, resident, rule);
}

int launch_partials_cluster(const float* u, const uint8_t* fresh, float* num,
                            float* den, int n, int d, cudaStream_t st) {
  const int nchunks = d / kCols;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int per = 0;
  const int dev = cluster_config(nchunks, 1, st, &cfg, attr, &per);
  if (dev < 0) return -dev;
  const void* func = (const void*)saa_partials_cluster;
  DeviceState& ds = g_devices[kPartials][dev];
  bool ok = false;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    size_t budget = 0;
    int err = cluster_budget(func, ds, dev, &budget);
    if (err) return err;
    cfg.dynamicSmemBytes = partials_cluster_floats(per, nchunks, n) * sizeof(float);
    if (cfg.dynamicSmemBytes > budget) return kErrSharedMem;
    err = cluster_ok(func, ds, cfg, attr[0].val.clusterDim.x, &ok);
    if (err) return err;
  }
  if (!ok) return kErrNoCluster;
  return (int)cudaLaunchKernelEx(&cfg, saa_partials_cluster, u, fresh, num, den,
                                 n, d, per);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The caller checks shapes,
// types, contiguity and 16-byte alignment of every float row operand,
// requires d % 2048 == 0 and 1 <= n <= 1024, and allocates the outputs and,
// for the chains, the scratch: num_part (s, d/2048, n), den_part (s,
// d/2048).  Each returns the first non-zero CUDA error of a launch, else 0,
// and does not synchronise; the cluster entry points return -1 when the
// card cannot schedule the cluster and -2 when n is too large for its
// shared memory.

// params (s, d) += scal[s, 1] * (w_s @ U_s) in place; w_out (s, n);
// scal (s, 2) rows (beta, lr).  One launch.
extern "C" int saa_cluster_fused_apply(float* params, const float* u,
                                       const uint8_t* fresh, const int* tau,
                                       const uint8_t* valid, const float* scal,
                                       float* w_out, int s, int n, int d,
                                       int rule, void* stream) {
  return launch_cluster(params, u, fresh, tau, valid, scal, 2, scal, w_out,
                        nullptr, s, n, d, rule, static_cast<cudaStream_t>(stream));
}

// agg_out (s, d) = w_s @ U_s; w_out (s, n); beta (s,).  One launch.
extern "C" int saa_cluster_fused_aggregate(const float* u, const uint8_t* fresh,
                                           const int* tau, const uint8_t* valid,
                                           const float* beta, float* w_out,
                                           float* agg_out, int s, int n, int d,
                                           int rule, void* stream) {
  return launch_cluster(nullptr, u, fresh, tau, valid, beta, 1, nullptr,
                        w_out, agg_out, s, n, d, rule,
                        static_cast<cudaStream_t>(stream));
}

// As saa_cluster_fused_apply, as a chain of three launches.
extern "C" int saa_sweep_fused_apply(float* params, const float* u,
                                     const uint8_t* fresh, const int* tau,
                                     const uint8_t* valid, const float* scal,
                                     float* w_out, float* num_part,
                                     float* den_part, int s, int n, int d,
                                     int rule, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_weights(u, fresh, tau, valid, scal, 2, w_out,
                                 num_part, den_part, s, n, d, rule, st);
  if (err) return err;
  saa_apply<<<dim3(d / kCols, s), kThreads, (size_t)n * sizeof(float), st>>>(
      params, u, w_out, scal, nullptr, n, d);
  return (int)cudaGetLastError();
}

// As saa_cluster_fused_aggregate, as a chain of three launches.
extern "C" int saa_sweep_fused_aggregate(const float* u, const uint8_t* fresh,
                                         const int* tau, const uint8_t* valid,
                                         const float* beta, float* w_out,
                                         float* agg_out, float* num_part,
                                         float* den_part, int s, int n, int d,
                                         int rule, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_weights(u, fresh, tau, valid, beta, 1, w_out,
                                 num_part, den_part, s, n, d, rule, st);
  if (err) return err;
  saa_apply<<<dim3(d / kCols, s), kThreads, (size_t)n * sizeof(float), st>>>(
      nullptr, u, w_out, nullptr, agg_out, n, d);
  return (int)cudaGetLastError();
}

// One cell: num_out (n,) and den_out () of U (n, d).  One launch.
extern "C" int saa_cluster_deviation_partials(const float* u,
                                              const uint8_t* fresh,
                                              float* num_out, float* den_out,
                                              int n, int d, void* stream) {
  return launch_partials_cluster(u, fresh, num_out, den_out, n, d,
                                 static_cast<cudaStream_t>(stream));
}

// As saa_cluster_deviation_partials, as a chain of two launches.
extern "C" int saa_deviation_partials(const float* u, const uint8_t* fresh,
                                      float* num_out, float* den_out,
                                      float* num_part, float* den_part, int n,
                                      int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = d / kCols;
  saa_partials<<<dim3(nchunks, 1), kThreads, (size_t)n * kWarps * sizeof(float), st>>>(
      u, fresh, num_part, den_part, n, d, nchunks);
  SAA_RETURN_IF_FAILED();
  saa_partials_sum<<<1, kThreads, 0, st>>>(num_part, den_part, num_out,
                                           den_out, n, nchunks);
  return (int)cudaGetLastError();
}

// One cell: out (d,) = w @ U on given weights w (n,).
extern "C" int saa_weighted_aggregate(const float* w, const float* u,
                                      float* out, int n, int d, void* stream) {
  saa_weighted_agg<<<d / kWaggCols, kWaggThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(w, u, out, n, d);
  return (int)cudaGetLastError();
}

#ifdef SAA_PHASE_STAMPS
// The last saa_cluster launch's stamps of cell 0: out[kMaxCluster][kStamps].
extern "C" int saa_phase_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
#endif

// One empty block of 32 threads: the least a launch on this path costs.
extern "C" int saa_empty(void* stream) {
  saa_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
