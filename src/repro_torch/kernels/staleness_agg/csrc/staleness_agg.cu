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
// Entry points (plain C, loaded with ctypes), each a chain of the kernels
// below on one stream:
//   saa_sweep_fused_apply      partials -> weights -> apply      (Pallas
//                              sweep_fused_staleness_apply; at S = 1 also
//                              fused_staleness_apply)
//   saa_sweep_fused_aggregate  partials -> weights -> aggregate  (Pallas
//                              sweep_fused_staleness_aggregate; at S = 1 also
//                              fused_staleness_aggregate)
//   saa_deviation_partials     partials -> partials_sum          (Pallas
//                              deviation_partials)
//   saa_weighted_aggregate     aggregate on given weights        (Pallas
//                              weighted_aggregate)
//
// What bounds it: memory.  The work is O(S n D) flops on O(S n D) bytes
// (about 8 flops per 4-byte element), far below the card's flop-to-byte
// ratio.  The fused chains must read U twice (the Eq. 2 weights depend on a
// reduction over all of D before any column can be aggregated).  At the
// round pipeline's shapes (n ~ 16, D = 14336) the whole operand is under
// 1 MB and the launches' latency dominates.
//
// Design.  The TPU kernels carry the deviation partials across a
// grid-sequential phase in VMEM accumulators; Hopper blocks run in no order
// and share nothing, so the cross-column reduction becomes separate
// launches on one stream, with no atomics and a fixed summation order
// everywhere (results are bitwise reproducible run to run):
//   1. saa_partials: grid (D / 2048, S).  Each block owns 2048 columns of one
//      cell (256 threads x two float4 loads, coalesced 16-byte accesses),
//      computes u_hat for them, and writes its per-row numerator partials and
//      its denominator partial to scratch (S, nchunks, n) / (S, nchunks).
//      Warp shuffles, then a fixed-order sum over the block's warps.
//   2. saa_weights: grid (S).  One block per cell sums the partials over the
//      chunks in chunk order (sum_partials) and computes the normalised
//      Eq. 2 weights with the rule chosen at run time.  saa_partials_sum is
//      the same chunk-order sum without the weights.
//   3. saa_apply: grid (D / 2048, S).  Each block stages w in shared memory
//      and accumulates sum_i w_i U_i over rows i in fixed order (explicit
//      fused multiply-adds); then it either writes that aggregate to a
//      fresh buffer or adds lr times it to params in place.  The accumulation is one code path for both
//      modes, and the in-place step rounds the product and the sum
//      separately (__fmul_rn, __fadd_rn, no FMA contraction), so the
//      apply mode equals the aggregate mode followed by torch's
//      `params + lr * agg` bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 2048;          // columns per block: 256 threads x 8
constexpr float kEps = 1e-12f;

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

__device__ __forceinline__ float sq_dev(float h, float u, float nf) {
  const float mixed = (u + nf * h) / (nf + 1.f);
  const float d = h - mixed;
  return d * d;
}

// 1. Deviation partials.  Dynamic shared memory: n * kWarps floats.
__global__ void __launch_bounds__(kThreads)
saa_partials(const float* __restrict__ u, const uint8_t* __restrict__ fresh,
             float* __restrict__ num_part, float* __restrict__ den_part,
             int n, int d, int nchunks) {
  extern __shared__ float row_red[];
  __shared__ float red[kWarps];
  const int c = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = c * kCols + threadIdx.x * 4;
  const int col1 = col0 + kCols / 2;
  const uint8_t* fr = fresh + (size_t)s * n;
  const float* us = u + (size_t)s * n * d;

  int nfresh = 0;
  for (int i = 0; i < n; ++i) nfresh += fr[i] ? 1 : 0;
  const float nf = (float)max(nfresh, 1);

  float4 h0 = make_float4(0.f, 0.f, 0.f, 0.f), h1 = h0;
  for (int i = 0; i < n; ++i) {
    if (!fr[i]) continue;
    const float4 a = ld4(us + (size_t)i * d + col0);
    const float4 b = ld4(us + (size_t)i * d + col1);
    h0.x += a.x; h0.y += a.y; h0.z += a.z; h0.w += a.w;
    h1.x += b.x; h1.y += b.y; h1.z += b.z; h1.w += b.w;
  }
  h0.x /= nf; h0.y /= nf; h0.z /= nf; h0.w /= nf;
  h1.x /= nf; h1.y /= nf; h1.z /= nf; h1.w /= nf;

  float den = h0.x * h0.x + h0.y * h0.y + h0.z * h0.z + h0.w * h0.w
            + h1.x * h1.x + h1.y * h1.y + h1.z * h1.z + h1.w * h1.w;
  den = block_sum(den, red);
  if (threadIdx.x == 0) den_part[(size_t)s * nchunks + c] = den;

  for (int i = 0; i < n; ++i) {
    const float4 a = ld4(us + (size_t)i * d + col0);
    const float4 b = ld4(us + (size_t)i * d + col1);
    float p = sq_dev(h0.x, a.x, nf) + sq_dev(h0.y, a.y, nf)
            + sq_dev(h0.z, a.z, nf) + sq_dev(h0.w, a.w, nf)
            + sq_dev(h1.x, b.x, nf) + sq_dev(h1.y, b.y, nf)
            + sq_dev(h1.z, b.z, nf) + sq_dev(h1.w, b.w, nf);
    p = warp_sum(p);
    if (lane == 0) row_red[i * kWarps + warp] = p;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += row_red[i * kWarps + k];
    num_part[((size_t)s * nchunks + c) * n + i] = t;
  }
}

// Cell s's partials summed over the chunks in chunk order: returns den
// (every thread gets it) and writes num_i for the rows i this thread owns
// (i = threadIdx.x, + kThreads, ...) to num[i].
__device__ float sum_partials(const float* __restrict__ num_part,
                              const float* __restrict__ den_part, int s,
                              int n, int nchunks, float* num, float* red) {
  float den = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads)
    den += den_part[(size_t)s * nchunks + c];
  den = block_sum(den, red);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float t = 0.f;
    for (int c = 0; c < nchunks; ++c)
      t += num_part[((size_t)s * nchunks + c) * n + i];
    num[i] = t;
  }
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
      return (1.f - beta) * damp + beta * boost;
    }
  }
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

  const float den = sum_partials(num_part, den_part, s, n, nchunks, lam, red);
  float lmax = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool f = fresh[row0 + i] != 0;
    const float l = f ? 0.f : lam[i] / (den + kEps);
    lam[i] = l;
    if (!f && valid[row0 + i]) lmax = fmaxf(lmax, l);
  }
  lmax = block_max(lmax, red);

  const float b = beta[(size_t)s * beta_stride];
  float wsum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float wi = fresh[row0 + i] ? 1.f
                               : rule_weight(rule, tau[row0 + i], lam[i], lmax, b);
    wi = valid[row0 + i] ? wi : 0.f;
    w[i] = wi;
    wsum += wi;
  }
  wsum = fmaxf(block_sum(wsum, red), kEps);
  for (int i = threadIdx.x; i < n; i += kThreads) w_out[row0 + i] = w[i] / wsum;
}

// Deviation partials of one cell summed over the chunks: num (n,), den ().
__global__ void __launch_bounds__(kThreads)
saa_partials_sum(const float* __restrict__ num_part,
                 const float* __restrict__ den_part, float* __restrict__ num,
                 float* __restrict__ den, int n, int nchunks) {
  __shared__ float red[kWarps];
  const float t = sum_partials(num_part, den_part, 0, n, nchunks, num, red);
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
  const int col0 = c * kCols + threadIdx.x * 4;
  const int col1 = col0 + kCols / 2;
  const float* us = u + (size_t)s * n * d;
  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
  for (int i = 0; i < n; ++i) {
    const float wi = ws[i];
    const float4 a = ld4(us + (size_t)i * d + col0);
    const float4 b = ld4(us + (size_t)i * d + col1);
    a0.x = __fmaf_rn(wi, a.x, a0.x); a0.y = __fmaf_rn(wi, a.y, a0.y);
    a0.z = __fmaf_rn(wi, a.z, a0.z); a0.w = __fmaf_rn(wi, a.w, a0.w);
    a1.x = __fmaf_rn(wi, b.x, a1.x); a1.y = __fmaf_rn(wi, b.y, a1.y);
    a1.z = __fmaf_rn(wi, b.z, a1.z); a1.w = __fmaf_rn(wi, b.w, a1.w);
  }
  if (agg != nullptr) {
    float* as = agg + (size_t)s * d;
    st4(as + col0, a0);
    st4(as + col1, a1);
    return;
  }
  const float lr = scal[2 * s + 1];
  float* ps = params + (size_t)s * d;
  float4 p = ld4(ps + col0), q = ld4(ps + col1);
  p.x = __fadd_rn(p.x, __fmul_rn(lr, a0.x));
  p.y = __fadd_rn(p.y, __fmul_rn(lr, a0.y));
  p.z = __fadd_rn(p.z, __fmul_rn(lr, a0.z));
  p.w = __fadd_rn(p.w, __fmul_rn(lr, a0.w));
  q.x = __fadd_rn(q.x, __fmul_rn(lr, a1.x));
  q.y = __fadd_rn(q.y, __fmul_rn(lr, a1.y));
  q.z = __fadd_rn(q.z, __fmul_rn(lr, a1.z));
  q.w = __fadd_rn(q.w, __fmul_rn(lr, a1.w));
  st4(ps + col0, p);
  st4(ps + col1, q);
}

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

}  // namespace

// Plain C entry points (loaded with ctypes).  The caller checks shapes,
// types, contiguity and 16-byte alignment of every float row operand,
// requires d % 2048 == 0 and 1 <= n <= 1024, and allocates the outputs and
// the scratch: num_part (s, d/2048, n), den_part (s, d/2048).  Each returns
// the first non-zero cudaGetLastError() after a launch, else 0, and does
// not synchronise.

// params (s, d) += scal[s, 1] * (w_s @ U_s) in place; w_out (s, n);
// scal (s, 2) rows (beta, lr).
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

// agg_out (s, d) = w_s @ U_s; w_out (s, n); beta (s,).
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

// One cell: num_out (n,) and den_out () of U (n, d).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  saa_apply<<<dim3(d / kCols, 1), kThreads, (size_t)n * sizeof(float), st>>>(
      nullptr, u, w, nullptr, out, n, d);
  return (int)cudaGetLastError();
}
