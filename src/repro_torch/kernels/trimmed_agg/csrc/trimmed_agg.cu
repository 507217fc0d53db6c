// Per-coordinate trimmed mean of the robust coordinate-wise aggregators
// (trimmed_mean, coord_median) for Hopper (sm_90a), plain fp32 CUDA cores.
//
// Replaces the TPU Pallas kernel sweep_trimmed_aggregate
// (src/repro/kernels/trimmed_agg/trimmed_agg.py, body _trimmed_kernel).
// For every cell s and column d, with k = k_eff[s] and c = c[s]:
//
//   rank_i = #{ j : y[s,j,d] < y[s,i,d]  or  (y[s,j,d] == y[s,i,d] and j < i) }
//   out[s,d] = ( sum_{i : k <= rank_i < c - k} y[s,i,d] ) / max(c - 2k, 1)
//
// The rank is a stable sort's position (ties broken by row index), so the
// band is the sorted column's [k, c - k).  Excluded rows arrive as +inf and
// rank at or past c, outside every band.
//
// What bounds it: the function needs y read once (S n D 4 bytes) and, per
// column, no more work than a sorting network's ~(n/2) log2(n)^2 / 2
// compare-exchanges, so at every shape timed the bytes decide.  This kernel
// counts ranks instead, ~n^2 compares a column, and is several times off
// that bound at n >= 64.  At the round pipeline's shapes (n ~ 10,
// D = 12835) the whole operand is ~0.5 MB and the launch latency dominates.
//
// Design.  The TPU kernel walks rows in a sequential loop over a (n, 2048)
// VMEM tile, counting ranks in f32 vectors.  Here one thread owns one
// (cell, column): grid (ceil(D / 256), S), 256 threads.  The thread takes the
// rows in blocks of kRows = 8 held in registers, i = 0..n-1 in the TPU
// kernel's order, and counts their ranks (ints, exact) in one pass over the
// column, so each load of y_j serves 8 compares.  The tie-break needs no
// compare of its own outside the block: rows j before it count when
// y_j <= y_i, rows after it when y_j < y_i.  Then it adds each y_i of the
// block to its sum, in row order, when rank_i is in the band, else +0.0 as
// the TPU kernel's where() does.  Neighbouring threads hold neighbouring
// columns, so every row load is coalesced across the warp; the column's n
// values are re-read from L1/L2 n/8 times.  No shared memory, no atomics, a
// fixed order: results repeat bit for bit.  The divide is IEEE (no fast
// math).  Cutting the n^2 compares is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // columns per block, one per thread
constexpr int kRows = 8;          // rows ranked per pass over a column

__global__ void __launch_bounds__(kThreads)
trimmed_band_mean(const float* __restrict__ y, const int* __restrict__ k_eff,
                  const int* __restrict__ count, float* __restrict__ out,
                  int n, int d) {
  const int s = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const float* ys = y + (size_t)s * n * d + col;
  const int k = k_eff[s];
  const int hi = count[s] - k;
  float acc = 0.f;
  for (int i0 = 0; i0 < n; i0 += kRows) {
    float yi[kRows];
    int rank[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      yi[r] = i0 + r < n ? __ldg(ys + (size_t)(i0 + r) * d) : 0.f;
      rank[r] = 0;
    }
    const int mid = min(i0 + kRows, n);
    int j = 0;
    for (; j < i0; ++j) {                  // before the block: ties count
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) rank[r] += yj <= yi[r];
    }
    for (; j < mid; ++j) {                 // inside it: tie-break by index
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        rank[r] += (yj < yi[r]) | ((yj == yi[r]) & (j < i0 + r));
    }
    for (; j < n; ++j) {                   // after it: ties do not
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) rank[r] += yj < yi[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < n) acc += (rank[r] >= k && rank[r] < hi) ? yi[r] : 0.f;
  }
  const int den = count[s] - 2 * k;
  out[(size_t)s * d + col] = acc / (float)(den > 1 ? den : 1);
}

}  // namespace

// out (s, d) = band means of y (s, n, d); k_eff, count (s,) int32 on the
// device.  Any d: the last block's threads past d return at once.
extern "C" int trimmed_sweep_aggregate(const float* y, const int* k_eff,
                                       const int* count, float* out, int s,
                                       int n, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  trimmed_band_mean<<<dim3((d + kThreads - 1) / kThreads, s), kThreads, 0, st>>>(
      y, k_eff, count, out, n, d);
  return (int)cudaGetLastError();
}
