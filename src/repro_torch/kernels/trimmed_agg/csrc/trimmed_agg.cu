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
// The rank is a stable sort's position (ties broken by row index; -0.0 and
// +0.0 compare equal and tie), so the band is the sorted column's [k, c - k).
// Excluded rows arrive as +inf and rank at or past c, outside every band; y
// holds no NaN (the robust layer turns NaN into +inf).  The sum runs over
// the rows in row order, adding +0.0 for a row outside the band, as the
// Pallas kernel's fori_loop does; the divide is IEEE (no fast math).
//
// What bounds it: y read once (S n D 4 bytes) and, per column, no more work
// than a sorting network's ~(n/2) log2(n)^2 / 2 compare-exchanges; at every
// shape timed the bytes decide.  At the round pipeline's shapes (n ~ 10,
// D = 12835, ~0.5 MB) the whole operand is a few DRAM round trips: latency.
//
// Three variants of one function, equal bit for bit (the same band, the
// same row-order sum); the wrapper picks by n (ops.variant):
//
//   regs  (n <= 16)  One thread a column, blocks of 64 columns (201 blocks at
//                    D = 12835).  The thread loads its whole column into
//                    registers at once (one DRAM round trip; P = 8 or 16
//                    slots, rows past n read as +inf), counts every row's
//                    rank from registers (P^2 compares, all unrolled) and
//                    sums the band in row order.
//   sort  (n <= 1024) T = P / 32 threads a column (lanes of one warp), each
//                    holding 32 rows: a bitonic network over the column's P
//                    values (32-value networks in registers, cross-thread
//                    stages by warp shuffles), values only.  The sorted
//                    column gives the band's two ends, v_lo = sorted[k] and
//                    v_hi = sorted[c-k-1], and L_lo, L_hi, the counts of
//                    values below each.  A row strictly between them is in
//                    the band; a row equal to an end has rank L + (rows
//                    before it equal to that end), counted by a prefix over
//                    the T threads.  Then the T threads add their masked
//                    rows in row order, one after another.  Padding rows
//                    (+inf, row index >= n) sort after every real +inf.
//   rank  (any n)    The first port's kernel: one thread a column (blocks
//                    of 256), ranks by ~n^2 compares with the column re-read
//                    from L1/L2 n/8 times.  It is the variant past the sort's
//                    1024 rows.
//
// No shared memory, no atomics, a fixed order: results repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float band_divisor(int count, int k) {
  const int den = count - 2 * k;
  return (float)(den > 1 ? den : 1);
}

// ---------------------------------------------------------------------------
// rank: the column re-read, ranks counted by compares
// ---------------------------------------------------------------------------

constexpr int kRankThreads = 256;     // columns per block, one per thread
constexpr int kRankRows = 8;          // rows ranked per pass over a column

__global__ void __launch_bounds__(kRankThreads)
trimmed_band_mean(const float* __restrict__ y, const int* __restrict__ k_eff,
                  const int* __restrict__ count, float* __restrict__ out,
                  int n, int d) {
  const int s = blockIdx.y;
  const int col = blockIdx.x * kRankThreads + threadIdx.x;
  if (col >= d) return;
  const float* ys = y + (size_t)s * n * d + col;
  const int k = k_eff[s];
  const int hi = count[s] - k;
  float acc = 0.f;
  for (int i0 = 0; i0 < n; i0 += kRankRows) {
    float yi[kRankRows];
    int rank[kRankRows];
#pragma unroll
    for (int r = 0; r < kRankRows; ++r) {
      yi[r] = i0 + r < n ? __ldg(ys + (size_t)(i0 + r) * d) : 0.f;
      rank[r] = 0;
    }
    const int mid = min(i0 + kRankRows, n);
    int j = 0;
    for (; j < i0; ++j) {                  // before the block: ties count
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRankRows; ++r) rank[r] += yj <= yi[r];
    }
    for (; j < mid; ++j) {                 // inside it: tie-break by index
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRankRows; ++r)
        rank[r] += (yj < yi[r]) | ((yj == yi[r]) & (j < i0 + r));
    }
    for (; j < n; ++j) {                   // after it: ties do not
      const float yj = __ldg(ys + (size_t)j * d);
#pragma unroll
      for (int r = 0; r < kRankRows; ++r) rank[r] += yj < yi[r];
    }
#pragma unroll
    for (int r = 0; r < kRankRows; ++r)
      if (i0 + r < n) acc += (rank[r] >= k && rank[r] < hi) ? yi[r] : 0.f;
  }
  out[(size_t)s * d + col] = acc / band_divisor(count[s], k);
}

// ---------------------------------------------------------------------------
// regs: the column in registers, ranks from registers
// ---------------------------------------------------------------------------

constexpr int kRegsThreads = 64;

template <int P>
__global__ void __launch_bounds__(kRegsThreads)
trimmed_regs(const float* __restrict__ y, const int* __restrict__ k_eff,
             const int* __restrict__ count, float* __restrict__ out, int n,
             int d) {
  const int s = blockIdx.y;
  const int col = blockIdx.x * kRegsThreads + threadIdx.x;
  if (col >= d) return;
  const float* ys = y + (size_t)s * n * d + col;
  float v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = i < n ? __ldg(ys + (size_t)i * d) : pos_inf();
  const int k = k_eff[s];
  const int hi = count[s] - k;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j < i) r += v[j] <= v[i];        // rows before i: ties count
      if (j > i) r += v[j] < v[i];         // rows after it: they do not
    }
    if (i < n) acc += (r >= k && r < hi) ? v[i] : 0.f;
  }
  out[(size_t)s * d + col] = acc / band_divisor(count[s], k);
}

// ---------------------------------------------------------------------------
// sort: a bitonic network over T threads a column, 32 values a thread
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kE = 32;                // values a thread holds
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cmpx(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// v (kE values of this thread) in ascending order: the bitonic network in
// its flip form (at each size, compare e with its mirror e ^ (size - 1),
// then the half-cleaners e ^ j), every comparison ascending.
__device__ __forceinline__ void sort_thread(float (&v)[kE]) {
#pragma unroll
  for (int size = 2; size <= kE; size <<= 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (!(e & (size >> 1))) cmpx(v[e], v[e ^ (size - 1)]);
#pragma unroll
    for (int j = size >> 2; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (!(e & j)) cmpx(v[e], v[e ^ j]);
    }
  }
}

// the in-thread half-cleaners j = 16 .. 1 of a size past kE
__device__ __forceinline__ void clean_thread(float (&v)[kE]) {
#pragma unroll
  for (int j = kE >> 1; j > 0; j >>= 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (!(e & j)) cmpx(v[e], v[e ^ j]);
  }
}

// lower ? min : max, the two ends of a cross-thread compare-exchange
__device__ __forceinline__ float keep(bool lower, float mine, float theirs) {
  return lower ? fminf(mine, theirs) : fmaxf(mine, theirs);
}

template <int T>
__device__ __forceinline__ int segment_sum(int x) {
#pragma unroll
  for (int o = 1; o < T; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// Threads t = 0..T-1 of a column are T neighbouring lanes (threadIdx.x =
// column * T + t); thread t holds rows t * 32 + e, e = 0..31.
template <int T>
__global__ void __launch_bounds__(kSortThreads)
trimmed_sort(const float* __restrict__ y, const int* __restrict__ k_eff,
             const int* __restrict__ count, float* __restrict__ out, int n,
             int d) {
  constexpr int kCols = kSortThreads / T;
  const int s = blockIdx.y;
  const int t = threadIdx.x % T;
  const int col = blockIdx.x * kCols + threadIdx.x / T;
  // every lane stays for the shuffles; a column past d reads column 0
  const float* ys = y + (size_t)s * n * d + (col < d ? col : 0);
  float x[kE], v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int row = t * kE + e;
    x[e] = row < n ? __ldg(ys + (size_t)row * d) : pos_inf();
    v[e] = x[e];
  }
  const int k = k_eff[s], c = count[s];
  const int lo = max(k, 0), hi = min(c - k, n);    // the band [lo, hi)

  // 1. sort the column: each thread's 32 values, then the sizes past 32
  sort_thread(v);
#pragma unroll
  for (int size = 2 * kE; size <= kE * T; size <<= 1) {
    {   // mirror: thread t ^ (size/32 - 1), element e with element 31 - e
      const int m = size / kE - 1;
      const bool lower = !(t & (size / (2 * kE)));
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const float a = __shfl_xor_sync(kAll, v[kE - 1 - e], m);
        const float b = __shfl_xor_sync(kAll, v[e], m);
        v[e] = keep(lower, v[e], a);
        v[kE - 1 - e] = keep(lower, v[kE - 1 - e], b);
      }
    }
#pragma unroll
    for (int j = size >> 2; j >= kE; j >>= 1) {    // half-cleaners across threads
      const bool lower = !(t & (j / kE));
#pragma unroll
      for (int e = 0; e < kE; ++e)
        v[e] = keep(lower, v[e], __shfl_xor_sync(kAll, v[e], j / kE));
    }
    clean_thread(v);
  }

  // 2. the band's ends and the counts of values below them
  float acc = 0.f;
  if (hi > lo) {
    float mine_lo = 0.f, mine_hi = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      mine_lo = e == (lo % kE) ? v[e] : mine_lo;
      mine_hi = e == ((hi - 1) % kE) ? v[e] : mine_hi;
    }
    const float v_lo = __shfl_sync(kAll, mine_lo, lo / kE, T);
    const float v_hi = __shfl_sync(kAll, mine_hi, (hi - 1) / kE, T);
    int below_lo = 0, below_hi = 0, eq_lo = 0, eq_hi = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      below_lo += v[e] < v_lo;
      below_hi += v[e] < v_hi;
      eq_lo += x[e] == v_lo;
      eq_hi += x[e] == v_hi;
    }
    const int l_lo = segment_sum<T>(below_lo), l_hi = segment_sum<T>(below_hi);
    // rows of the threads before this one equal to each end
    int pre_lo = eq_lo, pre_hi = eq_hi;
#pragma unroll
    for (int o = 1; o < T; o <<= 1) {
      const int a = __shfl_up_sync(kAll, pre_lo, o, T);
      const int b = __shfl_up_sync(kAll, pre_hi, o, T);
      if (t >= o) {
        pre_lo += a;
        pre_hi += b;
      }
    }
    int seen_lo = pre_lo - eq_lo, seen_hi = pre_hi - eq_hi;
    // 3. this thread's rows, masked: in the band or +0.0
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float xv = x[e];
      bool in;
      if (xv == v_lo) {
        const int r = l_lo + seen_lo++;
        in = r >= lo && r < hi;
      } else if (xv == v_hi) {
        const int r = l_hi + seen_hi++;
        in = r >= lo && r < hi;
      } else {
        in = v_lo < xv && xv < v_hi;
      }
      v[e] = in ? xv : 0.f;
    }
    // 4. the sum in row order: thread 0's rows, then thread 1's, ...
#pragma unroll
    for (int q = 0; q < T; ++q) {
      if (t == q) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          if (q * kE + e < n) acc += v[e];
      }
      acc = __shfl_sync(kAll, acc, q, T);
    }
  }
  if (t == 0 && col < d) out[(size_t)s * d + col] = acc / band_divisor(c, k);
}

template <int P>
int launch_regs(const float* y, const int* k_eff, const int* count, float* out,
                int s, int n, int d, cudaStream_t st) {
  trimmed_regs<P><<<dim3((d + kRegsThreads - 1) / kRegsThreads, s), kRegsThreads,
                    0, st>>>(y, k_eff, count, out, n, d);
  return (int)cudaGetLastError();
}

template <int T>
int launch_sort(const float* y, const int* k_eff, const int* count, float* out,
                int s, int n, int d, cudaStream_t st) {
  constexpr int kCols = kSortThreads / T;
  trimmed_sort<T><<<dim3((d + kCols - 1) / kCols, s), kSortThreads, 0, st>>>(
      y, k_eff, count, out, n, d);
  return (int)cudaGetLastError();
}

constexpr int kErrRows = -1;          // n outside the variant's range

}  // namespace

// Plain C entry points (loaded with ctypes), one per variant.  out (s, d) =
// band means of y (s, n, d), contiguous; k_eff, count (s,) int32 on the
// device.  Any d: threads past d write nothing.  Each returns the launch's
// CUDA error, or -1 when n lies outside the variant's range, and does not
// synchronise.

extern "C" int trimmed_rank_aggregate(const float* y, const int* k_eff,
                                      const int* count, float* out, int s,
                                      int n, int d, void* stream) {
  if (n < 1) return kErrRows;
  trimmed_band_mean<<<dim3((d + kRankThreads - 1) / kRankThreads, s),
                      kRankThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, k_eff, count, out, n, d);
  return (int)cudaGetLastError();
}

// 1 <= n <= 16 (at n = 32 the P^2 compares lose to the sort)
extern "C" int trimmed_regs_aggregate(const float* y, const int* k_eff,
                                      const int* count, float* out, int s,
                                      int n, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return kErrRows;
  if (n <= 8) return launch_regs<8>(y, k_eff, count, out, s, n, d, st);
  if (n <= 16) return launch_regs<16>(y, k_eff, count, out, s, n, d, st);
  return kErrRows;
}

// 1 <= n <= 1024
extern "C" int trimmed_sort_aggregate(const float* y, const int* k_eff,
                                      const int* count, float* out, int s,
                                      int n, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return kErrRows;
  if (n <= 32) return launch_sort<1>(y, k_eff, count, out, s, n, d, st);
  if (n <= 64) return launch_sort<2>(y, k_eff, count, out, s, n, d, st);
  if (n <= 128) return launch_sort<4>(y, k_eff, count, out, s, n, d, st);
  if (n <= 256) return launch_sort<8>(y, k_eff, count, out, s, n, d, st);
  if (n <= 512) return launch_sort<16>(y, k_eff, count, out, s, n, d, st);
  if (n <= 1024) return launch_sort<32>(y, k_eff, count, out, s, n, d, st);
  return kErrRows;
}
