// RWKV6 WKV recurrence (time mixing of the "Finch" block) for Hopper
// (sm_90a), fp32 CUDA cores.
//
// Replaces the TPU Pallas kernel wkv6_bhsn
// (src/repro/kernels/wkv6/wkv6.py, body _wkv6_kernel).  Per (batch, head),
// head size N, state S (N x N, keyed [i = k-dim][j = v-dim]):
//
//   y_t[j]   = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// from S = s0 (or zeros), over t = 0..S_len-1; returns y (in v's dtype) and
// the final state (fp32).  r, k, v come in fp32 or bf16, w in fp32; all
// arithmetic is fp32.
//
// What bounds it: at the serve path's shape (B = 8, S = 4096, H = 32,
// N = 64) the bytes (r, k, v, w read once, y written once) and the
// operations (~4 N^2 flops per (b, h, step) at the fp32 rate) are about
// equal, ~0.25 ms a layer each.  The time axis is sequential, so the
// parallelism is B * H * N * N state elements a step, and a block can only
// use the SM it runs on.
//
// Design.  The TPU kernel's source names its GPU origin (RWKV-CUDA): one
// block per (batch, head), thread j keeps column j of the state in
// registers; at the path's shape that is 2 warps a block, too few to hide
// shared-memory and FMA latency.  Here a block of N P / J threads (8 warps
// at N = 64) splits the state: thread (p, j0) keeps the L = N / P rows
// [p L, (p + 1) L) of the J columns j0 .. j0 + J - 1 (the J columns share
// each r, k, w read).  Threads of one warp share p and take consecutive
// column groups, so a warp's reads of its r, k, w slice are broadcasts and
// its state loads are coalesced.  Each step, a thread adds its rows' part
// of y_t[j] and updates its state elements with the plain formula; the P
// partial sums go to shared memory, and after the chunk one pass adds them
// in thread order and writes y coalesced: every y is a fixed-order sum and
// no shuffle waits inside the step loop.  The TPU kernel keeps the state in
// VMEM across a sequential grid of 128-step chunks; here the block loops
// over chunks of 16 steps: r, k, v (as stored, fp32 or bf16) and w of the
// next chunk arrive by 16-byte cp.async while the current one is marched,
// then are converted once to fp32 into the march buffers (rows of r, k, w
// cut into the P slices, each padded by 4 floats, so that where a warp
// holds several p, for small N, their 16-byte reads fall in distinct
// banks).  No padding of the sequence: the loop ends at the last step (the
// TPU's pad with w = 1, k = 0 is a no-op there).  The layout is taken from
// strides, so the model's (B, S, H, N) and the kernel's (B*H, S, N) are
// read in place; the state is (B*H, N, N) either way.  A fixed order:
// results repeat bit for bit, and a state carried from one call into the
// next gives the bits of one call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// measured on the H100 at N = 64 (chip_smoke's serve shape) against P in
// {2, 4, 8, 16}, J in {1, 2, 4}, 16 or 32 steps, unrolled 1, 2 or 4 times
constexpr int kChunk = 16;         // steps staged in shared memory at a time
constexpr int kSplit = 8;          // P: threads sharing a group of state columns
constexpr int kCols = 2;           // J: state columns a thread keeps (N >= 32)
constexpr int kUnroll = 2;         // steps the compiler may interleave

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

struct Layout {            // element strides of r, k, v, w, y: (batch, step, head)
  long long b, t, h;
};

template <int N, typename T>
struct Cfg {
  static constexpr int P = N / 4 < kSplit ? N / 4 : kSplit;
  static constexpr int J = N >= 32 ? kCols : 1;
  static constexpr int L = N / P;             // state rows a thread keeps (a multiple of 4)
  static constexpr int kThreads = N * P / J;
  static constexpr int RS = P * (L + 4);      // a staged row of r, k or w: padded slices
  static constexpr int YS = N + 4;            // a thread's row of partial y sums, padded
  static constexpr int kRaw = kChunk * N * (3 * (int)sizeof(T) + 4);   // as loaded
  // + the march buffers (r, k, w padded, v) and the P partial sums of y
  static constexpr int kSmem = kRaw + kChunk * (3 * RS + N + P * YS) * 4;
  static_assert(L % 4 == 0 && N % J == 0, "slices of whole float4s, whole column groups");
};

template <int N, typename T>
__global__ void __launch_bounds__(Cfg<N, T>::kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
            int S, int H, Layout lay, long long u_sb, long long u_sh) {
  using C = Cfg<N, T>;
  constexpr int P = C::P, J = C::J, L = C::L, RS = C::RS, YS = C::YS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_raw = reinterpret_cast<T*>(smem);      // [kChunk][N] each, as loaded
  T* k_raw = r_raw + kChunk * N;
  T* v_raw = k_raw + kChunk * N;
  float* w_raw = reinterpret_cast<float*>(v_raw + kChunk * N);
  float* rs = w_raw + kChunk * N;             // [kChunk][RS]: the chunk being marched
  float* ks = rs + kChunk * RS;
  float* ws = ks + kChunk * RS;
  float* vs = ws + kChunk * RS;               // [kChunk][N]
  float* ys = vs + kChunk * N;                // [kChunk][P][YS]: partial y sums

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // thread (p, j0) keeps rows [p L, (p + 1) L) of columns j0 .. j0 + J - 1;
  // a warp's threads share p
  const int p = threadIdx.x / (N / J), j0 = threadIdx.x % (N / J) * J;
  const long long base = b * lay.b + h * lay.h;
  const size_t state = (size_t)bh * N * N;

  float s[L][J], uu[L];
#pragma unroll
  for (int c = 0; c < L; ++c) {
    const int i = p * L + c;
#pragma unroll
    for (int q = 0; q < J; ++q) s[c][q] = s0 ? s0[state + (size_t)i * N + j0 + q] : 0.f;
    uu[c] = u[b * u_sb + h * u_sh + i];
  }

  // 16-byte copies of steps [t0, t0 + kChunk) into the raw buffers
  auto load = [&](int t0) {
    const int n = min(kChunk, S - t0);
    constexpr int kPer = 16 / sizeof(T), kRow = N / kPer;   // pieces of a row of r, k, v
    for (int e = threadIdx.x; e < n * kRow; e += C::kThreads) {
      const int tt = e / kRow, c = (e % kRow) * kPer;
      const long long off = base + (long long)(t0 + tt) * lay.t + c;
      cp_async16(r_raw + tt * N + c, r + off);
      cp_async16(k_raw + tt * N + c, k + off);
      cp_async16(v_raw + tt * N + c, v + off);
    }
    for (int e = threadIdx.x; e < n * (N / 4); e += C::kThreads) {
      const int tt = e / (N / 4), c = (e % (N / 4)) * 4;
      cp_async16(w_raw + tt * N + c, w + base + (long long)(t0 + tt) * lay.t + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                      // the chunk landed; the last one is marched
    for (int e = threadIdx.x; e < n * N; e += C::kThreads) {
      const int tt = e / N, i = e % N;
      const int x = tt * RS + (i / L) * (L + 4) + i % L;
      rs[x] = to_f(r_raw[e]);
      ks[x] = to_f(k_raw[e]);
      ws[x] = w_raw[e];
      vs[e] = to_f(v_raw[e]);
    }
    __syncthreads();                      // march buffers full, raw buffers free
    if (t0 + kChunk < S) load(t0 + kChunk);
#pragma unroll kUnroll
    for (int tt = 0; tt < n; ++tt) {
      float vj[J];
      if constexpr (J == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vs + tt * N + j0);
        vj[0] = t.x; vj[1] = t.y; vj[2] = t.z; vj[3] = t.w;
      } else {
#pragma unroll
        for (int q = 0; q < J; ++q) vj[q] = vs[tt * N + j0 + q];
      }
      const float* rr = rs + tt * RS + p * (L + 4);
      const float* kr = ks + tt * RS + p * (L + 4);
      const float* wr = ws + tt * RS + p * (L + 4);
      float ya[J][2];
#pragma unroll
      for (int q = 0; q < J; ++q) ya[q][0] = ya[q][1] = 0.f;
#pragma unroll
      for (int c = 0; c < L; c += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + c);
        const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
        const float4 w4 = *reinterpret_cast<const float4*>(wr + c);
        const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < J; ++q) {
            const float kv = ka[e] * vj[q];
            ya[q][e & 1] = fmaf(ra[e], fmaf(uu[c + e], kv, s[c + e][q]), ya[q][e & 1]);
            s[c + e][q] = fmaf(wa[e], s[c + e][q], kv);
          }
      }
      float* yp = ys + (tt * P + p) * YS + j0;
      if constexpr (J == 4) {
        *reinterpret_cast<float4*>(yp) = make_float4(ya[0][0] + ya[0][1], ya[1][0] + ya[1][1],
                                                     ya[2][0] + ya[2][1], ya[3][0] + ya[3][1]);
      } else {
#pragma unroll
        for (int q = 0; q < J; ++q) yp[q] = ya[q][0] + ya[q][1];
      }
    }
    __syncthreads();                      // every thread's partial sums are in
    // y_t[j]: the P partial sums in thread order
    for (int e = threadIdx.x; e < n * N; e += C::kThreads) {
      const int tt = e / N, jj = e % N;
      const float* yp = ys + tt * P * YS + jj;
      float acc = yp[0];
#pragma unroll
      for (int q = 1; q < P; ++q) acc += yp[q * YS];
      y[base + (long long)(t0 + tt) * lay.t + jj] = from_f<T>(acc);
    }
  }
#pragma unroll
  for (int c = 0; c < L; ++c)
#pragma unroll
    for (int q = 0; q < J; ++q) s_out[state + (size_t)(p * L + c) * N + j0 + q] = s[c][q];
}

template <int N, typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B, int H,
           int S, Layout lay, long long u_sb, long long u_sh, cudaStream_t st) {
  using C = Cfg<N, T>;
  auto kern = wkv6_kernel<N, T>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B * H, C::kThreads, C::kSmem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      w, u, s0, static_cast<T*>(y), s_out, S, H, lay, u_sb, u_sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, void* y, float* s_out, int B, int H,
             int S, Layout lay, long long u_sb, long long u_sh, cudaStream_t st) {
  switch (n) {
    case 8: return launch<8, T>(r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb, u_sh, st);
    case 16: return launch<16, T>(r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb, u_sh, st);
    case 32: return launch<32, T>(r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb, u_sh, st);
    case 64: return launch<64, T>(r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb, u_sh, st);
    default: return -1;
  }
}

}  // namespace

// y, s_out = WKV6 over S steps.  dtype: 0 fp32, 1 bf16 (r, k, v and y
// alike; w, u, s0 and s_out are fp32); n: head size 8, 16, 32 or 64.
// r, k, v, w, y index (b, t, h, i) at b*sb + t*st + h*sh + i; u (b, h, i) at
// b*u_sb + h*u_sh + i; s0 (nullable: zeros) and s_out are (B*H, N, N)
// contiguous.  Returns the CUDA error of the launch (0: launched), or -1
// for an unsupported dtype / n.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0, void* y,
                        float* s_out, int dtype, int n, int B, int H, int S,
                        long long sb, long long st, long long sh, long long u_sb,
                        long long u_sh, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Layout lay{sb, st, sh};
  if (dtype == 0)
    return dispatch<float>(n, r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb, u_sh, cs);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(n, r, k, v, w, u, s0, y, s_out, B, H, S, lay, u_sb,
                                   u_sh, cs);
  return -1;
}
