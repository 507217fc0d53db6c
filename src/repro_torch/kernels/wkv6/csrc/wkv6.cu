// RWKV6 WKV recurrence (time mixing of the "Finch" block) for Hopper
// (sm_90a), plain fp32 CUDA cores.
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
// parallelism is B * H * N threads and the kernel is latency-bound where
// that is small (decode: S = 1).
//
// Design.  This is the layout that the TPU kernel's source names as its GPU
// origin (RWKV-CUDA): one block per (batch, head) with N threads; thread j
// keeps column j of the state in N registers, so no reduction crosses
// threads.  The TPU kernel keeps the state in VMEM across a sequential grid
// of 128-step chunks; here the block loops over chunks of 32 steps, staging
// r, k, v, w of the chunk in shared memory (thread j loads element j of
// every step, coalesced), then marches the steps: each thread reads
// r_t, k_t, w_t and u as broadcast 16-byte loads and its own v_t[j], keeps
// four partial sums of y_t[j] (i mod 4) and updates its column in place.
// No padding: the loop ends at the last step (the TPU's pad with w = 1,
// k = 0 is a no-op there).  The layout is taken from strides, so the
// model's (B, S, H, N) and the kernel's (B*H, S, N) are read in place; the
// state is (B*H, N, N) either way.  A fixed order: results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;        // steps staged in shared memory at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Layout {            // element strides of r, k, v, w, y: (batch, step, head)
  long long b, t, h;
};

template <int N, typename T>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
            int S, int H, Layout lay, long long u_sb, long long u_sh) {
  __shared__ __align__(16) float rs[kChunk][N];
  __shared__ __align__(16) float ks[kChunk][N];
  __shared__ __align__(16) float vs[kChunk][N];
  __shared__ __align__(16) float ws[kChunk][N];
  __shared__ __align__(16) float us[N];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const long long base = b * lay.b + h * lay.h;
  const size_t state = (size_t)bh * N * N;

  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s0 ? s0[state + (size_t)i * N + j] : 0.f;
  us[j] = u[b * u_sb + h * u_sh + j];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();                      // the previous chunk is consumed
    for (int tt = 0; tt < n; ++tt) {
      const long long off = base + (long long)(t0 + tt) * lay.t + j;
      rs[tt][j] = to_f(r[off]);
      ks[tt][j] = to_f(k[off]);
      vs[tt][j] = to_f(v[off]);
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&rs[tt][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&ks[tt][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&ws[tt][i]);
        const float4 uu = *reinterpret_cast<const float4*>(&us[i]);
        const float ra[4] = {rr.x, rr.y, rr.z, rr.w};
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
        const float ua[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = ka[c] * vj;
          y4[c] = fmaf(ra[c], fmaf(ua[c], kv, s[i + c]), y4[c]);
          s[i + c] = fmaf(wa[c], s[i + c], kv);
        }
      }
      y[base + (long long)(t0 + tt) * lay.t + j] = from_f<T>((y4[0] + y4[1]) + (y4[2] + y4[3]));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[state + (size_t)i * N + j] = s[i];
}

template <int N, typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B, int H,
           int S, Layout lay, long long u_sb, long long u_sh, cudaStream_t st) {
  wkv6_kernel<N, T><<<B * H, N, 0, st>>>(
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
