// Causal sliding-window attention (prefill / full-sequence forward) for
// Hopper (sm_90a), plain fp32 CUDA cores.
//
// Replaces the TPU Pallas kernel swa_attention_bhsd
// (src/repro/kernels/swa_attention/swa_attention.py, body _swa_kernel).
// For query i and key j of one sequence (query head h reads kv head h / G):
//
//   live(i, j) = j <= i  and  i - j < window  and  j < S
//   s_ij       = (q_i . k_j) * Dh^-1/2          (fp32; -1e30 where not live)
//   o_i        = sum_j softmax_j(s_i.) v_j      (online softmax, fp32)
//
// and o_i is written in q's dtype (fp32 or bf16).  Masked scores take the
// reference's finite -1e30, and the sum is divided by max(l, 1e-30), so a
// row whose first tiles are all masked adds junk that its first live key
// wipes out (the correction exp(-1e30 - m) is 0), as in the TPU kernel.
//
// What bounds it: operations.  Per live (query, key) pair the function
// needs 2 Dh multiply-adds (q.k and p v), ~4 Dh flops, against a band of
// q, k, v and o bytes read or written once: at the serve path's shape
// (S = 16384, window 8192, Dh = 128, 16 heads) that is ~0.8 TFLOP a layer
// on ~0.2 GB, far above the card's flop-to-byte ratio.  The bound is the
// bf16 tensor-core rate.  This kernel runs on the fp32 CUDA cores, so it
// sits well above that bound; tensor cores (mma / wgmma), TMA and
// pipelining are later work.
//
// Design.  The TPU kernel walks a (B*H, query block, band block) grid with
// the innermost axis sequential and keeps (m, l, acc) in VMEM scratch.
// Here one block of 8 warps owns 64 query rows of one (batch, head); a loop
// inside the block takes the place of the band axis and walks only the
// 32-key tiles that meet the rows' band, staging each K/V tile in shared
// memory as fp32 (K rows padded by 4 floats, so the lanes' 16-byte reads
// fall in distinct banks).  Each warp owns 8 consecutive rows and keeps their
// online-softmax state in registers: lane l owns key l of the tile for the
// scores and Dh/32 output columns for the accumulator.  Scores: lane l
// dots its key with the 8 rows' queries (broadcast reads of the staged Q
// tile).  Softmax: butterfly shuffles give each row's tile max and sum.
// P V: each lane's p is broadcast by shuffle, key by key, into the 8 x Dh/32
// accumulators.  A warp skips a tile that is masked for all its rows.  The
// layout is taken from strides, so the model's (B, S, H, Dh) and the
// kernel's (B*H, S, Dh) are read in place.  No atomics, a fixed order:
// results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kQTile = kWarps * kRows;    // query rows per block
constexpr int kKTile = 32;                // keys per staged tile, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Layout {            // element strides of (batch, sequence, head)
  long long b, s, h;
};

template <int DH>
constexpr int smem_floats() {
  return kQTile * DH + kKTile * (DH + 4) + kKTile * DH;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
swa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        T* __restrict__ o, int S, int H, int G, int window, float scale,
        Layout ql, Layout kvl, Layout ol) {
  constexpr int C = DH / 32;              // output columns per lane
  constexpr int KP = DH + 4;              // padded K row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kQTile][DH]
  float* ks = qs + kQTile * DH;           // [kKTile][KP]
  float* vs = ks + kKTile * KP;           // [kKTile][DH]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = blockIdx.x * kQTile;
  const T* qb = q + b * ql.b + h * ql.h;
  const T* kb = k + b * kvl.b + kvh * kvl.h;
  const T* vb = v + b * kvl.b + kvh * kvl.h;
  T* ob = o + b * ol.b + h * ol.h;

  for (int e = threadIdx.x; e < kQTile * DH; e += kThreads) {
    const int i = q0 + e / DH;
    qs[e] = i < S ? to_f(qb[i * ql.s + e % DH]) : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;            // the warp's first row in the tile
  const int row_lo = q0 + r0;
  const int row_hi = min(row_lo + kRows, S) - 1;
  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(S, q0 + kQTile);   // keys [k_lo, k_hi) meet the block's band
  for (int t0 = k_lo; t0 < k_hi; t0 += kKTile) {
    __syncthreads();                      // the previous tile is consumed
    for (int e = threadIdx.x; e < kKTile * DH; e += kThreads) {
      const int jj = e / DH, d = e % DH, j = t0 + jj;
      const bool in = j < k_hi;
      ks[jj * KP + d] = in ? to_f(kb[j * kvl.s + d]) : 0.f;
      vs[e] = in ? to_f(vb[j * kvl.s + d]) : 0.f;
    }
    __syncthreads();
    // the tile is masked for every row of this warp: rows past S, keys all
    // after the last row, or all before the first row's window
    if (row_lo >= S || t0 > row_hi || t0 + kKTile - 1 <= row_lo - window) continue;

    // scores: lane owns key t0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * KP;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (r0 + r) * DH + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    const int j = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row_lo + r;
      const bool live = j < k_hi && j <= i && i - j < window;
      const float sc = live ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      s[r] = p;
    }
    // P V: key by key, each lane's p broadcast to the warp
#pragma unroll 4
    for (int jj = 0; jj < kKTile; ++jj) {
      float vv[C];
      const float* vr = vs + jj * DH + lane * C;
      if constexpr (C == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vr);
        vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
      } else if constexpr (C == 2) {
        const float2 t = *reinterpret_cast<const float2*>(vr);
        vv[0] = t.x; vv[1] = t.y;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) vv[c] = vr[c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row_lo + r;
    if (i >= S) break;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[i * ol.s + lane * C + c] = from_f<T>(acc[r][c] / den);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, Layout ql, Layout kvl, Layout ol,
           cudaStream_t st) {
  constexpr int bytes = smem_floats<DH>() * 4;
  auto kern = swa_fwd<DH, T>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kQTile - 1) / kQTile, B * H);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, H / Hkv, window, (float)(1.0 / sqrt((double)DH)), ql, kvl, ol);
  return (int)cudaGetLastError();
}

}  // namespace

// o = sliding-window attention of q against k, v.  dtype: 0 fp32, 1 bf16
// (q, k, v and o alike); dh: 64 or 128.  q, o index (b, s, h, d) at
// b*_sb + s*_ss + h*_sh + d; k, v (b, s, kv head, d) likewise with the kv
// strides.  Returns the CUDA error of the launch (0: launched), or -1 for
// an unsupported dtype / dh.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int dh, int B, int S, int H,
                                 int Hkv, int window,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long kv_sb, long long kv_ss, long long kv_sh,
                                 long long o_sb, long long o_ss, long long o_sh,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout ql{q_sb, q_ss, q_sh}, kvl{kv_sb, kv_ss, kv_sh}, ol{o_sb, o_ss, o_sh};
  if (dtype == 0 && dh == 64)
    return launch<64, float>(q, k, v, o, B, S, H, Hkv, window, ql, kvl, ol, st);
  if (dtype == 0 && dh == 128)
    return launch<128, float>(q, k, v, o, B, S, H, Hkv, window, ql, kvl, ol, st);
  if (dtype == 1 && dh == 64)
    return launch<64, __nv_bfloat16>(q, k, v, o, B, S, H, Hkv, window, ql, kvl, ol, st);
  if (dtype == 1 && dh == 128)
    return launch<128, __nv_bfloat16>(q, k, v, o, B, S, H, Hkv, window, ql, kvl, ol, st);
  return -1;
}
