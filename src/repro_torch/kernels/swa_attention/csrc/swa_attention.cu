// Causal sliding-window attention (prefill / full-sequence forward) for
// Hopper (sm_90a).
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
// Keys are walked in ascending order, and the diagonal key j = i is live,
// so every stored row meets a live key after its junk.
//
// What bounds it: operations.  Per live (query, key) pair the function
// needs 2 Dh multiply-adds (q.k and p v), ~4 Dh flops, against a band of
// q, k, v and o bytes read or written once: at the serve path's shape
// (S = 16384, window 8192, Dh = 128, 16 heads) that is ~0.8 TFLOP a layer
// on ~0.2 GB, far above the card's flop-to-byte ratio.  The bound is the
// bf16 tensor-core rate.
//
// Two kernels behind one entry, one per operand type:
//
// bf16 (the serve path): swa_wgmma, on the tensor cores.  One block owns
// 128 query rows of one (batch, head): two consumer warpgroups of 64 rows
// each and a producer warpgroup whose one thread issues TMA loads.  Q is
// loaded once; K and V tiles of 128 keys stream through a ring of shared-
// memory stages guarded by mbarriers (full: the TMA bytes landed; empty:
// all 8 consumer warps are done with the stage).  TMA writes each tile as
// 64-column boxes with the 128-byte swizzle that wgmma reads.  Per tile a
// consumer warpgroup computes S = Q K^T with wgmma (both operands from
// shared memory, K-major: Dh is contiguous in both layouts), scales it to
// log2 units, masks it only on the tiles that straddle the band's edges
// (the first, at the window's lower edge, and the diagonal one: the window
// is a multiple of 128, so every tile between them is wholly live), runs
// the online softmax in registers (a row's max and sum over the 4 lanes
// that share it in the accumulator fragment), rescales O, and adds P V with
// wgmma, A from registers: the S fragment converted to bf16 is already in
// the A-operand layout.  B is the V tile as stored, read MN-major through
// the descriptor's transpose bit, so V needs no transpose pass.  P is split
// into bf16 hi and lo parts (p = hi + lo to ~16 bits) and both are added,
// so rounding P does not leave the fp32 plain version's tolerance; the
// softmax sums stay fp32.  The consumers take 232 registers each with
// setmaxnreg, the producer 40.  Blocks are launched longest band first, in
// a fixed order with no atomics and no split across blocks: results repeat
// bit for bit, and both layouts give the same bits.  Tensor maps are built
// per call on the host from the wrapper's strides (the driver's
// cuTensorMapEncodeTiled, fetched through the runtime so nothing links
// against libcuda); TMA zero-fills rows past S, which the j < S mask then
// drops.
//
// fp32 (checks and fp32 reference runs): swa_fwd, plain fp32 CUDA cores,
// so fp32 keeps fp32 products (TF32 would not hold the fp32 checks).  The
// TPU kernel walks a (B*H, query block, band block) grid with the
// innermost axis sequential and keeps (m, l, acc) in VMEM scratch.  Here
// one block of 8 warps owns 64 query rows of one (batch, head); a loop
// inside the block takes the place of the band axis and walks only the
// 32-key tiles that meet the rows' band, staging each K/V tile in shared
// memory as fp32 (K rows padded by 4 floats, so the lanes' 16-byte reads
// fall in distinct banks).  Each warp owns 8 consecutive rows and keeps their
// online-softmax state in registers: lane l owns key l of the tile for the
// scores and Dh/32 output columns for the accumulator.  Scores: lane l
// dots its key with the 8 rows' queries (broadcast reads of the staged Q
// tile).  Softmax: butterfly shuffles give each row's tile max and sum.
// P V: each lane's p is broadcast by shuffle, key by key, into the 8 x Dh/32
// accumulators.  A warp skips a tile that is masked for all its rows.
//
// Both read the model's (B, S, H, Dh) and the kernel's (B*H, S, Dh) layouts
// in place, through strides.
//
// Head dims 64, 112 and 128.  Each kernel is compiled for a tile width DH of
// 64 or 128 and takes the real head dim dh <= DH at run time: dh = 112
// (kimi-k2: d_model 7168 over 64 heads) computes at 128 and keeps 112.  The
// bf16 kernel's TMA maps declare an inner extent of dh, so the second
// 64-column box zero-fills columns 112-127 of Q, K and V: Q K^T over those
// zeros is exact, and P V's columns 112-127 come out zero and are not
// stored (in the model's layout those addresses are the next head's).  The
// fp32 kernel zero-fills its shared tiles past dh and masks its store the
// same way.  The scale is dh^-1/2.

#include <cuda.h>          // CUtensorMap and its enums; no libcuda call is linked
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
swa_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ o, int S, int H, int G, int window, int dh, float scale,
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
  const float* qb = q + b * ql.b + h * ql.h;
  const float* kb = k + b * kvl.b + kvh * kvl.h;
  const float* vb = v + b * kvl.b + kvh * kvl.h;
  float* ob = o + b * ol.b + h * ol.h;

  for (int e = threadIdx.x; e < kQTile * DH; e += kThreads) {
    const int i = q0 + e / DH, d = e % DH;
    qs[e] = i < S && d < dh ? qb[i * ql.s + d] : 0.f;
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
      const bool in = j < k_hi && d < dh;
      ks[jj * KP + d] = in ? kb[j * kvl.s + d] : 0.f;
      vs[e] = in ? vb[j * kvl.s + d] : 0.f;
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
      if (lane * C + c < dh) ob[i * ol.s + lane * C + c] = acc[r][c] / den;
  }
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, int dh, Layout ql, Layout kvl, Layout ol,
           cudaStream_t st) {
  constexpr int bytes = smem_floats<DH>() * 4;
  auto kern = swa_fwd<DH>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kQTile - 1) / kQTile, B * H);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, H / Hkv, window, dh,
      (float)(1.0 / sqrt((double)dh)), ql, kvl, ol);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 128;                  // query rows a block; keys a stage
constexpr int kConsumers = 2;               // warpgroups of 64 query rows
constexpr int kThreadsTC = 128 * (kConsumers + 1);   // + the producer warpgroup
constexpr int kBox = kTile * 128;           // bytes of a 128-row x 64-column box
constexpr int kStages = 2;                  // K/V tiles in flight (3 gained nothing)

template <int DH>
struct TC {
  static constexpr int kHalves = DH / 64;   // 64-column (128-byte) boxes a row
  static constexpr int kTileBytes = kBox * kHalves;
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  // Q, the K and V stages, the barriers (q, full[], empty[]), alignment slack
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spin until the barrier's phase differs from `parity`
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

// one box of a 4-d tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or reuse across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64 x 128) (+)= A(64 x 16, smem) * B(128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// O (64 x DH) += P (64 x 16, registers) V (16 keys x DH, MN-major)
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

template <int DH>
__global__ void __launch_bounds__(kThreadsTC, 1)
swa_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
          int H, int G, int window, int dh, float scale_log2, Layout ol) {
  using C = TC<DH>;
  constexpr int kSteps = kTile / 16;      // 16-key steps of P V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // every box on a 1024-byte boundary: the swizzle pattern repeats there
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kTileBytes;                    // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * C::kTileBytes;
  const uint32_t bar_q = base + C::kBarOffset;
  const uint32_t bar_full = bar_q + 8;                          // + stage * 8
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;          // longest bands first
  const int t_first = max(0, q0 - window + 1) / kTile;          // key tiles meeting the band
  const int t_last = (min(S, q0 + kTile) - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers * 4);            // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, C::kTileBytes);
      for (int hf = 0; hf < C::kHalves; ++hf)
        tma_load(q_s + hf * kBox, &tq, bar_q, hf * 64, q0, h, b);
      for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * C::kTileBytes);
        for (int hf = 0; hf < C::kHalves; ++hf) {
          const uint32_t off = st * C::kTileBytes + hf * kBox;
          tma_load(k_s + off, &tk, bar_full + 8 * st, hf * 64, t * kTile, kvh, b);
          tma_load(v_s + off, &tv, bar_full + 8 * st, hf * 64, t * kTile, kvh, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // accumulator fragment: this thread holds rows row_a and row_a + 8, and
    // columns 8 n + col, 8 n + col + 1 of each 8-column group n
    const int row_a = q0 + wg * 64 + warp * 16 + lane / 4, row_b = row_a + 8;
    const int col = 2 * (lane % 4);
    float acc[DH / 2], s[kTile / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) s[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const uint32_t q_wg = q_s + wg * 64 * 128;     // the warpgroup's rows in each box

    mbar_wait(bar_q, 0);
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t k_st = k_s + st * C::kTileBytes, v_st = v_s + st * C::kTileBytes;
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);

      // S = Q K^T: 16 columns a step, 32 bytes along a swizzled 128-byte row
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n128(s, gmma_desc(q_wg + off, 16, 1024), gmma_desc(k_st + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scores in log2 units; the band's edge tiles mask dead pairs to -1e30
      const int j0 = t * kTile;
      const bool whole = j0 + kTile - 1 <= q0 && q0 + kTile - 1 - j0 < window &&
                         j0 + kTile <= S;
      if (whole) {
#pragma unroll
        for (int n = 0; n < kTile / 2; ++n) s[n] *= scale_log2;
      } else {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * n + col + (e & 1), r = e < 2 ? row_a : row_b;
            const bool live = j <= r && r - j < window && j < S;
            s[4 * n + e] = live ? s[4 * n + e] * scale_log2 : kNegInf;
          }
      }

      // online softmax: the row max over the 4 lanes that share the row
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float c_a = ex2(m_a - mx_a), c_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      // P in the A-operand layout of the 16-key steps: step kk takes the
      // accumulator's column groups 2 kk and 2 kk + 1, rows a and b; P = hi
      // + lo, both bf16 (P rounded once breaks the bf16 tolerance on rows
      // with few live keys)
      uint32_t p_hi[kSteps][4], p_lo[kSteps][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const float p0 = ex2(s[4 * n] - m_a), p1 = ex2(s[4 * n + 1] - m_a);
        const float p2 = ex2(s[4 * n + 2] - m_b), p3 = ex2(s[4 * n + 3] - m_b);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        const __nv_bfloat162 ha = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 hb = __floats2bfloat162_rn(p2, p3);
        p_hi[n / 2][2 * (n % 2)] = *reinterpret_cast<const uint32_t*>(&ha);
        p_hi[n / 2][2 * (n % 2) + 1] = *reinterpret_cast<const uint32_t*>(&hb);
        p_lo[n / 2][2 * (n % 2)] = pack_bf16(p0 - __low2float(ha), p1 - __high2float(ha));
        p_lo[n / 2][2 * (n % 2) + 1] = pack_bf16(p2 - __low2float(hb), p3 - __high2float(hb));
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[4 * n] *= c_a;
        acc[4 * n + 1] *= c_a;
        acc[4 * n + 2] *= c_b;
        acc[4 * n + 3] *= c_b;
      }

      // O += P_hi V + P_lo V: V's rows are the K dimension, 8 rows (1024
      // bytes) per swizzle atom; its two 64-column boxes lie kBox apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_pv<DH>(acc, p_hi[kk], gmma_desc(v_st + kk * 2048, kBox, 1024));
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_pv<DH>(acc, p_lo[kk], gmma_desc(v_st + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // l: the 4 lanes' partial sums, in a fixed butterfly order
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + b * ol.b + h * ol.h + col;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (8 * n >= dh) break;             // dh is a multiple of 8: whole groups
      if (row_a < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * ol.s + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n] / den_a, acc[4 * n + 1] / den_a);
      if (row_b < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_b * ol.s + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2] / den_b, acc[4 * n + 3] / den_b);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (batch, sequence, head, DH) operand as a 4-d TMA map of
// 64-column x 128-row boxes with the 128-byte swizzle; 0 or an error
int tensor_map(CUtensorMap* map, const void* ptr, int dh, int S, int heads, int B, Layout l) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)l.s * 2, (cuuint64_t)l.h * 2, (cuuint64_t)l.b * 2};
  const cuuint32_t box[4] = {64, kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int Hkv, int window, int dh, Layout ql, Layout kvl, Layout ol,
                cudaStream_t st) {
  CUtensorMap tq, tk, tv;           // inner extent dh: columns dh..DH-1 zero-fill
  int err = tensor_map(&tq, q, dh, S, H, B, ql);
  if (!err) err = tensor_map(&tk, k, dh, S, Hkv, B, kvl);
  if (!err) err = tensor_map(&tv, v, dh, S, Hkv, B, kvl);
  if (err) return err;
  auto kern = swa_wgmma<DH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC<DH>::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
  kern<<<grid, kThreadsTC, TC<DH>::kSmem, st>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S,
                                                 H, H / Hkv, window, dh, scale_log2, ol);
  return (int)cudaGetLastError();
}

}  // namespace

// o = sliding-window attention of q against k, v.  dtype: 0 fp32 (the
// CUDA-core kernel), 1 bf16 (the tensor-core kernel), q, k, v and o alike;
// dh: 64, 112 (computed at 128) or 128.  q, o index (b, s, h, d) at
// b*_sb + s*_ss + h*_sh + d; k, v (b, s, kv head, d) likewise with the kv strides (bf16: multiples of 8
// elements, 16-byte aligned pointers, as TMA needs).  Returns the CUDA
// error of the launch (0: launched), -1 for an unsupported dtype / dh, -2
// if the driver has no cuTensorMapEncodeTiled, -3 if it refused a map.
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
    return launch_fp32<64>(q, k, v, o, B, S, H, Hkv, window, dh, ql, kvl, ol, st);
  if (dtype == 0 && (dh == 112 || dh == 128))
    return launch_fp32<128>(q, k, v, o, B, S, H, Hkv, window, dh, ql, kvl, ol, st);
  if (dtype == 1 && dh == 64)
    return launch_bf16<64>(q, k, v, o, B, S, H, Hkv, window, dh, ql, kvl, ol, st);
  if (dtype == 1 && (dh == 112 || dh == 128))
    return launch_bf16<128>(q, k, v, o, B, S, H, Hkv, window, dh, ql, kvl, ol, st);
  return -1;
}
