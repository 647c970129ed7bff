// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd (pallas_call at
// :117, body _kernel at :32).  Same function: heads-major q (BHq, Sq, D),
// k/v (BHkv, Sk, D) with q head b reading kv head b / group; scores
// s = (q . k) * D^-0.5, optional tanh softcap, mask kpos < Sk, causal
// qpos >= kpos and sliding window kpos > qpos - window (masked scores are
// -1e30); online softmax with float32 m, l and acc; p rounded to the input
// type before the PV product; out = acc / max(l, 1e-30) in the input type.
// Whole kv blocks outside the causal / window mask are skipped, by the TPU
// kernel's `needed` test applied to this kernel's blocks.  Query row i sits
// at position q_offset + i (the reference's block_attention(q_offset=)): a
// rank of the sequence-parallel attention holds rows [r S/tp, (r+1) S/tp)
// against keys [0, S), so every mask test and block bound compares
// q_offset + i with the key's index, and loads and stores use i.
//
// Bound: operations.  At the serving shape (BH 256, S 2048, D 64, causal,
// bf16) the two products are ~137 GFLOP against ~268 MB of inputs and
// output, far above the H100's ~295 bf16 FLOP per byte, so the bf16
// tensor-core rate bounds it (0.139 ms at 989 TFLOP/s).  At D 64 the exp2 of
// the softmax is nearly as costly: one per score at 16 a clock per SM takes
// as long as the two products on the tensor cores, so the design is about
// keeping both busy at once.
//
// Two hand-written kernels, chosen by dtype in flash_attention_launch (an
// explicit dispatch, not a fallback: each has its own launch and the
// wrapper raises on any error):
//
// * bfloat16, the serving path (namespace tc), shaped like FlashAttention-3.
//   One CTA of 384 threads per (head, 128-row q block), launched in an order
//   that runs the heavier half of the causal q blocks first and keeps the q
//   blocks of one head together (their K and V come from L2).  Warpgroup 2
//   is the producer (registers given back with setmaxnreg): one thread
//   keeps TMA loads of 128-row K and V tiles in flight through a ring of 3
//   stages (2 at D 128) in shared memory, swizzled 128, 64 or 32 bytes by D,
//   with full/empty mbarriers; Q comes in once by TMA.  Warpgroups 0 and 1
//   consume, 64 q rows each.  S = Q K^T is an m64n128k16 wgmma with Q and K
//   from shared memory and float32 accumulators in registers.  The online
//   softmax runs in registers in log2 units (scale * log2(e) folded into one
//   FMA before ex2), float32 m and l.  p is rounded to bf16 and stays in
//   registers as the A operand of the PV wgmma (m64nDk16), whose B operand
//   is V in shared memory read through an MN-major descriptor.  Software
//   pipeline: S of block j is issued with the PV product of block j - 1 and
//   the softmax of block j overlaps it; at D <= 64 the two warpgroups also
//   take turns to issue (ping-pong).  The mask and the softcap's tanh run
//   only on blocks that are not wholly inside the mask for the warpgroup's
//   rows; blocks outside it are never loaded, and a causal block above a
//   warpgroup's diagonal is released without any product.
// * float32 (off the serving path: the float32 model checks): the first
//   CUDA-core kernel, unchanged.  One CTA of 256 threads per (head, 64-row
//   q block) loops over 64-row kv blocks in float32; each thread holds a
//   4x4 block of the score tile and a 4 x D/16 block of acc in registers.
//   Its tiles are 64 x 64, the bf16 kernel's 128 x 128; the plain version
//   tiles as the kernel of the input's dtype does, so both round p at the
//   same running maxima.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPS = kBK + 16;  // row stride of the p tile (two rows apart
                               // by 16 banks: the two half-warps never clash)
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int q_off, int n_qb, int group, int causal, int window,
                 int has_cap, float cap, float scale) {
  constexpr int QS = D + 1;     // padded row stride of the q and k tiles
  constexpr int CJ = D / 16;    // acc columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x QS
  float* Ks = Qs + kBQ * QS;    // kBK x QS
  float* Vs = Ks + kBK * QS;    // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x kPS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x / n_qb;
  const int q0 = (blockIdx.x % n_qb) * kBQ;   // first row of the block
  const int p0 = q_off + q0;                    // and its position
  const T* qp = q + bh * Sq * D;
  const T* kp = k + (bh / group) * Sk * D;
  const T* vp = v + (bh / group) * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * QS + c] = q0 + r < Sq ? to_f(qp[int64_t(q0 + r) * D + c]) : 0.f;
  }

  float acc[4][CJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // kv blocks the mask needs (the TPU kernel's `needed`, on these blocks)
  const int n_kb = (Sk + kBK - 1) / kBK;
  int j_end = n_kb, j_begin = 0;
  if (causal) j_end = min(n_kb, (p0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int lo = p0 - (window - 1) - (kBK - 1);   // need j * kBK >= lo
    j_begin = lo <= 0 ? 0 : (lo + kBK - 1) / kBK;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kBK;
    __syncthreads();            // the previous step is done with Ks, Vs, Ps
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      Ks[r * QS + c] = in ? to_f(kp[int64_t(k0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vp[int64_t(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = Ks[(tx + 16 * jj) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = p0 + ty + 16 * i;            // the row's position
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        float x = s[i][jj] * scale;
        if (has_cap) x = tanhf(x / cap) * cap;
        bool ok = kj < Sk;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][jj] = ok ? x : kNeg;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * jj] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* op = out + (bh * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) op[tx + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                long long BH, int Sq, int Sk, int q_off, int group, int causal,
                int window, int has_cap, float cap, cudaStream_t stream) {
  const int smem = int(sizeof(float)) *
                   (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long n_qb = (Sq + kBQ - 1) / kBQ;
  if (BH * n_qb > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D><<<unsigned(BH * n_qb), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, q_off,
      int(n_qb), group, causal, window, has_cap, cap,
      float(1.0 / sqrt(double(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int D, const void* q, const void* k, const void* v,
                  void* out, long long BH, int Sq, int Sk, int q_off,
                  int group, int causal, int window, int has_cap, float cap,
                  cudaStream_t s) {
  switch (D) {
    case 16: return run<T, 16>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 32: return run<T, 32>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 64: return run<T, 64>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 128: return run<T, 128>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;           // q rows per CTA: two consumer warpgroups
constexpr int kBN = 128;           // kv rows per pipeline stage
constexpr int kThreads = 384;      // warpgroups 0-1 consume, 2 loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg2 = -1e30f * kLog2e;   // the masked score, in log2 units
constexpr unsigned kFull = 0xffffffffu;

// One tile of R rows x D bf16 columns sits in shared memory as D / PANEL
// panels of R rows x PANEL columns, each as TMA writes it with a swizzle of
// SWZ = 2 * PANEL bytes (128, 64 or 32 bytes: a row of a panel is one
// swizzle row).  wgmma reads the same layout through its descriptors.
template <int D>
struct Cfg {
  // the consumer warpgroups take turns to issue their products (measured
  // faster at D 64, slower at D 128)
  static constexpr bool PING_PONG = D <= 64;
  static constexpr int PANEL = D < 64 ? D : 64;
  static constexpr int NPANEL = D / PANEL;
  static constexpr int SWZ = PANEL * 2;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = kBN * D * 2;        // one of K, V
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 128;
  // descriptor layout code of the swizzle (128 B: 1, 64 B: 2, 32 B: 3)
  static constexpr uint64_t LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// A wait that outlasts ~10 s of clocks (a lost TMA load or arrival) traps,
// so a fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the registers of an A operand alive, and unchanged, until the
// asynchronous wgmma that reads them is known to be complete
template <int R, int C>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// what the softmax of one block needs besides the scores
struct Mask {
  int Sk, causal, window, has_cap;
  float cap, scale, sl2;   // sl2 = scale * log2(e)
  int kpad;                // keys from kpad on weigh nothing
  int t, r0, wq0;          // lane % 4; the positions of this thread's
                           // first row and of the warpgroup's first row
};

// S = Q K^T for warpgroup wg: D / 16 wgmma k-steps along the panels
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[64], uint32_t sQ,
                                           uint32_t sk, int wg) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PANEL, c = kk * 16 % C::PANEL;
    const uint64_t da = make_desc(
        sQ + p * kBM * C::SWZ + wg * 64 * C::SWZ + c * 2, 16, 8 * C::SWZ,
        C::LAYOUT);
    const uint64_t db = make_desc(sk + p * kBN * C::SWZ + c * 2, 16,
                                  8 * C::SWZ, C::LAYOUT);
    wgmma_ss_n128(sc, da, db, kk > 0);   // the first k-step overwrites sc
  }
}

// O += P V: P from registers, V from shared memory read transposed
// (MN-major descriptor: panels of PANEL columns kBN * SWZ bytes apart)
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[kBN / 16][4],
                                           uint32_t sv) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], make_desc(sv + kk * 16 * C::SWZ, kBN * C::SWZ,
                                     8 * C::SWZ, C::LAYOUT));
}

// Online softmax of one block of scores, in log2 units (scale * log2(e)
// folded into one FMA before exp2): updates m and l, leaves p (float32) in
// sc and the rescale factor of the earlier rows in corr.  The softcap's tanh
// and the mask run only on blocks that need them.
__device__ __forceinline__ void softmax_block(float (&sc)[64], float (&m)[2],
                                              float (&l)[2], float (&corr)[2],
                                              int k0, const Mask& mk) {
  const bool full = k0 + kBN <= mk.Sk &&
                    (!mk.causal || k0 + kBN - 1 <= mk.wq0) &&
                    (mk.window <= 0 || k0 > mk.wq0 + 63 - mk.window);
  const bool fast = full && !mk.has_cap;
  float rmax[2] = {-INFINITY, -INFINITY};
  if (fast) {                       // scores stay raw; scaled in the FMA
#pragma unroll
    for (int e = 0; e < 64; ++e) rmax[(e / 2) % 2] = fmaxf(rmax[(e / 2) % 2], sc[e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) rmax[i] *= mk.sl2;
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int i = (e / 2) % 2;
      const int kj = k0 + (e / 4) * 8 + 2 * mk.t + e % 2, qi = mk.r0 + 8 * i;
      float x = mk.has_cap ? tanhf(sc[e] * mk.scale / mk.cap) * (mk.cap * kLog2e)
                           : sc[e] * mk.sl2;
      bool ok = kj < mk.Sk;
      if (mk.causal) ok = ok && qi >= kj;
      if (mk.window > 0) ok = ok && kj > qi - mk.window;
      if (!ok) x = kj < mk.kpad ? kNeg2 : -INFINITY;
      sc[e] = x;
      rmax[i] = fmaxf(rmax[i], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(kFull, rmax[i], 1));
    rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(kFull, rmax[i], 2));
    const float mn = fmaxf(m[i], rmax[i]);
    corr[i] = ex2(m[i] - mn);
    m[i] = mn;
  }
  const float a = fast ? mk.sl2 : 1.f;
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int i = (e / 2) % 2;
    sc[e] = ex2(fmaf(sc[e], a, -m[i]));
    ls[i] += sc[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ls[i];
}

// p rounded to bf16, as the A fragments of the PV wgmma (the accumulator
// layout of S is the A register layout, two values to a register)
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[kk * 8 + 2 * r], sc[kk * 8 + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int BH, int Sq, int Sk,
                int q_off, int n_qb, int group, int causal, int window,
                int has_cap, float cap, float scale) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;   // stage s: K, then V
  const uint32_t bars = sKV + C::STAGES * 2 * C::KV_BYTES;
  const uint32_t bar_q = bars;
  auto bar_full = [&](int s) { return bars + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (1 + C::STAGES + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Order of the CTAs: the heavier half of the q blocks of every head
  // first (so the last wave is short), and within each half the q blocks
  // of one head next to each other (so its K and V are read from L2).
  const int n_hi = (n_qb + 1) / 2;
  const bool hi = int(blockIdx.x) < BH * n_hi;
  const int idx = hi ? int(blockIdx.x) : int(blockIdx.x) - BH * n_hi;
  const int per = hi ? n_hi : n_qb - n_hi;
  const int bh = idx / per;
  const int q0 = ((hi ? n_qb : n_qb - n_hi) - 1 - idx % per) * kBM;
  const int p0 = q_off + q0;               // the position of row q0

  // kv blocks the mask needs: the plain version's `needed`, on its blocks
  // (min(kBM, Sq) q rows, min(kBN, Sk) kv rows)
  const int n_kb = (Sk + kBN - 1) / kBN;
  int j_end = n_kb, j_begin = 0;
  if (causal) j_end = min(n_kb, (p0 + min(kBM, Sq) - 1) / kBN + 1);
  if (window > 0) {
    const int lo = p0 - (window - 1) - (min(kBN, Sk) - 1);
    j_begin = lo <= 0 ? 0 : (lo + kBN - 1) / kBN;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 2);        // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                       // producer: TMA loads only
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::NPANEL; ++p)
        tma_load_3d(sQ + p * kBM * C::SWZ, &tm_q, bar_q, p * C::PANEL, q0, bh);
      for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(bar_empty(s), ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * C::KV_BYTES);
        const uint32_t sk = sKV + s * 2 * C::KV_BYTES, sv = sk + C::KV_BYTES;
        for (int p = 0; p < C::NPANEL; ++p) {
          tma_load_3d(sk + p * kBN * C::SWZ, &tm_k, bar_full(s), p * C::PANEL,
                      j * kBN, bh / group);
          tma_load_3d(sv + p * kBN * C::SWZ, &tm_v, bar_full(s), p * C::PANEL,
                      j * kBN, bh / group);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // consumers: warpgroup wg owns the q rows at positions wq0 .. wq0 + 63;
  // this thread holds those at r0 and r0 + 8 of each accumulator (the
  // wgmma register layout)
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int wq0 = p0 + 64 * wg;
  // keys past Sk inside a kv block the plain version does not pad (Sk <
  // kBN) weigh nothing, even in a row that no key reaches
  const Mask mk{Sk, causal, window, has_cap, cap, scale, scale * kLog2e,
                Sk < kBN ? Sk : INT_MAX, t, wq0 + 16 * (warp % 4) + g, wq0};
  // causal blocks past this warpgroup's diagonal are released untouched
  // (every p there is exactly 0)
  const int j_stop = causal && window <= 0
                         ? min(j_end, (wq0 + 63) / kBN + 1) : j_end;
  float o[D / 2], sc[64], m[2] = {kNeg2, kNeg2}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const bool leader = threadIdx.x % 128 == 0;
  // stage of the tt-th block the producer loaded
  auto k_tile = [&](int it) { return sKV + (it % C::STAGES) * 2 * C::KV_BYTES; };
  auto full_wait = [&](int it) {
    mbar_wait(bar_full(it % C::STAGES), (it / C::STAGES) & 1);
  };
  auto release = [&](int it) {
    if (leader) mbar_arrive(bar_empty(it % C::STAGES));
  };

  mbar_wait(bar_q, 0);
  // Software pipeline: S of block j is issued together with the PV product
  // of block j - 1, and the softmax of block j runs while that PV product is
  // still on the tensor cores.  With PING_PONG the two warpgroups take turns
  // to issue (named barriers 1 and 2), so that one's softmax overlaps the
  // other's products; each takes n + 1 turns (idle turns for skipped
  // blocks), warpgroup 1 opens and does not pass on its last turn, so every
  // barrier phase completes.
  const int n = j_end - j_begin;
  int turns = 0;
  auto turn_begin = [&]() {
    if (C::PING_PONG) named_sync(1 + wg);
  };
  auto turn_end = [&]() {
    if (C::PING_PONG && !(wg == 1 && turns == n)) named_arrive(2 - wg);
    ++turns;
  };
  if (C::PING_PONG && wg == 1) named_arrive(1);
  int it = 0;
  if (j_begin < j_stop) {
    full_wait(it);
    turn_begin();
    wgmma_fence();
    qk_product<D>(sc, sQ, k_tile(it), wg);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    reg_fence(sc);
    softmax_block(sc, m, l, corr, j_begin * kBN, mk);
    pack_p(sc, pa);
    for (int j = j_begin + 1; j < j_stop; ++j, ++it) {
      full_wait(it + 1);
      turn_begin();
      wgmma_fence();
      qk_product<D>(sc, sQ, k_tile(it + 1), wg);
      wgmma_commit();
      pv_product<D>(o, pa, k_tile(it) + C::KV_BYTES);
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();                  // S of block j is in
      reg_fence(sc);
      softmax_block(sc, m, l, corr, j * kBN, mk);
      wgmma_wait<0>();                  // PV of block j - 1 is in
      reg_fence(o);
      reg_fence(pa);
      release(it);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt * 4 + e] *= corr[e / 2];
      pack_p(sc, pa);
    }
    turn_begin();
    wgmma_fence();
    pv_product<D>(o, pa, k_tile(it) + C::KV_BYTES);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    release(it);
    ++it;
  }
  for (int j = max(j_stop, j_begin); j < j_end; ++j, ++it) {
    full_wait(it);
    release(it);
  }
  while (C::PING_PONG && turns <= n) {     // idle turns
    turn_begin();
    turn_end();
  }

  const int r0 = mk.r0 - q_off;             // back to rows of q and out
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int qi = r0 + 8 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* op = out + (int64_t(bh) * Sq + qi) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(op + nt * 8 + 2 * t) =
          pack_bf16(o[nt * 4 + 2 * i] / den, o[nt * 4 + 2 * i + 1] / den);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, S, D) bf16 as a 3-d tensor map of PANEL x 128 x 1 boxes
template <int D>
bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
              long long heads, int S) {
  using C = Cfg<D>;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(S) * D * 2};
  const cuuint32_t box[3] = {cuuint32_t(C::PANEL), cuuint32_t(kBN), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = C::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::SWZ == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                long long BH, int Sq, int Sk, int q_off, int group, int causal,
                int window, int has_cap, float cap, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(fn, &tq, q, BH, Sq) ||
      !make_map<D>(fn, &tk, k, BH / group, Sk) ||
      !make_map<D>(fn, &tv, v, BH / group, Sk))
    return cudaErrorInvalidValue;
  const int smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_qb = (Sq + kBM - 1) / kBM;
  if (BH * n_qb > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_tc_kernel<D><<<unsigned(BH * n_qb), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), int(BH), Sq, Sk, q_off,
      int(n_qb), group, causal, window, has_cap, cap,
      float(1.0 / sqrt(double(D))));
  return cudaGetLastError();
}

cudaError_t run_d(int D, const void* q, const void* k, const void* v,
                  void* out, long long BH, int Sq, int Sk, int q_off,
                  int group, int causal, int window, int has_cap, float cap,
                  cudaStream_t s) {
  switch (D) {
    case 16: return run<16>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 32: return run<32>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 64: return run<64>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    case 128: return run<128>(q, k, v, out, BH, Sq, Sk, q_off, group, causal, window, has_cap, cap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (the CUDA-core kernel above), 1 bfloat16 (the tensor-core
// kernel).  window <= 0: no window.  q_offset >= 0: the position of q's
// first row.  Returns the CUDA error of the launch (0 on success); the
// kernel runs on `stream`.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, long long BH,
                                      int Sq, int Sk, int q_offset, int D,
                                      int group, int causal, int window,
                                      int has_cap, float cap, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_offset < 0) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return int(run_d<float>(D, q, k, v, out, BH, Sq, Sk, q_offset, group,
                            causal, window, has_cap, cap, s));
  if (dtype == 1)
    return int(tc::run_d(D, q, k, v, out, BH, Sq, Sk, q_offset, group,
                         causal, window, has_cap, cap, s));
  return int(cudaErrorInvalidValue);
}
