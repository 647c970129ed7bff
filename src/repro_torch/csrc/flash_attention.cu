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
// kernel's `needed` test applied to this kernel's blocks.
//
// Bound: operations.  At the serving shape (BH 256, S 2048, D 64, causal)
// the two products are ~137 GFLOP against ~268 MB of inputs and output,
// well above the H100's ~295 FLOP per byte in bf16, so the tensor-core rate
// bounds it.  This first version is simple: one CTA of 256 threads per
// (head, 64-row q block) loops over 64-row kv blocks on the CUDA cores in
// float32.  Tiles live in shared memory as float32 (rows padded by one word
// so a column walk hits distinct banks); each thread holds a 4x4 block of
// the score tile and a 4 x D/16 block of acc in registers (rows ty + 16 i,
// columns tx + 16 j), and the row max and row sum reduce over the 16
// threads of a row with shuffles.  wgmma / TMA are for a later redesign.
#include <climits>
#include <cstdint>
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
                 int n_qb, int group, int causal, int window, int has_cap,
                 float cap, float scale) {
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
  const int q0 = (blockIdx.x % n_qb) * kBQ;
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
  if (causal) j_end = min(n_kb, (q0 + kBQ - 1) / kBK + 1);
  if (window > 0) {
    const int lo = q0 - (window - 1) - (kBK - 1);   // need j * kBK >= lo
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
      const int qi = q0 + ty + 16 * i;
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
                long long BH, int Sq, int Sk, int group, int causal,
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
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, int(n_qb),
      group, causal, window, has_cap, cap, float(1.0 / sqrt(double(D))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int D, const void* q, const void* k, const void* v,
                  void* out, long long BH, int Sq, int Sk, int group,
                  int causal, int window, int has_cap, float cap,
                  cudaStream_t s) {
  switch (D) {
    case 16: return run<T, 16>(q, k, v, out, BH, Sq, Sk, group, causal, window, has_cap, cap, s);
    case 32: return run<T, 32>(q, k, v, out, BH, Sq, Sk, group, causal, window, has_cap, cap, s);
    case 64: return run<T, 64>(q, k, v, out, BH, Sq, Sk, group, causal, window, has_cap, cap, s);
    case 128: return run<T, 128>(q, k, v, out, BH, Sq, Sk, group, causal, window, has_cap, cap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  Returns the CUDA
// error of the launch (0 on success); the kernel runs on `stream`.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, long long BH,
                                      int Sq, int Sk, int D, int group,
                                      int causal, int window, int has_cap,
                                      float cap, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(run_d<float>(D, q, k, v, out, BH, Sq, Sk, group, causal,
                            window, has_cap, cap, s));
  if (dtype == 1)
    return int(run_d<__nv_bfloat16>(D, q, k, v, out, BH, Sq, Sk, group,
                                    causal, window, has_cap, cap, s));
  return int(cudaErrorInvalidValue);
}
