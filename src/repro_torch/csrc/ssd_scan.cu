// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (pallas_call at :88, body _kernel at :30).  Same function: for each batch
// row b and head h, chunk after chunk, with cum = cumsum(dA) over the chunk,
//   y[q]  = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) xdt[k]
//           + exp(cum_q) (C_q . state)
//   state = exp(cum_last) state + sum_k B_k^T exp(cum_last - cum_k) xdt[k]
// in float32, the state starting at zero (or at init_state).  Layouts:
// xdt, y (B, nc, Q, H, P); dA (B, nc, Q, H); Bc, Cc (B, nc, Q, N); state
// (B, H, N, P).
//
// Bound: float32 operations.  At the serving shape (B 8, nc 8, Q 256, H 64,
// P = N = 64) the causal work is ~35 GFLOP against ~0.56 GB moved, so the
// CUDA cores' float32 rate bounds it before the memory rate does.
//
// Design (simple first version): one CTA of 256 threads per (b, tile of
// h_tile heads) walks its heads one after the other and, for each, the
// chunks in order, so the recurrence never leaves the CTA: the (N, P) state
// stays in shared memory across chunks (16 KiB at N = P = 64).  A chunk is
// cut into 64-row tiles.  For each q tile: the carry-in term C_q . state,
// then for each kv tile k <= q the 64x64 score tile
// (C_q B_k^T) exp(cum_q - cum_k) [k <= q] in shared memory and its product
// with the xdt tile.  Then the state update over the kv tiles, with
// exp(cum_last - cum_k) folded into B.  Every product keeps a 4 x (cols/16)
// block per thread in registers (rows ty + 16 i, columns tx + 16 j), with
// shared rows padded so a column walk hits distinct banks.  C B^T is
// recomputed per head (the TPU kernel shares it across its head tile);
// sharing it, and tensor cores, are for a later redesign.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows of a q / kv tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSS = kT + 16;   // row stride of the score tile
constexpr unsigned kFull = 0xffffffffu;

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ state_out, int nc, int Q, int H,
                int h_tile) {
  constexpr int CS = N + 1;     // padded row stride of the C and B tiles
  constexpr int CJ = P / 16;    // y / state columns per thread
  constexpr int RN = N / 16;    // state rows per thread
  extern __shared__ float smem[];
  float* cum = smem;            // Q
  float* Cq = cum + Q;          // kT x CS
  float* Bk = Cq + kT * CS;     // kT x CS
  float* Xk = Bk + kT * CS;     // kT x P
  float* Sc = Xk + kT * P;      // kT x kSS
  float* St = Sc + kT * kSS;    // N x P

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_ht = H / h_tile;
  const int b = blockIdx.x / n_ht;
  const int h_first = (blockIdx.x % n_ht) * h_tile;
  const int64_t HP = int64_t(H) * P;
  const int n_t = (Q + kT - 1) / kT;

  for (int h = h_first; h < h_first + h_tile; ++h) {
    const int64_t sbase = (int64_t(b) * H + h) * N * P;
    __syncthreads();            // the previous head is done with St
    for (int e = tid; e < N * P; e += kThreads)
      St[e] = init ? init[sbase + e] : 0.f;

    for (int c = 0; c < nc; ++c) {
      const int64_t row0 = (int64_t(b) * nc + c) * Q;   // first row of chunk
      __syncthreads();          // St ready; the last chunk is done with cum
      if (tid < 32) {           // cum = inclusive cumsum of dA[., h]: each
        const int per = (Q + 31) / 32;   // lane sums a segment, then the
        const int lo = min(Q, tid * per), hi = min(Q, lo + per);   // lane
        float run = 0.f;                 // totals are scanned by shuffles
        for (int qq = lo; qq < hi; ++qq) {
          run += dA[(row0 + qq) * H + h];
          cum[qq] = run;
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(kFull, incl, o);
          if (tid >= o) incl += t;
        }
        const float off = incl - run;
        for (int qq = lo; qq < hi; ++qq) cum[qq] += off;
      }
      __syncthreads();

      for (int qt = 0; qt < n_t; ++qt) {
        const int q0 = qt * kT;
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          Cq[r * CS + n] = q0 + r < Q ? Cc[(row0 + q0 + r) * N + n] : 0.f;
        }
        __syncthreads();

        // carry-in: (C_q . state) * exp(cum_q)
        float acc[4][CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float a[4], s[CJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Cq[(ty + 16 * i) * CS + n];
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[j] = St[n * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], s[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
          const float g = qi < Q ? expf(cum[qi]) : 0.f;
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] *= g;
        }

        // intra-chunk: kv tiles up to the diagonal
        for (int kt = 0; kt <= qt; ++kt) {
          const int k0 = kt * kT;
          __syncthreads();      // the last tile is done with Bk, Xk, Sc
          for (int e = tid; e < kT * N; e += kThreads) {
            const int r = e / N, n = e % N;
            Bk[r * CS + n] = k0 + r < Q ? Bc[(row0 + k0 + r) * N + n] : 0.f;
          }
          for (int e = tid; e < kT * P; e += kThreads) {
            const int r = e / P, p = e % P;
            Xk[r * P + p] = k0 + r < Q ? xdt[(row0 + k0 + r) * HP + h * P + p]
                                       : 0.f;
          }
          __syncthreads();
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            float a[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Cq[(ty + 16 * i) * CS + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = Bk[(tx + 16 * j) * CS + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qi = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int kj = k0 + tx + 16 * j;
              Sc[(ty + 16 * i) * kSS + tx + 16 * j] =
                  (kj <= qi && qi < Q) ? s[i][j] * expf(cum[qi] - cum[kj])
                                       : 0.f;
            }
          }
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < kT; ++kk) {
            float a[4], x[CJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Sc[(ty + 16 * i) * kSS + kk];
#pragma unroll
            for (int j = 0; j < CJ; ++j) x[j] = Xk[kk * P + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
          if (qi >= Q) continue;
          float* yp = y + (row0 + qi) * HP + h * P;
#pragma unroll
          for (int j = 0; j < CJ; ++j) yp[tx + 16 * j] = acc[i][j];
        }
        __syncthreads();        // the next q tile overwrites Cq
      }

      // state = exp(cum_last) state + sum_k (B_k exp(cum_last - cum_k))^T xdt_k
      const float last = cum[Q - 1];
      float sr[RN][CJ];
      const float g = expf(last);
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          sr[i][j] = g * St[(ty + 16 * i) * P + tx + 16 * j];
      for (int kt = 0; kt < n_t; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          Bk[r * CS + n] = k0 + r < Q ? Bc[(row0 + k0 + r) * N + n] *
                                            expf(last - cum[k0 + r])
                                      : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          Xk[r * P + p] = k0 + r < Q ? xdt[(row0 + k0 + r) * HP + h * P + p]
                                     : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; ++kk) {
          float a[RN], x[CJ];
#pragma unroll
          for (int i = 0; i < RN; ++i) a[i] = Bk[kk * CS + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < CJ; ++j) x[j] = Xk[kk * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RN; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) sr[i][j] = fmaf(a[i], x[j], sr[i][j]);
        }
      }
      // each thread rewrites only the state entries it read above
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          St[(ty + 16 * i) * P + tx + 16 * j] = sr[i][j];
    }

    __syncthreads();
    for (int e = tid; e < N * P; e += kThreads) state_out[sbase + e] = St[e];
  }
}

template <int N, int P>
cudaError_t run(const float* xdt, const float* dA, const float* Bc,
                const float* Cc, const float* init, float* y, float* state,
                int B, int nc, int Q, int H, int h_tile, cudaStream_t stream) {
  const int smem = int(sizeof(float)) *
                   (Q + 2 * kT * (N + 1) + kT * P + kT * kSS + N * P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<N, P><<<B * (H / h_tile), kThreads, smem, stream>>>(
      xdt, dA, Bc, Cc, init, y, state, nc, Q, H, h_tile);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_p(int P, const float* xdt, const float* dA, const float* Bc,
                  const float* Cc, const float* init, float* y, float* state,
                  int B, int nc, int Q, int H, int h_tile, cudaStream_t s) {
  switch (P) {
    case 16: return run<N, 16>(xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s);
    case 32: return run<N, 32>(xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s);
    case 64: return run<N, 64>(xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s);
    case 128: return run<N, 128>(xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// init may be null (state starts at zero).  Returns the CUDA error of the
// launch (0 on success); the kernel runs on `stream`.
extern "C" int ssd_scan_launch(const float* xdt, const float* dA,
                               const float* Bc, const float* Cc,
                               const float* init, float* y, float* state,
                               int B, int nc, int Q, int H, int P, int N,
                               int h_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_tile < 1 || H % h_tile != 0) return int(cudaErrorInvalidValue);
  switch (N) {
    case 16: return int(run_p<16>(P, xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s));
    case 32: return int(run_p<32>(P, xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s));
    case 64: return int(run_p<64>(P, xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s));
    case 128: return int(run_p<128>(P, xdt, dA, Bc, Cc, init, y, state, B, nc, Q, H, h_tile, s));
    default: return int(cudaErrorInvalidValue);
  }
}
