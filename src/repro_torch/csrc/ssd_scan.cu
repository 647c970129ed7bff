// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (pallas_call at :88, body _kernel at :30).  Same function: for each batch
// row b and head h, chunk after chunk, with cum = cumsum(dA) over the chunk,
//   y[q]  = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) xdt[k]
//           + exp(cum_q) (C_q . state)
//   state = exp(cum_last) state + sum_k B_k^T exp(cum_last - cum_k) xdt[k]
// in float32, the state starting at zero (or at init_state).  Layouts:
// xdt, y (B, nc, Q, H, P); dA (B, nc, Q, H); Bc, Cc (B, nc, Q, N) (one group:
// every head shares B and C); state (B, H, N, P).
//
// Bound: float32 operations.  At the serving shape (B 8, nc 8, Q 256, H 64,
// P = N = 64) the causal work is ~35 GFLOP against ~0.56 GB moved: 0.52 ms
// at the CUDA cores' 67 TFLOP/s, 0.21 ms as 3xTF32 (three TF32 products) at
// the tensor cores' 495 TFLOP/s, 0.17 ms for the bytes.
//
// Design: the chunked SSD decomposition, so only an elementwise pass is
// sequential over chunks and everything else is parallel over (b, chunk,
// head), in three kernels:
//   1. ssd_chunk_state, one CTA per (b, chunk, head): cum (kept for 3), and
//      the chunk-local state S_c = (B o exp(cum_last - cum))^T xdt, written
//      to a (B, nc, H, N, P) scratch with cum_last to a (B, nc, H) one; and
//      one CTA per causal 64 x 64 tile of each chunk: C B^T, computed once
//      for all heads (every head shares B and C) into a (B, nc, Q, Qa)
//      scratch that stays in L2;
//   2. ssd_state_pass, elementwise over (b, h, N, P), chunk after chunk:
//      state_in[c] = running state, then running = exp(cum_last[c]) running
//      + S_c; state_in overwrites S_c in place, the last running state is
//      the final state;
//   3. ssd_chunk_out, one CTA per (b, chunk, head, 64-row q tile):
//      y = exp(cum_q) (C state_in[c]) + (C B^T o exp(cum_q - cum_k) o [k<=q]) xdt,
//      the decay o mask factor made in registers as the A fragment from the
//      C B^T tile and cum.
// Every product runs on the tensor cores as mma.sync.m16n8k8 in 3xTF32:
// each float32 operand splits into a TF32 high part and a TF32 remainder,
// and lo*hi + hi*lo + hi*hi sum in float32, which keeps float32 accuracy
// (plain TF32 would not).  The product kernels are CTAs of 4 warps, four to
// an SM, so one CTA's loads overlap another's products; their operands
// stream through three cp.async stages of 32 keys with padded rows (every
// fragment load hits 32 distinct banks).  Causal q tiles of one (b, chunk,
// head) are neighbours, heaviest first.  There is no head tile on the card:
// the TPU contract's h_tile is checked by the wrapper only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // rows of a q tile (and of a C B^T tile)
constexpr int kKT = 32;         // keys (or state rows) of a streamed tile
constexpr int kStages = 3;      // cp.async stages of the streamed tiles
constexpr int kWarps = 4;       // the product kernels: 4 warps of 16 rows
constexpr int kThreads = 256;   // threads of the state-passing kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo: hi is x with the 13 mantissa bits TF32 lacks cleared, lo the
// exact remainder, which the tensor core reads as TF32 (dropping its own low
// 13 bits, about 2^-21 of |x|).  Two instructions, where rounding both
// parts with cvt.rna takes five.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}
// not volatile: a pure function of its operands, so the compiler may
// interleave independent products instead of waiting out each one's latency
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// rows x cols floats (cols a multiple of 4) from src (row stride src_stride)
// into dst (row stride dst_stride); rows >= valid are zero-filled.  Threads
// tid = 0 .. nthreads - 1 share the copy.
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const float* src, int64_t src_stride,
                                          int rows, int valid, int cols,
                                          int tid, int nthreads) {
  const int per = cols / 4;
  for (int e = tid; e < rows * per; e += nthreads) {
    const int r = e / per, c = (e % per) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * dst_stride + c, ok ? src + r * src_stride + c : src,
               ok);
  }
}

// one warp: cum[q] = sum_{q' <= q} dA[(row0 + q') * H + h], q < Q.  Rows
// lane, lane + 32, ... ; eight rows' loads are issued together, then each
// 32-row slice is scanned by shuffles and carried into the next.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ dA,
                                            int64_t row0, int H, int h, int Q,
                                            float* cum, int lane) {
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += 256) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + 32 * i + lane;
      v[i] = q < Q ? dA[(row0 + q) * H + h] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = v[i];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      const int q = q0 + 32 * i + lane;
      if (q < Q) cum[q] = x;
      carry = __shfl_sync(kFull, x, 31);
    }
  }
  __syncwarp();
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// The product kernels are small CTAs of 4 warps (several resident per SM,
// so one CTA's loads overlap another's products).  Their operands stream
// through kStages cp.async stages of kKT keys; every product is an
// mma.sync.m16n8k8 in 3xTF32 (see split), the B fragments split as they are
// read.  Warp w owns 16 rows of the output at its full width.
// ---------------------------------------------------------------------------

// acc[nt] += A (16 x 8, split into ah, al) times rows k, k + 4 of the tile
// xs (row stride XS), every 8-column block nt: the small cross terms first.
template <int NT, int XS>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* xs, int k, int g) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t h0, l0, h1, l1;
    split(xs[k * XS + nt * 8 + g], h0, l0);
    split(xs[(k + 4) * XS + nt * 8 + g], h1, l1);
    mma_tf32(acc[nt], al, h0, h1);
    mma_tf32(acc[nt], ah, l0, l1);
    mma_tf32(acc[nt], ah, h0, h1);
  }
}

// The three-stage pipeline of a product kernel: issue(i) queues the
// cp.async loads of tile i (nothing past the last), compute(i) reads it.
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int n_tiles, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // tile i landed; tile i - 1 is read
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    compute(i);
  }
}

// ---------------------------------------------------------------------------
// 1. ssd_chunk_state.  CTAs below B nc H, one per (b, chunk, head): cum
//    (written to cum_out, (B, nc, H, Qa)), cum_last, and the chunk-local
//    state S_c = (B o exp(cum_last - cum))^T xdt (N x P), the warps taking
//    16-row groups of N.  The CTAs after them, one per causal 64 x 64 tile
//    of each chunk, write C B^T to cb_out ((B, nc, Q, Qa); every head shares
//    it).
// ---------------------------------------------------------------------------
template <int N, int P>
__global__ void __launch_bounds__(kWarps * 32, 3)
ssd_chunk_state(const float* __restrict__ xdt, const float* __restrict__ dA,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                float* __restrict__ S, float* __restrict__ last,
                float* __restrict__ cum_out, float* __restrict__ cb_out,
                int n_bc, int Q, int H) {
  constexpr int NT = P / 8;
  constexpr int RPW = N > 64 ? N / 64 : 1;   // row groups of a warp
  constexpr int BS = N + 8, XS = P + 8;      // conflict-free fragment reads
  constexpr int STAGE = kKT * (BS + XS);
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int Qa = round4(Q);
  const int64_t HP = int64_t(H) * P;

  if (int(blockIdx.x) >= n_bc * H) {         // a C B^T tile
    constexpr int CS = N + 4;
    const int n_qt = (Q + kT - 1) / kT, per = n_qt * (n_qt + 1) / 2;
    const int idx = blockIdx.x - n_bc * H;
    const int bc = idx / per;
    int r = idx % per, qt = 0;
    while (r > qt) r -= ++qt;                // tile (qt, r), r <= qt
    const int q0 = qt * kT, k0 = r * kT;
    const int64_t row0 = int64_t(bc) * Q;
    float* Cs = smem;                        // kT x CS
    float* Bs = Cs + kT * CS;                // kT x CS
    load_rows(Cs, CS, Cc + (row0 + q0) * N, N, kT, min(kT, Q - q0), N,
              threadIdx.x, kWarps * 32);
    load_rows(Bs, CS, Bc + (row0 + k0) * N, N, kT, min(kT, Q - k0), N,
              threadIdx.x, kWarps * 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int lr = warp * 16 + g;
    float acc[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      const int ca = ks * 8 + t;
      const float a[4] = {Cs[lr * CS + ca], Cs[(lr + 8) * CS + ca],
                          Cs[lr * CS + ca + 4], Cs[(lr + 8) * CS + ca + 4]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t h0, l0, h1, l1;
        split(Bs[(nt * 8 + g) * CS + ca], h0, l0);
        split(Bs[(nt * 8 + g) * CS + ca + 4], h1, l1);
        mma_tf32(acc[nt], al, h0, h1);
        mma_tf32(acc[nt], ah, l0, l1);
        mma_tf32(acc[nt], ah, h0, h1);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + lr + 8 * e;
      if (q >= Q) continue;
      float* cp = cb_out + (row0 + q) * Qa + k0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int k = nt * 8 + 2 * t;
        if (k0 + k < Qa)                     // Qa - k0 is a multiple of 4
          *reinterpret_cast<float2*>(cp + k) =
              make_float2(acc[nt][2 * e], acc[nt][2 * e + 1]);
      }
    }
    return;
  }

  const int bc = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t row0 = int64_t(bc) * Q;
  float* dec = smem;                         // Qa
  float* stages = dec + Qa;                  // kStages x (B tile, xdt tile)
  const int n_tiles = (Q + kKT - 1) / kKT;
  auto issue = [&](int i) {
    const int k0 = i * kKT, valid = min(kKT, Q - k0);
    float* st = stages + (i % kStages) * STAGE;
    load_rows(st, BS, Bc + (row0 + k0) * N, N, kKT, valid, N, threadIdx.x,
              kWarps * 32);
    load_rows(st + kKT * BS, XS, xdt + (row0 + k0) * HP + int64_t(h) * P, HP,
              kKT, valid, P, threadIdx.x, kWarps * 32);
  };
  if (warp == 0) {
    warp_cumsum(dA, row0, H, h, Q, dec, lane);
    const float cl = dec[Q - 1];
    float* co = cum_out + (int64_t(bc) * H + h) * Qa;
    for (int q = lane; q < Q; q += 32) co[q] = dec[q];
    if (lane == 0) last[int64_t(bc) * H + h] = cl;
    __syncwarp();
    for (int q = lane; q < Q; q += 32) dec[q] = expf(cl - dec[q]);
  }
  float acc[RPW][NT][4];
#pragma unroll
  for (int u = 0; u < RPW; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
  pipeline(n_tiles, issue, [&](int i) {
    const int k0 = i * kKT, valid = min(kKT, Q - k0);
    const float* Bt = stages + (i % kStages) * STAGE;
    const float* Xt = Bt + kKT * BS;
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int rn = (warp + kWarps * u) * 16 + g;
      if (rn - g >= N) continue;
      for (int ks = 0; ks * 8 < valid; ++ks) {
        const int ka = ks * 8 + t, kb = ka + 4;
        const float da = k0 + ka < Q ? dec[k0 + ka] : 0.f;
        const float db = k0 + kb < Q ? dec[k0 + kb] : 0.f;
        const float a[4] = {Bt[ka * BS + rn] * da, Bt[ka * BS + rn + 8] * da,
                            Bt[kb * BS + rn] * db, Bt[kb * BS + rn + 8] * db};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        mma_row<NT, XS>(acc[u], ah, al, Xt, ka, g);
      }
    }
  });
  float* sp = S + (int64_t(bc) * H + h) * N * P;
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    const int rn = (warp + kWarps * u) * 16 + g;
    if (rn - g >= N) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(sp + (rn + 8 * e) * P + nt * 8 + 2 * t) =
            make_float2(acc[u][nt][2 * e], acc[u][nt][2 * e + 1]);
  }
}

// ---------------------------------------------------------------------------
// 2. state passing, elementwise over (b, h, N, P), 4 floats a thread:
//    S[b, c] <- state_in[c]; state_out = the state after the last chunk.
//    The chunks' loads are issued four at a time, ahead of the recurrence.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ S, const float* __restrict__ last,
               const float* __restrict__ init, float* __restrict__ state_out,
               int B, int nc, int H, int NP) {
  const int64_t total4 = int64_t(B) * H * NP / 4;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total4;
       e += int64_t(gridDim.x) * blockDim.x) {
    const int64_t i = e * 4, bh = i / NP;
    const int np = int(i % NP), b = int(bh / H), h = int(bh % H);
    float4 run = init ? *reinterpret_cast<const float4*>(init + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nc; c0 += 4) {
      float4 s[4];
      float gd[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u >= nc) break;
        const int64_t bch = (int64_t(b) * nc + c0 + u) * H + h;
        s[u] = *reinterpret_cast<const float4*>(S + bch * NP + np);
        gd[u] = last[bch];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u >= nc) break;
        const int64_t bch = (int64_t(b) * nc + c0 + u) * H + h;
        *reinterpret_cast<float4*>(S + bch * NP + np) = run;
        const float d = expf(gd[u]);
        run = make_float4(fmaf(d, run.x, s[u].x), fmaf(d, run.y, s[u].y),
                          fmaf(d, run.z, s[u].z), fmaf(d, run.w, s[u].w));
      }
    }
    *reinterpret_cast<float4*>(state_out + i) = run;
  }
}

// ---------------------------------------------------------------------------
// 3. ssd_chunk_out, one CTA per (b, chunk, head, 64-row q tile): the carry-
//    in exp(cum_q) (C state_in[c]) from tiles of C columns and state rows,
//    then (C B^T o exp(cum_q - cum_k) o [k <= q]) xdt over the key tiles up
//    to the diagonal, the decay and mask made in registers as the A
//    fragment from the C B^T tile and cum.
// ---------------------------------------------------------------------------
template <int N, int P>
__global__ void __launch_bounds__(kWarps * 32, 4)
ssd_chunk_out(const float* __restrict__ xdt, const float* __restrict__ Cc,
              const float* __restrict__ S, const float* __restrict__ cum_in,
              const float* __restrict__ cb, float* __restrict__ y, int n_bc,
              int Q, int H) {
  constexpr int NT = P / 8;
  constexpr int AS = kKT + 4, XS = P + 8;    // conflict-free fragment reads
  constexpr int STAGE = kT * AS + kKT * XS;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int Qa = round4(Q), n_qt = (Q + kT - 1) / kT;
  // the q tiles of one (b, chunk, head) are neighbours, heaviest first, so
  // the xdt rows they share come from L2
  const int bch = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int bc = bch / H, h = bch % H;
  const int q0 = qt * kT;
  const int64_t row0 = int64_t(bc) * Q;
  const int64_t HP = int64_t(H) * P;
  float* cum = smem;                         // Qa
  float* stages = cum + Qa;                  // kStages x (A tile, B tile)
  const int n_st = (N + kKT - 1) / kKT;      // tiles of C columns / state rows
  const int n_xt = (min(Q, q0 + kT) + kKT - 1) / kKT;   // key tiles
  const int lr = warp * 16 + g, qa = q0 + lr, qb = qa + 8;
  const float* st_in = S + (int64_t(bc) * H + h) * N * P;

  // cum of this head (the first stage's group)
  load_rows(cum, Qa, cum_in + (int64_t(bc) * H + h) * Qa, 0, 1, 1, Qa,
            threadIdx.x, kWarps * 32);
  auto issue = [&](int i) {
    float* at = stages + (i % kStages) * STAGE;
    float* xt = at + kT * AS;
    if (i < n_st) {                          // C columns n0.., state rows n0..
      const int n0 = i * kKT, nr = min(kKT, N - n0);
      load_rows(at, AS, Cc + (row0 + q0) * N + n0, N, kT, min(kT, Q - q0),
                nr, threadIdx.x, kWarps * 32);
      load_rows(xt, XS, st_in + int64_t(n0) * P, P, nr, nr, P, threadIdx.x,
                kWarps * 32);
    } else {                                 // C B^T columns k0.., xdt rows k0..
      const int k0 = (i - n_st) * kKT;
      load_rows(at, AS, cb + (row0 + q0) * Qa + k0, Qa, kT, min(kT, Q - q0),
                min(kKT, Qa - k0), threadIdx.x, kWarps * 32);
      load_rows(xt, XS, xdt + (row0 + k0) * HP + int64_t(h) * P, HP, kKT,
                min(kKT, Q - k0), P, threadIdx.x, kWarps * 32);
    }
  };
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  pipeline(n_st + n_xt, issue, [&](int i) {
    const float* at = stages + (i % kStages) * STAGE;
    const float* xt = at + kT * AS;
    if (i < n_st) {
      const int nr = min(kKT, N - i * kKT);
      for (int ks = 0; ks * 8 < nr; ++ks) {
        const int ka = ks * 8 + t;
        const float a[4] = {at[lr * AS + ka], at[(lr + 8) * AS + ka],
                            at[lr * AS + ka + 4], at[(lr + 8) * AS + ka + 4]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
        mma_row<NT, XS>(acc, ah, al, xt, ka, g);
      }
      if (i == n_st - 1) {                   // carry-in done: times exp(cum)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = qa + 8 * e;
          const float f = q < Q ? expf(cum[q]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[nt][2 * e] *= f;
            acc[nt][2 * e + 1] *= f;
          }
        }
      }
      return;
    }
    const int k0 = (i - n_st) * kKT;
    const float cqa = qa < Q ? cum[qa] : 0.f, cqb = qb < Q ? cum[qb] : 0.f;
#pragma unroll
    for (int ks = 0; ks < kKT / 8; ++ks) {
      if (k0 + ks * 8 > q0 + warp * 16 + 15) break;   // past the diagonal
      const int ka = ks * 8 + t, kb = ka + 4;
      const int ka_ = k0 + ka, kb_ = k0 + kb;
      const float cka = ka_ < Q ? cum[ka_] : 0.f, ckb = kb_ < Q ? cum[kb_] : 0.f;
      const float a[4] = {
          ka_ <= qa && qa < Q ? at[lr * AS + ka] * ex2((cqa - cka) * kLog2e)
                              : 0.f,
          ka_ <= qb && qb < Q
              ? at[(lr + 8) * AS + ka] * ex2((cqb - cka) * kLog2e)
              : 0.f,
          kb_ <= qa && qa < Q ? at[lr * AS + kb] * ex2((cqa - ckb) * kLog2e)
                              : 0.f,
          kb_ <= qb && qb < Q
              ? at[(lr + 8) * AS + kb] * ex2((cqb - ckb) * kLog2e)
              : 0.f};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      mma_row<NT, XS>(acc, ah, al, xt, ka, g);
    }
  });
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = qa + 8 * e;
    if (q >= Q) continue;
    float* yp = y + (row0 + q) * HP + int64_t(h) * P;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(yp + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * e], acc[nt][2 * e + 1]);
  }
}

template <int N, int P>
int smem_state() {
  const int states = kStages * kKT * (N + 8 + P + 8);
  const int cb = 2 * kT * (N + 4);
  return states > cb ? states : cb;           // + Qa floats, at run time
}
template <int N, int P>
int smem_out() {
  return kStages * (kT * (kKT + 4) + kKT * (P + 8));   // + Qa floats
}

template <int N, int P>
cudaError_t run(const float* xdt, const float* dA, const float* Bc,
                const float* Cc, const float* init, float* y, float* state,
                float* S, float* last, float* cum, float* cb, int B, int nc,
                int Q, int H, cudaStream_t stream) {
  const int Qa = round4(Q), n_qt = (Q + kT - 1) / kT, n_bc = B * nc;
  const int s_state = 4 * (smem_state<N, P>() + Qa);
  const int s_out = 4 * (smem_out<N, P>() + Qa);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s_state);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out<N, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             s_out);
  if (err != cudaSuccess) return err;
  const long long n_state = (long long)n_bc * H,
                  n_cb = (long long)n_bc * (n_qt * (n_qt + 1) / 2);
  ssd_chunk_state<N, P><<<unsigned(n_state + n_cb), kWarps * 32, s_state,
                          stream>>>(xdt, dA, Bc, Cc, S, last, cum, cb, n_bc, Q,
                                    H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = (long long)B * H * N * P / 4;
  const unsigned pass_blocks = unsigned((n4 + kThreads - 1) / kThreads);
  ssd_state_pass<<<pass_blocks, kThreads, 0, stream>>>(S, last, init, state,
                                                      B, nc, H, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_out<N, P><<<unsigned(n_state * n_qt), kWarps * 32, s_out,
                        stream>>>(xdt, Cc, S, cum, cb, y, n_bc, Q, H);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_p(int P, const float* xdt, const float* dA, const float* Bc,
                  const float* Cc, const float* init, float* y, float* state,
                  float* S, float* last, float* cum, float* cb, int B, int nc,
                  int Q, int H, cudaStream_t s) {
  switch (P) {
    case 16: return run<N, 16>(xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s);
    case 32: return run<N, 32>(xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s);
    case 64: return run<N, 64>(xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s);
    case 128: return run<N, 128>(xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// init may be null (state starts at zero).  Float32 scratch: S (B, nc, H,
// N, P), last (B, nc, H), cum (B, nc, H, Qa) and cb (B, nc, Q, Qa), Qa = Q
// rounded up to a multiple of 4.  Three kernels run on `stream`, in order;
// returns the first CUDA launch error (0 on success).
extern "C" int ssd_scan_launch(const float* xdt, const float* dA,
                               const float* Bc, const float* Cc,
                               const float* init, float* y, float* state,
                               float* S, float* last, float* cum, float* cb,
                               int B, int nc, int Q, int H, int P, int N,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return int(run_p<16>(P, xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s));
    case 32: return int(run_p<32>(P, xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s));
    case 64: return int(run_p<64>(P, xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s));
    case 128: return int(run_p<128>(P, xdt, dA, Bc, Cc, init, y, state, S, last, cum, cb, B, nc, Q, H, s));
    default: return int(cudaErrorInvalidValue);
  }
}
