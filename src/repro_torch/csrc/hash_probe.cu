// Batched MICA bucket probe for Hopper (sm_90a): the one-sided bucket read
// fused with the lookup_end check.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_probe.py::hash_probe
// (pallas_call at :53, body _kernel at :29), and extends it with what the
// dataplane's probe needs: many arenas (one per simulated node), a word
// offset per lane instead of a bucket index, the exact-slot rule for address
// cache hits, and the matched slot's index within the read window.
//
// Per lane: gather `width` slots of 32 words starting at word `off` of arena
// `dest`, match key_lo/key_hi against slots with an even version and
// lock == 0 (cache-hit lanes: window position 0 only), and return
//   found, version and the 27 value words of the first match (slot 0 when
//   nothing matches; with zero_miss the value words are zeros on a miss),
//   local_idx = index of the first match (0 on a miss).
// Word addresses follow the reference gather: off + j wraps in 32 bits, is
// read as int32 and clamped into [0, n_words - 1].  A lane that is not live
// (or names no valid arena) reads all-zero words, as an undelivered one-sided
// read does in the reference.
//
// Bound: bytes.  Each live lane reads width * 128 B of slot lines, and every
// lane reads 18 B of inputs and writes 117 B; the card's memory rate bounds
// it.  A gather of scattered 128 B lines reaches that rate only with many
// lines in flight at once, so the design is about memory parallelism:
//
// * A CTA of 128 threads takes L consecutive lanes (the wrapper's choice,
//   hash_probe.py::lanes_per_cta: 128 at width 1, halving as the line
//   doubles, so the tile of lines stays near 16 KB, several CTAs share an
//   SM and 32,768 lanes at width 1 fit in one wave).  Thread t < L loads
//   lane t's inputs, so each input is one coalesced load per warp, and
//   classifies the lane: fast (live, a valid arena, the whole line in
//   bounds with no wrap or clamp, and the 16 B-aligned span around it
//   inside the arenas) or slow (anything else).
// * Every fast line of the CTA is put in flight at once, into the lane's row
//   of a shared-memory tile: the CTA's 16 B chunks are spread over its
//   threads, each of which issues all its loads before it stores any.
//   Arena rows need not be 16 B aligned (n_words is often 2 mod 4, and a
//   row view's base is anywhere): the copy takes the aligned span around
//   the line and the lane indexes its row from the line's word offset
//   within the first 16 B.  Slow lanes fill their row word by word under
//   the clamp rule; dead lanes read no row.  (One cp.async.bulk per lane
//   completing on an mbarrier measured no faster: PERF.md.)
// * Thread t matches lane t's slots from the tile and stores found, version
//   and local_idx coalesced; the CTA's L x 27 value words are one
//   contiguous span of `value`, copied out of the tile by all threads in a
//   strided loop (never one 108 B row per lane).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlotWords = 32;
constexpr int kValue0 = 5;
constexpr int kValueWords = kSlotWords - kValue0;
constexpr int kThreads = 128;           // also the most lanes a CTA takes
// 16 B chunks one thread keeps in flight: a CTA's tile (lanes x the
// aligned span of a line) holds at most 9 x 128 of them (18 KB: 128 lanes
// at width 1, 16 at width 8), so all its lines are in flight at once
constexpr int kBatch = 9;
constexpr int kDead = 0, kFast = 1, kSlow = 2;

template <int W>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ arenas, int64_t n_nodes,
                  int64_t n_words, const int32_t* __restrict__ dest,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ key_lo,
                  const int32_t* __restrict__ key_hi,
                  const bool* __restrict__ live,
                  const bool* __restrict__ cache_hit, int lanes,
                  int zero_miss, int64_t m, bool* __restrict__ found,
                  int32_t* __restrict__ version, int32_t* __restrict__ value,
                  int32_t* __restrict__ local_idx,
                  int32_t* __restrict__ n_fast_out) {
  constexpr int kLine = W * kSlotWords;  // words of a lane's line
  constexpr int kRow = kLine + 4;        // tile row: the line's aligned span
  constexpr int kChunks = kRow / 4;      // 16 B chunks of a row
  extern __shared__ int4 tile16[];       // lanes x kRow words
  int32_t* tile = reinterpret_cast<int32_t*>(tile16);
  __shared__ const int4* src[kThreads];  // a fast lane's aligned span
  __shared__ int chunks[kThreads];       // its 16 B chunks (0: not fast)
  __shared__ int sel[kThreads];          // tile word of its value, -1: zeros

  const int t = threadIdx.x;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * lanes;
  const int nl = static_cast<int>(m - lane0 < lanes ? m - lane0 : lanes);

  // --- lane inputs (thread t: lane lane0 + t) and the lane's class --------
  int kind = kDead, shift = 0, n16 = 0;
  int32_t klo = 0, khi = 0, o = 0;
  bool hit = false;
  const int32_t* row = arenas;
  const int4* lo = nullptr;
  if (t < nl) {
    const int64_t lane = lane0 + t;
    const int32_t d = dest[lane];
    o = off[lane];
    klo = key_lo[lane];
    khi = key_hi[lane];
    hit = cache_hit[lane];
    if (live[lane] && d >= 0 && d < n_nodes) {
      row = arenas + static_cast<int64_t>(d) * n_words;
      kind = kSlow;
      const int64_t end = n_words < (1ll << 31) ? n_words : (1ll << 31);
      if (o >= 0 && static_cast<int64_t>(o) + kLine <= end) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(row + o);
        const uintptr_t a0 = a & ~uintptr_t(15);
        const uintptr_t a1 = (a + kLine * 4 + 15) & ~uintptr_t(15);
        if (a0 >= reinterpret_cast<uintptr_t>(arenas) &&
            a1 <= reinterpret_cast<uintptr_t>(arenas + n_nodes * n_words)) {
          kind = kFast;
          shift = static_cast<int>(a - a0) >> 2;
          n16 = static_cast<int>(a1 - a0) >> 4;
          lo = reinterpret_cast<const int4*>(a0);
        }
      }
    }
    src[t] = lo;
    chunks[t] = n16;
  }
  // all lanes classified before any copy
  const int n_fast = __syncthreads_count(kind == kFast);
  if (n_fast_out != nullptr && t == 0 && n_fast > 0)
    atomicAdd(n_fast_out, n_fast);

  // --- every fast line in flight at once -----------------------------------
  if (n_fast > 0) {
    int4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = t + k * kThreads;
      const int l = c / kChunks;
      if (c < nl * kChunks && c - l * kChunks < chunks[l])
        v[k] = __ldg(src[l] + (c - l * kChunks));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = t + k * kThreads;
      const int l = c / kChunks;
      if (c < nl * kChunks && c - l * kChunks < chunks[l])
        tile16[c] = v[k];               // row l, chunk c - l * kChunks
    }
  }
  // slow lanes: word by word under the reference's wrap and clamp rule
  if (kind == kSlow) {
#pragma unroll 8
    for (int j = 0; j < kLine; ++j) {
      int64_t i = static_cast<int32_t>(static_cast<uint32_t>(o) + j);
      i = i < 0 ? 0 : (i >= n_words ? n_words - 1 : i);
      tile[t * kRow + j] = __ldg(row + i);
    }
  }
  __syncthreads();

  // --- match lane t's slots from the tile ----------------------------------
  if (t < nl) {
    const int32_t* r = tile + t * kRow + shift;
    int first = -1;
    int32_t ver = 0;
    if (kind != kDead) {
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const bool ok = r[s * kSlotWords] == klo &&
                        r[s * kSlotWords + 1] == khi &&
                        (r[s * kSlotWords + 2] & 1) == 0 &&
                        r[s * kSlotWords + 3] == 0 && (s == 0 || !hit);
        if (ok && first < 0) first = s;
      }
      ver = r[(first < 0 ? 0 : first) * kSlotWords + 2];
    } else if (klo == 0 && khi == 0) {
      first = 0;  // all-zero words: slot 0 matches a zero key
    }
    const int64_t lane = lane0 + t;
    found[lane] = first >= 0;
    version[lane] = ver;
    local_idx[lane] = first < 0 ? 0 : first;
    sel[t] = (kind == kDead || (zero_miss && first < 0))
                 ? -1
                 : t * kRow + shift + (first < 0 ? 0 : first) * kSlotWords +
                       kValue0;
  }
  __syncthreads();

  // --- the CTA's value words: one contiguous span, coalesced stores ---------
  int32_t* out = value + lane0 * kValueWords;
  for (int i = t; i < nl * kValueWords; i += kThreads) {
    const int l = i / kValueWords;
    const int s0 = sel[l];
    out[i] = s0 < 0 ? 0 : tile[s0 + (i - l * kValueWords)];
  }
}

template <int W>
int launch(const void* arenas, long long n_nodes, long long n_words,
           const void* dest, const void* off, const void* key_lo,
           const void* key_hi, const void* live, const void* cache_hit,
           int lanes, int zero_miss, long long m, void* found, void* version,
           void* value, void* local_idx, void* n_fast, cudaStream_t stream) {
  constexpr int kChunks = W * kSlotWords / 4 + 1;   // of a tile row
  if (lanes < 1 || lanes > kThreads || lanes * kChunks > kBatch * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 16 * static_cast<size_t>(lanes) * kChunks;
  const long long blocks = (m + lanes - 1) / lanes;
  hash_probe_kernel<W><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const int32_t*>(arenas), n_nodes, n_words,
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(key_lo), static_cast<const int32_t*>(key_hi),
      static_cast<const bool*>(live), static_cast<const bool*>(cache_hit),
      lanes, zero_miss, m, static_cast<bool*>(found),
      static_cast<int32_t*>(version), static_cast<int32_t*>(value),
      static_cast<int32_t*>(local_idx), static_cast<int32_t*>(n_fast));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `lanes` is the number of lanes
// one CTA takes (1..128, with a tile of at most kBatch x 128 16 B chunks);
// the wrapper chooses it (hash_probe.py::lanes_per_cta).  `n_fast`, when not null, points to an
// int32 on the card to which the kernel adds the number of lanes whose line
// it copied whole (its fast path).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() of the launch (0 = success;
// cudaErrorInvalidValue for a width or lane count the kernel does not take).
extern "C" int hash_probe_launch(const void* arenas, long long n_nodes,
                                 long long n_words, const void* dest,
                                 const void* off, const void* key_lo,
                                 const void* key_hi, const void* live,
                                 const void* cache_hit, int width, int lanes,
                                 int zero_miss, long long m, void* found,
                                 void* version, void* value, void* local_idx,
                                 void* n_fast, void* stream) {
  if (m <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define HASH_PROBE_WIDTH(W)                                                  \
  case W:                                                                    \
    return launch<W>(arenas, n_nodes, n_words, dest, off, key_lo, key_hi,   \
                     live, cache_hit, lanes, zero_miss, m, found, version,  \
                     value, local_idx, n_fast, s);
  switch (width) {
    HASH_PROBE_WIDTH(1)
    HASH_PROBE_WIDTH(2)
    HASH_PROBE_WIDTH(3)
    HASH_PROBE_WIDTH(4)
    HASH_PROBE_WIDTH(5)
    HASH_PROBE_WIDTH(6)
    HASH_PROBE_WIDTH(7)
    HASH_PROBE_WIDTH(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HASH_PROBE_WIDTH
}
