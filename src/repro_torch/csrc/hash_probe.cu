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
// Bound: bytes.  Each lane reads width * 128 B of slot lines plus ~22 B of
// lane inputs and writes ~120 B; the card's memory rate bounds it.  Design:
// one warp per lane, thread t loads word t of each slot, so every slot is
// one coalesced 128 B line.  The header words reach all threads by
// __shfl_sync, which makes the match warp-uniform, so the first match is a
// scalar carried through the slot loop; threads 5..31 store the value words
// (one 108 B contiguous store per lane).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlotWords = 32;
constexpr int kValue0 = 5;
constexpr int kValueWords = kSlotWords - kValue0;
constexpr int kLanesPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kLanesPerBlock)
hash_probe_kernel(const int32_t* __restrict__ arenas, int64_t n_nodes,
                  int64_t n_words, const int32_t* __restrict__ dest,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ key_lo,
                  const int32_t* __restrict__ key_hi,
                  const bool* __restrict__ live,
                  const bool* __restrict__ cache_hit, int width,
                  int zero_miss, int64_t m, bool* __restrict__ found,
                  int32_t* __restrict__ version, int32_t* __restrict__ value,
                  int32_t* __restrict__ local_idx) {
  const int t = threadIdx.x & 31;
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + (threadIdx.x >> 5);
  if (lane >= m) return;  // the whole warp leaves together

  const int32_t d = dest[lane];
  const bool on = live[lane] && d >= 0 && d < n_nodes;
  const int32_t* arena = arenas + (on ? static_cast<int64_t>(d) : 0) * n_words;
  const uint32_t start = static_cast<uint32_t>(off[lane]);
  const int32_t klo = key_lo[lane];
  const int32_t khi = key_hi[lane];
  const bool hit = cache_hit[lane];

  int first = -1;
  int32_t w0 = 0;
  int32_t wsel = 0;
  for (int s = 0; s < width; ++s) {
    int32_t w = 0;
    if (on) {
      const uint32_t a = start + static_cast<uint32_t>(s * kSlotWords + t);
      int64_t i = static_cast<int32_t>(a);  // the reference reads it as int32
      i = i < 0 ? 0 : (i >= n_words ? n_words - 1 : i);
      w = __ldg(arena + i);
    }
    const int32_t kl = __shfl_sync(kFull, w, 0);
    const int32_t kh = __shfl_sync(kFull, w, 1);
    const int32_t ver = __shfl_sync(kFull, w, 2);
    const int32_t lk = __shfl_sync(kFull, w, 3);
    const bool ok = kl == klo && kh == khi && (ver & 1) == 0 && lk == 0 &&
                    (s == 0 || !hit);
    if (s == 0) w0 = w;
    if (ok && first < 0) {
      first = s;
      wsel = w;
    }
  }
  const int32_t chosen = first >= 0 ? wsel : w0;
  const int32_t ver = __shfl_sync(kFull, chosen, 2);
  if (t == 0) {
    found[lane] = first >= 0;
    version[lane] = ver;
    local_idx[lane] = first >= 0 ? first : 0;
  }
  if (t >= kValue0) {
    value[lane * kValueWords + (t - kValue0)] =
        (zero_miss && first < 0) ? 0 : chosen;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int hash_probe_launch(const void* arenas, long long n_nodes,
                                 long long n_words, const void* dest,
                                 const void* off, const void* key_lo,
                                 const void* key_hi, const void* live,
                                 const void* cache_hit, int width,
                                 int zero_miss, long long m, void* found,
                                 void* version, void* value, void* local_idx,
                                 void* stream) {
  if (m <= 0) return 0;
  const long long blocks = (m + kLanesPerBlock - 1) / kLanesPerBlock;
  hash_probe_kernel<<<static_cast<unsigned>(blocks), 32 * kLanesPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(arenas), n_nodes, n_words,
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(key_lo), static_cast<const int32_t*>(key_hi),
      static_cast<const bool*>(live), static_cast<const bool*>(cache_hit),
      width, zero_miss, m, static_cast<bool*>(found),
      static_cast<int32_t*>(version), static_cast<int32_t*>(value),
      static_cast<int32_t*>(local_idx));
  return static_cast<int>(cudaGetLastError());
}
