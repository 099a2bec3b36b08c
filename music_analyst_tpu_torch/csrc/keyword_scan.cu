// Keyword-containment scan for Hopper (sm_90a): the --mock sentiment scorer.
//
// Replaces the Pallas TPU kernel music_analyst_tpu/ops/pallas_keyword.py
// (_scan_kernel, launched by _pallas_scores), which computes the same
// function as the XLA formulation ops/keyword_sentiment.py:keyword_scores:
// ASCII-lowercase each padded lyric row once, test substring containment
// of every keyword, and score each row as the signed count of keywords
// present (each keyword counted once however often it occurs).
//
// Input x is uint8 [B, L], row-major, zero padded.  Outputs: scores int32
// [B] and, when `hits` is not null, hits int32 [B] with bit i set when
// keyword i occurs (the chunked long-lyric path ORs these across windows).
//
// Design.  One block per row.  The row streams through shared memory in
// tiles of kTile bytes (plus a zero-filled halo of 8), lowercased once as
// it lands.  Each thread then takes positions of the tile and forms the
// 8-byte little-endian window starting there; a keyword of m <= 8 bytes
// matches when (window & mask) == pattern, with the pattern and mask built
// on the host.  Padding bytes are 0 and no keyword holds a 0 byte, so a
// window running past the row never matches.  Hits OR-reduce across the
// warp and then the block.
//
// What bounds it: every byte is read once from device memory and touched
// a few times in shared memory; ten 64-bit compares per byte are far below
// the card's integer rate, so device-memory traffic (B * L bytes) bounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;
constexpr int kHalo = 8;
constexpr int kMaxKeywords = 16;

struct KeywordSet {
  unsigned long long pattern[kMaxKeywords];
  unsigned long long mask[kMaxKeywords];
  int sign[kMaxKeywords];
  int n;
};

__global__ void __launch_bounds__(kThreads)
keyword_scan_kernel(const uint8_t* __restrict__ x, int L, KeywordSet kw,
                    int* __restrict__ scores, int* __restrict__ hits) {
  __shared__ unsigned char tile[kTile + kHalo];
  __shared__ unsigned int block_hits;
  const long long row = blockIdx.x;
  const uint8_t* src = x + row * static_cast<long long>(L);
  const int tid = threadIdx.x;
  if (tid == 0) block_hits = 0u;
  unsigned int mine = 0u;

  for (int start = 0; start < L; start += kTile) {
    __syncthreads();  // previous tile consumed (and block_hits zeroed)
    for (int i = tid; i < kTile + kHalo; i += kThreads) {
      const int pos = start + i;
      unsigned char c = pos < L ? src[pos] : 0;
      if (c >= 'A' && c <= 'Z') c += 32;
      tile[i] = c;
    }
    __syncthreads();
    const int n_pos = min(kTile, L - start);
    for (int i = tid; i < n_pos; i += kThreads) {
      unsigned long long w = 0ull;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w |= static_cast<unsigned long long>(tile[i + j]) << (8 * j);
      for (int t = 0; t < kw.n; ++t)
        if ((w & kw.mask[t]) == kw.pattern[t]) mine |= 1u << t;
    }
  }

  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((tid & 31) == 0 && mine) atomicOr(&block_hits, mine);
  __syncthreads();
  if (tid == 0) {
    const unsigned int bits = block_hits;
    int score = 0;
    for (int t = 0; t < kw.n; ++t)
      if (bits & (1u << t)) score += kw.sign[t];
    scores[row] = score;
    if (hits != nullptr) hits[row] = static_cast<int>(bits);
  }
}

}  // namespace

// patterns/masks/signs are host arrays of n <= 16 entries.  Returns a
// cudaError_t.
extern "C" int keyword_scan_fwd(const void* x, long long B, int L,
                                const unsigned long long* patterns,
                                const unsigned long long* masks,
                                const int* signs, int n, int* scores,
                                int* hits, void* stream) {
  if (n < 0 || n > kMaxKeywords || L <= 0 || B <= 0 || B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  KeywordSet kw{};
  for (int t = 0; t < n; ++t) {
    kw.pattern[t] = patterns[t];
    kw.mask[t] = masks[t];
    kw.sign[t] = signs[t];
  }
  kw.n = n;
  keyword_scan_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), L, kw, scores, hits);
  return cudaGetLastError();
}
