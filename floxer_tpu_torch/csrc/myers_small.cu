// Full Myers bit-parallel semi-global edit distance for patterns of at
// most 8 words (256 chars) (K2).
//
// Replaces floxer_tpu/ops/pallas_myers.py::_myers_kernel: per task, the
// minimum semi-global distance at the last pattern row over end columns
// 0 <= col < tlen (ties to the rightmost column), starting from score m.
//
// What bounds it on an H100: per text column, a chain of dependent 32-bit
// integer ops over the task's W words (the carry of the multi-word add and
// the one-bit shift cross every word), fed by one text char. Memory
// traffic is one 4-byte char per task and column, so integer issue and
// the per-column dependency chain bound it.
//
// Design (myers_small_kernel<G>, G = 1, 2, 4, 8): a task of W words takes
// a group of G lanes, G the smallest power of two >= W, so a warp holds
// 32 / G tasks and lane g of a group keeps pattern word g: Vp, Vn and its
// six Peq words in registers. The column is myers_full_column.cuh's, on
// the group: the carry from two warp ballots in one add, with the group's
// top lane masked out of both ballots, so no carry crosses into the next
// task (the carry out of a task's last word is never used); the shift is
// one __shfl_up_sync of width G. Eq is a select over the six Peq
// registers: the fused path hands in text chars 0..15 (garbage nibbles
// past the window), and any char >= 6 selects none, so Eq = 0. Lane g of a
// group loads the char of column base + g of its task one chunk of G
// columns ahead, a shuffle hands each column's char to the group, and each
// column's Eq is selected during the column before. The lane that owns
// row m keeps the score and writes the result. Layouts are the Pallas
// kernel's: peq [W, 6, B] and texts [N, B]. One warp per block, so a
// launch spreads over every SM (2048 tasks at W = 8 are 512 warps). A warp
// runs to its longest task; each task scores only its own columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_full_column.cuh"

namespace {

using floxer_full::kFull;
constexpr int kSigma = 6;

// The lanes that hold a task's last word (bit l for lane l).
template <int G>
__host__ __device__ constexpr uint32_t top_lanes() {
  uint32_t mask = 0u;
  for (int l = G - 1; l < 32; l += G) mask |= 1u << l;
  return mask;
}

// Eq of one pattern word for text char c: its Peq word of c, 0 for c >= 6.
__device__ __forceinline__ uint32_t select_eq(const uint32_t (&pq)[kSigma],
                                              uint32_t c) {
  uint32_t eq = 0u;
#pragma unroll
  for (int s = 0; s < kSigma; ++s) {
    eq = c == static_cast<uint32_t>(s) ? pq[s] : eq;
  }
  return eq;
}

// Task b's char of text column col (any char >= 6 past the text).
__device__ __forceinline__ uint32_t load_char(const int32_t* texts, int col,
                                              int N, int B, int b,
                                              bool live) {
  return live && col < N
             ? static_cast<uint32_t>(
                   __ldg(texts + static_cast<size_t>(col) * B + b))
             : static_cast<uint32_t>(kSigma);
}

template <int G>
__global__ void __launch_bounds__(32) myers_small_kernel(
    const uint32_t* __restrict__ peq,    // [W, 6, B]
    const int32_t* __restrict__ plen,    // [B]
    const int32_t* __restrict__ texts,   // [N, B]
    const int32_t* __restrict__ tlen,    // [B]
    int B, int W, int N,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  // the carry leaves a task only through its top lane
  constexpr uint32_t kKeep = ~top_lanes<G>();
  const int lane = threadIdx.x;
  const int g = lane & (G - 1);  // this lane's pattern word
  const int b = (blockIdx.x * 32 + lane) / G;  // its task
  // lanes past the last task run along (the warp's ballots and shuffles
  // need every lane) and write nothing
  const bool live = b < B;
  const int m = live ? plen[b] : 0;
  const int ncols = live ? max(min(tlen[b] - 1, N), 0) : 0;
  const int msb_word = (m - 1) >> 5;  // floor division, -1 for m == 0
  // whether one of the task's words holds row m; else the score stays m
  const bool scored = 0 <= msb_word && msb_word < W;
  const int owner = scored ? msb_word : 0;
  const int msb_bit = (m - 1) & 31;

  uint32_t pq[kSigma];
#pragma unroll
  for (int s = 0; s < kSigma; ++s) {
    pq[s] = live && g < W
                ? __ldg(peq + (static_cast<size_t>(g) * kSigma + s) * B + b)
                : 0u;
  }
  uint32_t vp = g <= msb_word ? kFull : 0u;
  uint32_t vn = 0u;

  const int warp_cols = __reduce_max_sync(kFull, ncols);
  // lane g: its task's char of column base + g of this chunk of G columns
  // and of the next
  uint32_t chunk = load_char(texts, g, N, B, b, live);
  uint32_t next_chunk = load_char(texts, G + g, N, B, b, live);
  uint32_t eq =
      select_eq(pq, G > 1 ? __shfl_sync(kFull, chunk, 0, G) : chunk);
  int score = m;
  int best = m;
  int best_end = 0;
#pragma unroll 1
  for (int j = 0; j < warp_cols; ++j) {
    // the next column's Eq, selected while this column runs
    const int jn = j + 1;
    if ((jn & (G - 1)) == 0) {
      chunk = next_chunk;
      next_chunk = load_char(texts, jn + G + g, N, B, b, live);
    }
    const uint32_t eq_next = select_eq(
        pq, G > 1 ? __shfl_sync(kFull, chunk, jn & (G - 1), G) : chunk);

    const uint32_t a = eq & vp;
    const uint32_t t = a + vp;
    uint32_t carry = 0u;
    if constexpr (G > 1) {
      uint32_t unused;
      const uint32_t carries = floxer_full::lookahead_carries(
          __ballot_sync(kFull, t < a) & kKeep,
          __ballot_sync(kFull, t == kFull) & kKeep, 0u, unused);
      carry = (carries >> lane) & 1u;
    }
    uint32_t ph, mh;
    floxer_full::horizontal_deltas(eq, vp, vn, t, carry, ph, mh);
    uint32_t below = 0u;
    if constexpr (G > 1) {
      below = __shfl_up_sync(kFull, floxer_full::top_bits(ph, mh), 1, G);
      if (g == 0) below = 0u;
    }
    floxer_full::vertical_deltas(ph, mh, below, vp, vn);

    // the score at row m (meaningful in the lane that owns it)
    if (scored) {
      score += static_cast<int>((ph >> msb_bit) & 1u) -
               static_cast<int>((mh >> msb_bit) & 1u);
    }
    if (j < ncols && score <= best) {
      best = score;
      best_end = jn;
    }
    eq = eq_next;
  }
  if (live && g == owner) {
    dist[b] = best;
    end_col[b] = best_end;
  }
}

template <int G>
cudaError_t launch(const void* peq, const void* plen, const void* texts,
                   const void* tlen, int B, int W, int N, void* dist,
                   void* end_col, cudaStream_t stream) {
  const int blocks =
      static_cast<int>((static_cast<int64_t>(B) * G + 31) / 32);
  myers_small_kernel<G><<<blocks, 32, 0, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const int32_t*>(plen),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlen),
      B, W, N, static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return cudaGetLastError();
}

}  // namespace

// W pattern words take the kernel instance of G lanes per task (the cases
// below; the wrapper's LANES_FOR_WORDS).
extern "C" int floxer_myers_small(
    const void* peq, const void* plen, const void* texts, const void* tlen,
    int B, int num_words, int num_text, void* dist, void* end_col,
    void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_words) {
#define FLOXER_SMALL_CASE(W, G)                                             \
  case W:                                                                   \
    return static_cast<int>(launch<G>(peq, plen, texts, tlen, B, W,         \
                                      num_text, dist, end_col, s));
    FLOXER_SMALL_CASE(1, 1)
    FLOXER_SMALL_CASE(2, 2)
    FLOXER_SMALL_CASE(3, 4)
    FLOXER_SMALL_CASE(4, 4)
    FLOXER_SMALL_CASE(5, 8)
    FLOXER_SMALL_CASE(6, 8)
    FLOXER_SMALL_CASE(7, 8)
    FLOXER_SMALL_CASE(8, 8)
#undef FLOXER_SMALL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
