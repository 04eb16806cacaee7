// Full Myers (K3) on patterns wider than one warp holds in registers:
// myers_large_wide_kernel.
//
// Replaces, beside myers_large.cu, floxer_tpu/ops/pallas_myers_large.py::
// _kernel: the same function on the same operands (per task the minimum
// semi-global distance at row m over end columns 0 <= col < tlen, ties to
// the rightmost column, starting from score m).
//
// What bounds it on an H100: the per-column chain of int32 ops over the
// pattern's words, as in myers_large.cu. One warp runs its R groups of 32
// words in one chain, so past 512 words (R = 16, 110 registers) patterns
// went to the shared-memory kernel, which reads Peq from global memory and
// walks each lane's words through shared memory on every column.
//
// Layout: one block of W = ceil(Wp / (32 R)) warps per task, R =
// kGroupsPerWarp. Group g holds pattern words [32g, 32g + 32) and warp w
// groups [R w, R w + R); lane l keeps word 32g + l of Vp and Vn in
// registers, and a warp's column is myers_full_column.cuh's, as in the
// register kernel, with the carry into its group 0 and the top bits below
// its lane 0 coming from the warp below.
//
// Full Myers has no slide: carries and shifts only move up, so a warp never
// waits on a warp above it, and the warps run skewed as a wavefront. The
// columns go in chunks of 32: at step s warp w runs chunk s - w, reading
// what warp w - 1 published for that chunk at step s - 1 (per column, its
// carry out and the top Ph and Mh bits of its lane 31) and publishing its
// own for warp w + 1, in a ring of two slots per warp in shared memory;
// the block meets once per step at a named barrier. So a column costs one
// warp's chain of R groups, 32 columns share one barrier, and the start-up
// is W - 1 chunks.
//
// Work on padding words is skipped as in the register kernel: a task runs
// only its ceil(m / 1024) groups, so the warps above its last group leave
// at once (the barrier counts only the warps that stay), and the top warp
// runs a column loop compiled for exactly its own group count, picked once
// per task. The top warp owns row m, keeps the score and writes the result.
// Peq rows sit in shared memory as [c][word] with an all-zero row 6 that
// chars >= 6 select (each warp reads only its own words, so they need no
// block barrier); lane l loads the char of column base + l of its chunk, a
// shuffle hands each column's char to every lane, and each column's Eq
// words are loaded during the column before.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_full_column.cuh"

namespace {

using floxer_full::kFull;
constexpr int kSigma = 6;
constexpr int kGroupsPerWarp = 4;
constexpr int kMaxWords = 2048;
constexpr int kMaxWarps = kMaxWords / (32 * kGroupsPerWarp);
constexpr int kChunk = 32;

// What warp w publishes for warp w + 1: per column of a chunk, bit 0 its
// carry out, bits 1-2 the top bits of its lane 31; two slots by step
// parity.
struct Ring {
  uint32_t slot[2][kMaxWarps][kChunk];
};

// The block's warps that have work meet here once per step.
__device__ __forceinline__ void step_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The Peq row offset of a text char (chars >= 6, and columns past the
// text, take the all-zero row 6).
__device__ __forceinline__ uint32_t eq_row(const int32_t* trow, int col,
                                           int N, uint32_t stride) {
  const uint32_t c = col < N ? static_cast<uint32_t>(__ldg(trow + col))
                             : static_cast<uint32_t>(kSigma);
  return min(c, static_cast<uint32_t>(kSigma)) * stride;
}

// Every column of one task on one warp's G groups (its words from
// `first_word` on); `ring` is the block's ring, `steps` the chunks plus the
// start-up of the warps that have work.
template <int G>
__device__ __forceinline__ void columns_wide(
    const uint32_t* eq_rows, uint32_t stride, const int32_t* trow, int N,
    int ncols, int steps, int threads, int m, int lane, int warp,
    bool top_warp, int first_word, Ring& ring, int32_t* dist,
    int32_t* end_col) {
  const int msb_word = (m - 1) >> 5;
  const int msb_bit = (m - 1) & 31;
  const int chunks = (ncols + kChunk - 1) / kChunk;
  uint32_t vp[G], vn[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    vp[i] = first_word + 32 * i + lane <= msb_word ? kFull : 0u;
    vn[i] = 0u;
  }
  int score = m;
  int best = m;
  int best_end = 0;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int chunk = step - warp;
    if (chunk >= 0 && chunk < chunks) {
      const int base = chunk * kChunk;
      const int count = min(kChunk, ncols - base);
      // lane l: what the warp below published for column base + l
      const uint32_t from_below =
          warp > 0 ? ring.slot[(step - 1) & 1][warp - 1][lane] : 0u;
      uint32_t* to_above = ring.slot[step & 1][warp];
      // lane l: the Peq row offset of column base + l
      const uint32_t rows = eq_row(trow, base + lane, N, stride);
      uint32_t eq[G];
      {
        const uint32_t* row = eq_rows + __shfl_sync(kFull, rows, 0) + lane;
#pragma unroll
        for (int i = 0; i < G; ++i) eq[i] = row[32 * i];
      }
#pragma unroll 1
      for (int q = 0; q < count; ++q) {
        // the next column's Eq words, loaded while this column runs
        const uint32_t* row =
            eq_rows + __shfl_sync(kFull, rows, (q + 1) & 31) + lane;
        uint32_t eq_next[G];
#pragma unroll
        for (int i = 0; i < G; ++i) eq_next[i] = row[32 * i];
        const uint32_t in = __shfl_sync(kFull, from_below, q);

        // 1) each word's add without its carry-in; per group the ballots
        uint32_t t[G], gm[G], pm[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const uint32_t a = eq[i] & vp[i];
          t[i] = a + vp[i];
          gm[i] = __ballot_sync(kFull, t[i] < a);
          pm[i] = __ballot_sync(kFull, t[i] == kFull);
        }
        // 2) the carries: into group 0 the warp below's carry out, then
        // within a group in one add and from group to group
        uint32_t carry[G];
        uint32_t cin = in & 1u;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const uint32_t carries =
              floxer_full::lookahead_carries(gm[i], pm[i], cin, cin);
          carry[i] = (carries >> lane) & 1u;
        }
        // 3) the horizontal deltas shifted up one bit: lane 0 of group 0
        // takes the warp below's top bits
        uint32_t below_group = in >> 1;
        uint32_t ph_m = 0u, mh_m = 0u;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          uint32_t ph, mh;
          floxer_full::horizontal_deltas(eq[i], vp[i], vn[i], t[i], carry[i],
                                         ph, mh);
          const uint32_t rotated = __shfl_sync(
              kFull, floxer_full::top_bits(ph, mh), (lane + 31) & 31);
          floxer_full::vertical_deltas(
              ph, mh, lane == 0 ? below_group : rotated, vp[i], vn[i]);
          below_group = rotated;
          if (i == G - 1) {
            ph_m = ph;
            mh_m = mh;
          }
        }
        // 4) publish the carry out and lane 31's top bits to the warp above
        if (lane == 31 && !top_warp) {
          to_above[q] = cin | (floxer_full::top_bits(ph_m, mh_m) << 1);
        }
        // 5) the score at row m (meaningful in the top warp's lane that
        // owns it)
        score += static_cast<int>((ph_m >> msb_bit) & 1u) -
                 static_cast<int>((mh_m >> msb_bit) & 1u);
        if (score <= best) {
          best = score;
          best_end = base + q + 1;
        }
#pragma unroll
        for (int i = 0; i < G; ++i) eq[i] = eq_next[i];
      }
    }
    step_barrier(threads);
  }
  if (top_warp && lane == (msb_word & 31)) {
    *dist = best;
    *end_col = best_end;
  }
}

// columns_wide at the warp's group count G (1..kGroupsPerWarp), picked
// once per task.
template <int G>
__device__ __forceinline__ void columns_for_groups(
    int groups, const uint32_t* eq_rows, uint32_t stride,
    const int32_t* trow, int N, int ncols, int steps, int threads, int m,
    int lane, int warp, bool top_warp, int first_word, Ring& ring,
    int32_t* dist, int32_t* end_col) {
  if constexpr (G <= kGroupsPerWarp) {
    if (groups == G) {
      columns_wide<G>(eq_rows, stride, trow, N, ncols, steps, threads, m,
                      lane, warp, top_warp, first_word, ring, dist, end_col);
    } else {
      columns_for_groups<G + 1>(
          groups, eq_rows, stride, trow, N, ncols, steps, threads, m, lane,
          warp, top_warp, first_word, ring, dist, end_col);
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps) myers_large_wide_kernel(
    const uint32_t* __restrict__ peq,    // [B, 6, Wp], Wp <= kMaxWords
    const int32_t* __restrict__ plen,    // [B]
    const int32_t* __restrict__ texts,   // [B, N]
    const int32_t* __restrict__ tlen,    // [B]
    int Wp, int N, int32_t* __restrict__ dist,
    int32_t* __restrict__ end_col) {
  constexpr int R = kGroupsPerWarp;
  // Peq rows 0..5 of the block's words, then row 6 all zero
  extern __shared__ uint32_t eq_rows[];
  __shared__ Ring ring;
  const int task = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t stride = blockDim.x * R;  // words the block holds
  const int m = plen[task];
  const int ncols = min(tlen[task] - 1, N);
  const int msb_word = (m - 1) >> 5;  // floor division, -1 for m == 0
  if (msb_word < 0 || msb_word >= Wp) {
    // no pattern word holds row m: the score stays m and every column
    // ties, so the rightmost one wins
    if (threadIdx.x == 0) {
      dist[task] = m;
      end_col[task] = max(ncols, 0);
    }
    return;
  }
  const int groups = (msb_word >> 5) + 1;  // <= Wp / 32
  const int active = (groups + R - 1) / R;
  if (warp >= active) return;
  const int my_groups = min(R, groups - R * warp);
  const int first_word = 32 * R * warp;
  const uint32_t* pq = peq + static_cast<size_t>(task) * kSigma * Wp;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < my_groups) {
      const int w = first_word + 32 * i + lane;
#pragma unroll
      for (int c = 0; c < kSigma; ++c) {
        eq_rows[c * stride + w] = __ldg(pq + c * Wp + w);
      }
      eq_rows[kSigma * stride + w] = 0u;
    }
  }
  __syncwarp();
  const int chunks = ncols > 0 ? (ncols + kChunk - 1) / kChunk : 0;
  columns_for_groups<1>(
      my_groups, eq_rows + first_word, stride,
      texts + static_cast<size_t>(task) * N, N, max(ncols, 0),
      chunks + active - 1, 32 * active, m, lane, warp, warp == active - 1,
      first_word, ring, dist + task, end_col + task);
}

}  // namespace

// The multi-warp kernel on any Wp of a multiple of 32 words up to 2048, in
// ceil(Wp / (32 kGroupsPerWarp)) warps; wider Wp is refused, and so is a
// launch whose Peq rows the card cannot give the dynamic shared memory.
extern "C" int floxer_myers_large_wide(
    const void* peq, const void* plen, const void* texts, const void* tlen,
    int B, int words_padded, int num_text, void* dist, void* end_col,
    void* stream) {
  if (B == 0) return 0;
  if (words_padded <= 0 || words_padded % 32 != 0 ||
      words_padded > kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps =
      (words_padded / 32 + kGroupsPerWarp - 1) / kGroupsPerWarp;
  const size_t smem = static_cast<size_t>(kSigma + 1) * 32 * kGroupsPerWarp *
                      warps * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        myers_large_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  myers_large_wide_kernel<<<B, 32 * warps, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const int32_t*>(plen),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlen),
      words_padded, num_text, static_cast<int32_t*>(dist),
      static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}
