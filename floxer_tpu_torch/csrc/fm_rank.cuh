// K9's body: the FM index's rank of all six symbols at one position,
// shared by csrc/fm_index.cu (K9, K9x, K9l) and csrc/workqueue_search.cu
// (K10). Replaces floxer_tpu/index/device_index.py's rank_rows_lookup
// (:260) and _rank_all_planes (:228).
//
// Two layouts, as the reference has them:
//   combined: rows uint32 [R, 32], one 128-byte row a block of 128 BWT
//     positions; column 5 s is symbol s's checkpoint, 5 s + 1 .. 5 s + 4
//     its plane words. A direction's positions start at row row_offset.
//   planes: occ int32 [nb + 1, 6] and planes uint32 [nb, 6, 4] of one
//     direction (used when the combined positions reach 2^31).
// rank = the checkpoint + the popcounts of the plane words masked to the
// bits below the position.
#pragma once

#include <cstdint>

#define FM_SIGMA 6
#define FM_OCC_BLOCK 128
#define FM_ROW_WORDS 32
#define FM_PLANE_WORDS 4

struct FmRankTable {
  const uint32_t* rows;    // combined table, or nullptr for the planes layout
  const int32_t* occ;      // planes layout: [nb + 1, 6]
  const uint32_t* planes;  // planes layout: [nb, 6, 4]
  int row_offset;          // combined layout: this direction's first row
};

__host__ __device__ inline int fm_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// word w of a block keeps its lowest clamp(r - 32 w, 0, 32) bits
__host__ __device__ inline uint32_t fm_word_mask(int r, int w) {
  int below = r - 32 * w;
  below = below < 0 ? 0 : (below > 32 ? 32 : below);
  return below >= 32 ? 0xFFFFFFFFu : ((1u << below) - 1u);
}

// counts[s] = occurrences of symbol s in bwt[0, position)
__host__ __device__ inline void fm_rank(const FmRankTable& t, int position,
                                        int counts[FM_SIGMA]) {
  uint32_t words[FM_SIGMA * 5];
  int r;
  if (t.rows != nullptr) {
    const int p = position + t.row_offset * FM_OCC_BLOCK;
    const int block = p / FM_OCC_BLOCK;
    r = p - block * FM_OCC_BLOCK;
    const uint32_t* row = t.rows + (size_t)block * FM_ROW_WORDS;
#ifdef __CUDA_ARCH__
    // the row's 128 bytes as seven 16-byte loads (columns 0..27) and one
    // 8-byte load (28, 29)
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const uint4 v = __ldg(row4 + q);
      words[4 * q] = v.x;
      words[4 * q + 1] = v.y;
      words[4 * q + 2] = v.z;
      words[4 * q + 3] = v.w;
    }
    const uint2 tail = __ldg(reinterpret_cast<const uint2*>(row + 28));
    words[28] = tail.x;
    words[29] = tail.y;
#else
    for (int c = 0; c < FM_SIGMA * 5; ++c) words[c] = row[c];
#endif
  } else {
    const int block = position / FM_OCC_BLOCK;
    r = position - block * FM_OCC_BLOCK;
#pragma unroll
    for (int s = 0; s < FM_SIGMA; ++s) {
      words[5 * s] = (uint32_t)t.occ[(size_t)block * FM_SIGMA + s];
#pragma unroll
      for (int w = 0; w < FM_PLANE_WORDS; ++w) {
        words[5 * s + 1 + w] =
            t.planes[((size_t)block * FM_SIGMA + s) * FM_PLANE_WORDS + w];
      }
    }
  }
  uint32_t mask[FM_PLANE_WORDS];
#pragma unroll
  for (int w = 0; w < FM_PLANE_WORDS; ++w) mask[w] = fm_word_mask(r, w);
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) {
    int count = (int)words[5 * s];
#pragma unroll
    for (int w = 0; w < FM_PLANE_WORDS; ++w) {
      count += fm_popc(words[5 * s + 1 + w] & mask[w]);
    }
    counts[s] = count;
  }
}

// the rank of one symbol (K9l's LF step)
__host__ __device__ inline int fm_rank_symbol(const FmRankTable& t,
                                              int position, int symbol) {
  int counts[FM_SIGMA];
  fm_rank(t, position, counts);
  int out = counts[0];
#pragma unroll
  for (int s = 1; s < FM_SIGMA; ++s) out = symbol == s ? counts[s] : out;
  return out;
}
