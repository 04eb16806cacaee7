// The device FM index's per-query functions, shared by the kernels that
// walk it: the rank of all six symbols at one position (fm_rank:
// csrc/fm_index.cu K9l, csrc/fm_sharded.cu K13), the interval rank at both
// ends of an interval from one row when they share a block
// (fm_interval_rank: csrc/workqueue_search.cu K10), the all-symbol
// bidirectional extension over it (fm_extend_all: csrc/frontier_search.cu
// K11) and K9l's bounded LF walk to a sampled row (fm_locate_row: K9l and
// csrc/select_anchors.cu K12). K9 and K9x themselves (csrc/fm_index.cu)
// stage a warp's rows through shared memory and rank each query with
// fm_rank_words. Replaces floxer_tpu/index/device_index.py's
// rank_rows_lookup (:260), _rank_all_planes (:228), extend_left_all /
// extend_right_all (:370, :387) and locate_batch (:455).
//
// The row-sharded index (FmShardedRankTable, FmShardedLocateTables) has
// the same functions over S shard tables (csrc/fm_sharded.cu K13, K13l;
// K11 over shards). The reference ranks in every shard at the global
// position clamped into the shard's rows and sums the counts with a psum
// over its index mesh axis (device_index.py:318-358, :433-446;
// parallel/sharded_index.py:78). The shards are contiguous and ascending,
// so the clamped ranks of the shards before the one that owns a position
// are their totals and those after it are 0: here the rank (K13, K11 over
// shards) and the locate (K13l) resolve that owner and take its local
// rank plus the earlier shards' totals (`before`, a prefix the shard
// layout carries), one rank row where the sum read S. A sampled row can
// only lie in the one sample chunk that starts at or before it and before
// the next chunk.
// The functions that take a table are overloaded or templated on its
// type, so the unsharded kernels compile as they did.
//
// Two layouts, as the reference has them:
//   combined: rows uint32 [R, 32], one 128-byte row a block of 128 BWT
//     positions; column 5 s is symbol s's checkpoint, 5 s + 1 .. 5 s + 4
//     its plane words. A direction's positions start at row row_offset.
//   planes: occ int32 [nb + 1, 6] and planes uint32 [nb, 6, 4] of one
//     direction (used when the combined positions reach 2^31).
// rank = the checkpoint + the popcounts of the plane words masked to the
// bits below the position.
//
// The unsharded locate reads the SA samples through a sampled-row plane
// (index/device_index.sample_plane), one 32-byte sector a block of 128 SA
// rows: word 0 the count of sampled rows before the block, words 1..4
// the block's membership bits, 5..7 zero. A row is sampled iff its bit is
// set, and its sample is sampled_values[word 0 + the set bits below it]:
// one sector and, on a hit, one value, where a binary search over the
// ~n / 4 samples made ~21 dependent probes.
#pragma once

#include <cstddef>
#include <cstdint>

#define FM_SIGMA 6
#define FM_OCC_BLOCK 128
#define FM_ROW_WORDS 32
#define FM_PLANE_WORDS 4
#define FM_SAMPLE_WORDS 8

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

// the block of the table a rank at `position` reads and the position's
// offset in it (the combined layout's positions of a direction start at
// its row_offset)
__host__ __device__ inline void fm_block_of(const FmRankTable& t,
                                            int position, int* block,
                                            int* r) {
  const int p =
      t.rows != nullptr ? position + t.row_offset * FM_OCC_BLOCK : position;
  *block = p / FM_OCC_BLOCK;
  *r = p - *block * FM_OCC_BLOCK;
}

// a block's 30 words: word 5 s symbol s's checkpoint, 5 s + 1 .. 5 s + 4
// its plane words
__host__ __device__ inline void fm_load_row(const FmRankTable& t, int block,
                                            uint32_t words[FM_SIGMA * 5]) {
  if (t.rows != nullptr) {
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
}

// counts[s] = symbol s's checkpoint + the popcounts of its plane words
// masked to the r bits below the position
__host__ __device__ inline void fm_rank_words(
    const uint32_t words[FM_SIGMA * 5], int r, int counts[FM_SIGMA]) {
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

// counts[s] = occurrences of symbol s in bwt[0, position), each layout's
// branch working out its own block and offset
__host__ __device__ inline void fm_rank(const FmRankTable& t, int position,
                                        int counts[FM_SIGMA]) {
  uint32_t words[FM_SIGMA * 5];
  int r;
  if (t.rows != nullptr) {
    const int p = position + t.row_offset * FM_OCC_BLOCK;
    const int block = p / FM_OCC_BLOCK;
    r = p - block * FM_OCC_BLOCK;
    fm_load_row(t, block, words);
  } else {
    const int block = position / FM_OCC_BLOCK;
    r = position - block * FM_OCC_BLOCK;
    fm_load_row(t, block, words);
  }
  fm_rank_words(words, r, counts);
}

// The interval rank: lo[s] = the rank at base and count[s] = the rank at
// base + length less lo[s], from one row when both positions fall in one
// block (the checkpoint cancels in count, which is then the popcount of
// the plane words under mask(r_hi) & ~mask(r_lo)), else from two. The
// same arithmetic as two ranks on the same words, so exact at any
// (base, length); a search deep in its tree extends intervals of a few
// rows, whose two positions share a block most of the time.
__host__ __device__ inline void fm_interval_rank(const FmRankTable& t,
                                                 int base, int length,
                                                 int lo[FM_SIGMA],
                                                 int count[FM_SIGMA]) {
  int block_lo, r_lo, block_hi, r_hi;
  fm_block_of(t, base, &block_lo, &r_lo);
  fm_block_of(t, base + length, &block_hi, &r_hi);
  uint32_t words[FM_SIGMA * 5];
  fm_load_row(t, block_lo, words);
  fm_rank_words(words, r_lo, lo);
  if (block_hi != block_lo) fm_load_row(t, block_hi, words);
  int hi[FM_SIGMA];
  fm_rank_words(words, r_hi, hi);
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) count[s] = hi[s] - lo[s];
}

// S shard tables of one direction, each in the combined layout: shard s's
// rows start at rows + s * shard_rows * 32 and hold its own blocks (local
// checkpoints and planes of its real rows only); a direction's positions
// start at row row_offset of every shard. Shard s owns the global rows
// [starts[s], starts[s] + lengths[s]), and before[s] holds each symbol's
// total over the shards before it.
struct FmShardedRankTable {
  const uint32_t* rows;  // [S, shard_rows, 32]
  int shard_rows;
  int row_offset;
  const int* starts;   // [S]
  const int* lengths;  // [S]
  const int* before;   // [S, 6]
  int num_shards;
};

// The shard that owns a global position, the position clamped into it
// and its table. The owner is the last shard whose start is at most the
// position (S - 1 independent tests; shard 0 for a negative one, whose
// start is 0; the last of the empty trailing shards, which start at n, for
// one at or past n). Its start and length are selected beside the tests,
// so the row's address waits on no load that waits on the owner.
__host__ __device__ inline FmRankTable fm_owner(const FmShardedRankTable& t,
                                                int position, int* owner_out,
                                                int* local_out) {
  int owner = 0, start = t.starts[0], length = t.lengths[0];
#pragma unroll 4
  for (int shard = 1; shard < t.num_shards; ++shard) {
    const int first = t.starts[shard];
    const int size = t.lengths[shard];
    const bool owns = position >= first;
    owner += owns;
    start = owns ? first : start;
    length = owns ? size : length;
  }
  int local = position - start;
  local = local < 0 ? 0 : (local > length ? length : local);
  FmRankTable one;
  one.rows = t.rows + (size_t)owner * t.shard_rows * FM_ROW_WORDS;
  one.occ = nullptr;
  one.planes = nullptr;
  one.row_offset = t.row_offset;
  *owner_out = owner;
  *local_out = local;
  return one;
}

// counts[s] = occurrences of symbol s before a global position: the
// reference's sum over the shards of each shard's count at clamp(position
// - start, 0, length), as the owner's count at its clamped position plus
// the earlier shards' totals, so one 128-byte row a query
__host__ __device__ inline void fm_rank(const FmShardedRankTable& t,
                                        int position, int counts[FM_SIGMA]) {
  int owner, local;
  const FmRankTable one = fm_owner(t, position, &owner, &local);
  fm_rank(one, local, counts);
  const int* before = t.before + owner * FM_SIGMA;
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) counts[s] += before[s];
}

// the interval rank over the shards: one row when both positions have
// the same owner and fall in one block of it (before[owner] cancels in
// count), else the two owners' rows
__host__ __device__ inline void fm_interval_rank(
    const FmShardedRankTable& t, int base, int length, int lo[FM_SIGMA],
    int count[FM_SIGMA]) {
  int owner_lo, local_lo, owner_hi, local_hi;
  const FmRankTable table_lo = fm_owner(t, base, &owner_lo, &local_lo);
  const FmRankTable table_hi =
      fm_owner(t, base + length, &owner_hi, &local_hi);
  int block_lo, r_lo, block_hi, r_hi;
  fm_block_of(table_lo, local_lo, &block_lo, &r_lo);
  fm_block_of(table_hi, local_hi, &block_hi, &r_hi);
  uint32_t words[FM_SIGMA * 5];
  fm_load_row(table_lo, block_lo, words);
  fm_rank_words(words, r_lo, lo);
  if (owner_hi != owner_lo || block_hi != block_lo) {
    fm_load_row(table_hi, block_hi, words);
  }
  int hi[FM_SIGMA];
  fm_rank_words(words, r_hi, hi);
  const int* before_lo = t.before + owner_lo * FM_SIGMA;
  const int* before_hi = t.before + owner_hi * FM_SIGMA;
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) {
    lo[s] += before_lo[s];
    count[s] = hi[s] + before_hi[s] - lo[s];
  }
}

#ifdef __CUDACC__
// the block's copy of a sharded table's starts, lengths and totals in
// shared memory (FM_STAGED_WORDS(S) int32 at `staged`), written by the
// block's threads; the caller syncs the block before a rank reads it
#define FM_STAGED_WORDS(S) ((S) * (2 + FM_SIGMA))
__device__ inline FmShardedRankTable fm_stage_shards(
    const FmShardedRankTable& t, int* staged) {
  const int S = t.num_shards;
  for (int w = threadIdx.x; w < S; w += blockDim.x) {
    staged[w] = t.starts[w];
    staged[S + w] = t.lengths[w];
  }
  for (int w = threadIdx.x; w < S * FM_SIGMA; w += blockDim.x) {
    staged[2 * S + w] = t.before[w];
  }
  FmShardedRankTable out = t;
  out.starts = staged;
  out.lengths = staged + S;
  out.before = staged + 2 * S;
  return out;
}
#endif

// field-wise select of a direction's table (registers, not a copy)
__host__ __device__ inline FmRankTable fm_pick(const FmRankTable& a,
                                               const FmRankTable& b,
                                               bool first) {
  FmRankTable t;
  t.rows = first ? a.rows : b.rows;
  t.occ = first ? a.occ : b.occ;
  t.planes = first ? a.planes : b.planes;
  t.row_offset = first ? a.row_offset : b.row_offset;
  return t;
}

__host__ __device__ inline FmShardedRankTable fm_pick(
    const FmShardedRankTable& a, const FmShardedRankTable& b, bool first) {
  FmShardedRankTable t;
  t.rows = first ? a.rows : b.rows;
  t.shard_rows = first ? a.shard_rows : b.shard_rows;
  t.row_offset = first ? a.row_offset : b.row_offset;
  t.starts = first ? a.starts : b.starts;
  t.lengths = first ? a.lengths : b.lengths;
  t.before = first ? a.before : b.before;
  t.num_shards = first ? a.num_shards : b.num_shards;
  return t;
}

// the rank of one symbol (K9l's LF step)
template <class Table>
__host__ __device__ inline int fm_rank_symbol(const Table& t, int position,
                                              int symbol) {
  int counts[FM_SIGMA];
  fm_rank(t, position, counts);
  int out = counts[0];
#pragma unroll
  for (int s = 1; s < FM_SIGMA; ++s) out = symbol == s ? counts[s] : out;
  return out;
}

// the children of an extension from the ranks at its base (lo) and the
// counts: primary = C + lo on the extended direction, the other one the
// secondary start plus the counts' exclusive prefix
__host__ __device__ inline void fm_children(const int* C, int secondary,
                                            bool left,
                                            const int lo[FM_SIGMA],
                                            const int count[FM_SIGMA],
                                            int new_lb[FM_SIGMA],
                                            int new_lb_rev[FM_SIGMA],
                                            int counts[FM_SIGMA]) {
  int prefix = 0;
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) {
    const int primary = C[s] + lo[s];
    new_lb[s] = left ? primary : secondary + prefix;
    new_lb_rev[s] = left ? secondary + prefix : primary;
    counts[s] = count[s];
    prefix += count[s];
  }
}

// one bidirectional extension step of the interval (lb, lb_rev, length)
// by every symbol, ranked on the direction that is extended (`t`: the
// forward table for a left extension at lb, the reverse one for a right
// extension at lb_rev) by the interval rank: one row when the interval
// lies in one block
template <class Table>
__host__ __device__ inline void fm_extend_all(const Table& t,
                                              const int* C, int lb,
                                              int lb_rev, int length,
                                              bool left,
                                              int new_lb[FM_SIGMA],
                                              int new_lb_rev[FM_SIGMA],
                                              int counts[FM_SIGMA]) {
  int lo[FM_SIGMA], count[FM_SIGMA];
  fm_interval_rank(t, left ? lb : lb_rev, length, lo, count);
  fm_children(C, left ? lb_rev : lb, left, lo, count, new_lb, new_lb_rev,
              counts);
}

// first index in sorted[0, count) whose value is not below key (count
// when there is none)
__host__ __device__ inline int fm_lower_bound(const int* sorted, int count,
                                              int key) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index whose value is above key
__host__ __device__ inline int fm_upper_bound(const int* sorted, int count,
                                              int key) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the operands of a locate: the forward rank table, the BWT (n rows), C,
// the sampled-row plane ([n / 128 + 1, FM_SAMPLE_WORDS]), the SA samples'
// values and the sequence starts
struct FmLocateTables {
  FmRankTable fwd;
  const uint8_t* bwt;
  const int* C;
  const uint32_t* sample_plane;
  const int* sampled_values;
  int n;
  const int* seq_starts;
  int num_seqs;
  int sampling_rate;
};

// the shard layout a sharded locate reads, FM_LAYOUT_COLUMNS int32 a
// shard (index/device_index.locate_layout writes it): the shard's first
// row, its sample chunk's first real row (1 << 30 for a chunk of pads
// only) and its real samples, and the totals of each symbol in the shards
// before it. The shards are contiguous and ascending, and so are the
// chunks, whose pads-only ones come last (parallel/sharded_index.py's
// shard_full_index), so the shard that owns a row is the last whose first
// row is at most the row, and the one chunk that can hold it likewise.
#define FM_LAYOUT_COLUMNS 9
#define FM_LAYOUT_START 0
#define FM_LAYOUT_SAMPLE_FIRST 1
#define FM_LAYOUT_SAMPLES 2
#define FM_LAYOUT_BEFORE 3

// the same over the row-sharded index: the forward shard tables (their
// rows; the layout holds where each shard starts), the shards' BWT rows
// (bwt + s * bwt_stride, the owner's), each shard's
// chunk of the SA samples (sampled_rows + s * ns, sorted, padded with
// 1 << 30, which no row reaches), and the shard layout ([S,
// FM_LAYOUT_COLUMNS]; K13l's blocks read it from shared memory)
struct FmShardedLocateTables {
  FmShardedRankTable fwd;
  const uint8_t* bwt;  // [S, bwt_stride]
  int bwt_stride;
  const int* C;
  const int* sampled_rows;    // [S, ns]
  const int* sampled_values;  // [S, ns]
  int ns;
  const int* seq_starts;
  int num_seqs;
  int sampling_rate;
  const int* layout;  // [S, FM_LAYOUT_COLUMNS]
};

// one LF step: the BWT symbol at a row, C and its rank there
__host__ __device__ inline int fm_lf(const FmLocateTables& t, int row) {
  const int symbol = t.bwt[row];
  return t.C[symbol] + fm_rank_symbol(t.fwd, row, symbol);
}

// the same over the shards: the owner's BWT byte and its rank row, the
// earlier shards' totals from the layout (S - 1 owner tests, each load
// independent of the others, and the six totals read beside the rank row)
__host__ __device__ inline int fm_lf(const FmShardedLocateTables& t,
                                     int row) {
  int owner = 0, start = t.layout[FM_LAYOUT_START];
#pragma unroll 4
  for (int shard = 1; shard < t.fwd.num_shards; ++shard) {
    const int first = t.layout[shard * FM_LAYOUT_COLUMNS + FM_LAYOUT_START];
    owner += row >= first;
    start = row >= first ? first : start;
  }
  const int* layout = t.layout + owner * FM_LAYOUT_COLUMNS;
  const int local = row - start;
  const int symbol = t.bwt[(size_t)owner * t.bwt_stride + local];
  int before = layout[FM_LAYOUT_BEFORE];
#pragma unroll
  for (int s = 1; s < FM_SIGMA; ++s) {
    const int total = layout[FM_LAYOUT_BEFORE + s];
    before = symbol == s ? total : before;
  }
  FmRankTable one;
  one.rows = t.fwd.rows + (size_t)owner * t.fwd.shard_rows * FM_ROW_WORDS;
  one.occ = nullptr;
  one.planes = nullptr;
  one.row_offset = t.fwd.row_offset;
  return t.C[symbol] + before + fm_rank_symbol(one, local, symbol);
}

// is the row sampled, and its sampled text position (*value, 0 if not):
// the reference's clamped searchsorted
__host__ __device__ inline bool fm_sample_lookup(const int* sampled_rows,
                                                 const int* sampled_values,
                                                 int ns, int row, int* value) {
  int at = fm_lower_bound(sampled_rows, ns, row);
  at = at < ns - 1 ? at : ns - 1;
  const bool hit = sampled_rows[at] == row;
  *value = hit ? sampled_values[at] : 0;
  return hit;
}

// the same through the sampled-row plane: the row's sector (words 0..4 as
// one 16-byte and one 4-byte load of its 32 bytes), its bit and, on a hit,
// its value at the block's count plus the set bits below it. A row
// outside [0, n) reads nothing and is no hit, as the clamped searchsorted
// finds no sample equal to it.
__host__ __device__ inline bool fm_sample_lookup(const FmLocateTables& t,
                                                 int row, int* value) {
  *value = 0;
  if ((unsigned)row >= (unsigned)t.n) return false;
  const int block = row / FM_OCC_BLOCK;
  const int r = row - block * FM_OCC_BLOCK;
  const uint32_t* sector = t.sample_plane + (size_t)block * FM_SAMPLE_WORDS;
  uint32_t words[5];
#ifdef __CUDA_ARCH__
  const uint4 head = __ldg(reinterpret_cast<const uint4*>(sector));
  words[0] = head.x;
  words[1] = head.y;
  words[2] = head.z;
  words[3] = head.w;
  words[4] = __ldg(sector + 4);
#else
  for (int w = 0; w < 5; ++w) words[w] = sector[w];
#endif
  // the row's word by selects (no indexed register array, so no stack)
  const int at = r >> 5;
  uint32_t word = words[1];
#pragma unroll
  for (int w = 1; w < FM_PLANE_WORDS; ++w) word = at == w ? words[1 + w] : word;
  if (((word >> (r & 31)) & 1u) == 0) return false;
  int index = (int)words[0];
#pragma unroll
  for (int w = 0; w < FM_PLANE_WORDS; ++w) {
    index += fm_popc(words[1 + w] & fm_word_mask(r, w));
  }
  *value = t.sampled_values[index];
  return true;
}

// the one sample chunk that can hold the row, searched over its real
// samples (the chunks are sorted and disjoint; the reference's sum over
// every chunk adds 0 for the others)
__host__ __device__ inline bool fm_sample_lookup(
    const FmShardedLocateTables& t, int row, int* value) {
  int chunk = 0, samples = t.layout[FM_LAYOUT_SAMPLES];
#pragma unroll 4
  for (int shard = 1; shard < t.fwd.num_shards; ++shard) {
    const int* layout = t.layout + shard * FM_LAYOUT_COLUMNS;
    const bool holds = row >= layout[FM_LAYOUT_SAMPLE_FIRST];
    chunk += holds;
    samples = holds ? layout[FM_LAYOUT_SAMPLES] : samples;
  }
  if (samples == 0) {
    *value = 0;
    return false;
  }
  return fm_sample_lookup(t.sampled_rows + (size_t)chunk * t.ns,
                          t.sampled_values + (size_t)chunk * t.ns, samples,
                          row, value);
}

// SA row -> (reference id, position): the reference's fixed-trip walk
// (a row that hits a sampled row stops there), then the sequence search.
// An index of -1 reads the last element, as the reference's gather does.
template <class Tables>
__host__ __device__ inline void fm_locate_row(const Tables& t, int row,
                                              int* seq_id, int* position) {
  int steps = 0;
  for (int step = 0; step < t.sampling_rate; ++step) {
    int value;
    if (fm_sample_lookup(t, row, &value)) {
      steps += value;
      break;
    }
    row = fm_lf(t, row);
    steps += 1;
  }
  const int seq = fm_upper_bound(t.seq_starts, t.num_seqs, steps) - 1;
  const int start = t.seq_starts[seq < 0 ? t.num_seqs - 1 : seq];
  *seq_id = seq;
  *position = steps - start;
}

