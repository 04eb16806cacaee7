// K9, K9x, K9l: the device FM index's batched rank, extension and locate.
//
// Replaces floxer_tpu/index/device_index.py's XLA programs: rank_all
// (:318, through _rank_all_planes :228 or rank_rows_lookup :260),
// extend_left_all / extend_right_all (:370, :387) and locate_batch (:455,
// with lf_step :448 and _sample_lookup :433).
//
// What bounds them on an H100: bytes. A rank reads one 128-byte row (the
// combined layout) or 24 + 96 bytes (the planes layout) at a random block
// and does ~90 int32 ops. The table of a 4.6 Mb genome (9.2 MB for both
// directions) stays in the 50 MB L2, so the rows come from L2.
//
// K9 and K9x. A thread a query read its row as eight loads of 16 bytes,
// so each warp load instruction touched 32 rows and used 16 bytes of
// each, and stored its six ints (K9x three sets of six) at a 24-byte
// stride: the load and store units, not the bytes, set its time. Now, in
// the combined layout, a warp takes 32 queries and copies their rows 8
// lanes a row, each lane a 16-byte piece (a warp copy reads 4 whole
// rows), into its shared region with cp.async, every copy in flight at
// once (stage_rows); each lane then ranks its own query from its staged
// row with the thread's arithmetic (fm_rank.cuh's fm_rank_words), and the
// warp's outputs leave through the same region as 16-byte vectors over
// its contiguous [32, 6] outputs (store_staged). K9x stages the rows at
// the cursors' bases and, in a second region, only the end rows of the
// intervals that end in another block; a one-row cursor ranks both ends
// on its base row (fm_rank.cuh's fm_interval_rank, the same rule on one
// thread). A group of 8 lanes a query that summed each symbol's words
// across lanes with shuffles read as well but issued ~7x the instructions
// a query and ran slower (PERF.md gives its price). In the planes
// layout a group of 8 lanes takes a query and lane s < 6 loads symbol s's
// checkpoint and its 16-byte plane row, which needs no sum across lanes.
// tests/test_torch_device_index.py's emulate_k9_staged and
// emulate_k9_planes mirror the schedules lane by lane.
//
// Locate walks at most sampling_rate - 1 LF steps (a dependent rank
// each), each step and the walk's end preceded by a lookup in the
// sampled-row plane (one 32-byte sector, and one sample value on a hit:
// fm_rank.cuh's fm_sample_lookup; the plane of that genome is 1.15 MB),
// then one binary search of the sequence starts, one thread a row. The
// lookup comes before the step's LF, as in the reference: the rank row of
// a step that hits would be read for nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// K9 and K9x in the combined layout: queries a warp, a row's 16-byte
// pieces, and K9x's threads a block
constexpr int kWarpQueries = 32;
constexpr int kExtendThreads = 128;
constexpr int kPieces = FM_ROW_WORDS / 4;
// in the planes layout: lanes a query, and queries a block
constexpr int kGroup = 8;
constexpr int kGroupQueries = kThreads / kGroup;

// fm_word_mask as one funnel shift: the top word of (0 : ~0) shifted left
// by clamp(r - offset, 0, 32), for offset = 32 w (the planes layout's
// group)
__device__ __forceinline__ uint32_t group_mask(int r, int offset) {
  const int below = r - offset;
  return __funnelshift_lc(0xFFFFFFFFu, 0u, below < 0 ? 0 : below);
}

// the planes layout: symbol s's plane words at a block (16 bytes) and its
// checkpoint
__device__ __forceinline__ uint4 group_plane_piece(const FmRankTable& t,
                                                   int block, int s,
                                                   int* checkpoint) {
  *checkpoint = __ldg(t.occ + (size_t)block * FM_SIGMA + s);
  return __ldg(reinterpret_cast<const uint4*>(
      t.planes + ((size_t)block * FM_SIGMA + s) * FM_PLANE_WORDS));
}

__device__ __forceinline__ int group_plane_rank(uint4 v, int checkpoint,
                                                int r) {
  return checkpoint + __popc(v.x & group_mask(r, 0)) +
         __popc(v.y & group_mask(r, 32)) + __popc(v.z & group_mask(r, 64)) +
         __popc(v.w & group_mask(r, 96));
}

// the exclusive prefix of the group's lanes' values (lanes 0..5 give the
// counts, 6 and 7 zero)
__device__ __forceinline__ int group_exclusive_prefix(int value, int j) {
  int sum = value;
#pragma unroll
  for (int d = 1; d < kGroup; d *= 2) {
    const int other = __shfl_up_sync(kFull, sum, d, kGroup);
    if (j >= d) sum += other;
  }
  return sum - value;
}

// 16 bytes from global to shared memory without a register (cp.async, in
// the L2 only: a row is read once), and the wait for the lane's own
__device__ __forceinline__ void copy_async16(uint4* to, const uint4* from) {
  const unsigned address =
      static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address),
               "l"(from));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The combined layout's warp of 32 queries (K9, K9x): the rows of its
// queries staged in the warp's shared region, 8 lanes a row: in copy k
// (k = 0..7) lane l copies the 16-byte piece l % 8 of query 4 k + l / 8's
// row, so each warp copy reads 4 whole rows, to slot 8 i + (p ^ (i & 7))
// of query i's 8, an XOR swizzle that puts the 8 pieces a lane then reads
// of its own row, and the 4 rows of a copy, on different bank quads. Only
// the rows of the queries that `need` one are read. The copies go straight
// to shared memory (cp.async), so all of them are in flight at once
// without holding a register; the caller waits (copy_async_wait) and
// syncs the warp before reading.
__device__ __forceinline__ void stage_rows(const uint32_t* rows, int block,
                                           bool need, uint4* stage,
                                           int lane) {
  const int p = lane & 7;
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int i = 4 * k + (lane >> 3);
    const int row = __shfl_sync(kFull, block, i);
    if (__shfl_sync(kFull, need ? 1 : 0, i) != 0) {
      copy_async16(stage + 8 * i + (p ^ (i & 7)),
                   reinterpret_cast<const uint4*>(
                       rows + (size_t)row * FM_ROW_WORDS) + p);
    }
  }
}

// the lane's own row (query `lane` of the warp) from the staged slots
__device__ __forceinline__ void staged_row(const uint4* stage, int lane,
                                           uint32_t words[FM_SIGMA * 5]) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const uint4 v = stage[8 * lane + (p ^ (lane & 7))];
    words[4 * p] = v.x;
    words[4 * p + 1] = v.y;
    if (4 * p + 2 < FM_SIGMA * 5) words[4 * p + 2] = v.z;
    if (4 * p + 3 < FM_SIGMA * 5) words[4 * p + 3] = v.w;
  }
}

// the warp's [32, 6] outputs from the lanes through its shared region to
// out as 16-byte vectors (queries [q0, q0 + valid); int by int when the
// warp is the batch's partial last one)
__device__ __forceinline__ void store_staged(int* stage,
                                             const int values[FM_SIGMA],
                                             int lane, int q0, int valid,
                                             int* out) {
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) stage[lane * FM_SIGMA + s] = values[s];
  __syncwarp();
  int* base = out + (size_t)q0 * FM_SIGMA;
  if (valid == kWarpQueries) {
    const int4* from = reinterpret_cast<const int4*>(stage);
    int4* to = reinterpret_cast<int4*>(base);
    for (int v = lane; v < kWarpQueries * FM_SIGMA / 4; v += 32) {
      to[v] = from[v];
    }
  } else {
    for (int v = lane; v < valid * FM_SIGMA; v += 32) base[v] = stage[v];
  }
}

// K9 in the combined layout: a warp 32 queries, their rows staged, each
// lane the rank of its own query (fm_rank_words), the six counts stored
// through the stage
__global__ void __launch_bounds__(kThreads)
    fm_rank_kernel(FmRankTable table, const int* __restrict__ positions,
                   int B, int* __restrict__ out) {
  __shared__ uint4 stages[kThreads / 32][kWarpQueries * kPieces];
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kThreads + threadIdx.x) - lane;
  const int q = q0 + lane;
  // a lane past the batch ranks position 0 and stores nothing: every lane
  // of the warp takes part in the staging
  const int position = q < B ? __ldg(positions + q) : 0;
  int block, r;
  fm_block_of(table, position, &block, &r);
  uint4* stage = stages[threadIdx.x >> 5];
  stage_rows(table.rows, block, true, stage, lane);
  copy_async_wait();
  __syncwarp();
  uint32_t words[FM_SIGMA * 5];
  staged_row(stage, lane, words);
  int counts[FM_SIGMA];
  fm_rank_words(words, r, counts);
  __syncwarp();
  store_staged(reinterpret_cast<int*>(stage), counts, lane, q0,
               B - q0 < kWarpQueries ? B - q0 : kWarpQueries, out);
}

// K9 in the planes layout: a group of 8 lanes a query, lane s < 6 the
// count of symbol s
__global__ void __launch_bounds__(kThreads)
    fm_rank_group_kernel(FmRankTable table,
                         const int* __restrict__ positions, int B,
                         int* __restrict__ out) {
  const int j = threadIdx.x % kGroup;
  const int q = blockIdx.x * kGroupQueries + threadIdx.x / kGroup;
  const bool valid = q < B;
  const int position = valid ? __ldg(positions + q) : 0;
  int block, r;
  fm_block_of(table, position, &block, &r);
  int checkpoint;
  const uint4 v = group_plane_piece(
      table, block, j < FM_SIGMA ? j : FM_SIGMA - 1, &checkpoint);
  const int count = group_plane_rank(v, checkpoint, r);
  if (valid && j < FM_SIGMA) out[(size_t)q * FM_SIGMA + j] = count;
}

// K9x in the combined layout: one bidirectional extension step for every
// symbol (fm_extend_all's function), a warp 32 cursors. The warp stages
// the rows at its cursors' bases and, in a second region, the rows at the
// ends of the cursors whose interval ends in another block, all copies in
// flight at once; each lane ranks its base on its base row and its end on
// its end row or, for a one-row cursor, its base row again; the three
// outputs go out through the stage. Blocks of kExtendThreads, so the
// stages of both rows fit the static shared memory.
__global__ void __launch_bounds__(kExtendThreads)
    fm_extend_kernel(FmRankTable table, const int* __restrict__ C,
                     const int* __restrict__ lb,
                     const int* __restrict__ lb_rev,
                     const int* __restrict__ length, int B, int left,
                     int* __restrict__ new_lb, int* __restrict__ new_lb_rev,
                     int* __restrict__ counts) {
  __shared__ uint4 stages[kExtendThreads / 32][2][kWarpQueries * kPieces];
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kExtendThreads + threadIdx.x) - lane;
  const int q = q0 + lane;
  const bool valid = q < B;
  const int cursor_lb = valid ? __ldg(lb + q) : 0;
  const int cursor_lb_rev = valid ? __ldg(lb_rev + q) : 0;
  const int cursor_length = valid ? __ldg(length + q) : 0;
  const int base = left ? cursor_lb : cursor_lb_rev;
  int block_lo, r_lo, block_hi, r_hi;
  fm_block_of(table, base, &block_lo, &r_lo);
  fm_block_of(table, base + cursor_length, &block_hi, &r_hi);
  const bool two_rows = block_hi != block_lo;
  uint4* stage_lo = stages[threadIdx.x >> 5][0];
  uint4* stage_hi = stages[threadIdx.x >> 5][1];
  stage_rows(table.rows, block_lo, true, stage_lo, lane);
  stage_rows(table.rows, block_hi, two_rows, stage_hi, lane);
  copy_async_wait();
  __syncwarp();
  uint32_t words[FM_SIGMA * 5];
  int lo[FM_SIGMA], hi[FM_SIGMA];
  staged_row(stage_lo, lane, words);
  fm_rank_words(words, r_lo, lo);
  staged_row(two_rows ? stage_hi : stage_lo, lane, words);
  fm_rank_words(words, r_hi, hi);
  int count[FM_SIGMA], child_lb[FM_SIGMA], child_lb_rev[FM_SIGMA],
      child_count[FM_SIGMA];
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) count[s] = hi[s] - lo[s];
  fm_children(C, left ? cursor_lb_rev : cursor_lb, left != 0, lo, count,
              child_lb, child_lb_rev, child_count);
  const int warp_valid = B - q0 < kWarpQueries ? B - q0 : kWarpQueries;
  int* ints = reinterpret_cast<int*>(stage_lo);
  __syncwarp();
  store_staged(ints, child_lb, lane, q0, warp_valid, new_lb);
  store_staged(ints + kWarpQueries * FM_SIGMA, child_lb_rev, lane, q0,
               warp_valid, new_lb_rev);
  store_staged(ints + 2 * kWarpQueries * FM_SIGMA, child_count, lane, q0,
               warp_valid, counts);
}

// K9x in the planes layout: a group of 8 lanes a cursor, lanes 0..5 a
// symbol each (the end's plane row read only when it lies in another
// block), the counts' exclusive prefix by three shuffles up
__global__ void __launch_bounds__(kThreads)
    fm_extend_group_kernel(FmRankTable table, const int* __restrict__ C,
                           const int* __restrict__ lb,
                           const int* __restrict__ lb_rev,
                           const int* __restrict__ length, int B, int left,
                           int* __restrict__ new_lb,
                           int* __restrict__ new_lb_rev,
                           int* __restrict__ counts) {
  const int j = threadIdx.x % kGroup;
  const int q = blockIdx.x * kGroupQueries + threadIdx.x / kGroup;
  const bool valid = q < B;
  const int cursor_lb = valid ? __ldg(lb + q) : 0;
  const int cursor_lb_rev = valid ? __ldg(lb_rev + q) : 0;
  const int cursor_length = valid ? __ldg(length + q) : 0;
  const int base = left ? cursor_lb : cursor_lb_rev;
  const int secondary = left ? cursor_lb_rev : cursor_lb;
  int block_lo, r_lo, block_hi, r_hi;
  fm_block_of(table, base, &block_lo, &r_lo);
  fm_block_of(table, base + cursor_length, &block_hi, &r_hi);
  const bool two_rows = block_hi != block_lo;
  const int s = j < FM_SIGMA ? j : FM_SIGMA - 1;
  int checkpoint_lo, checkpoint_hi;
  const uint4 v_lo = group_plane_piece(table, block_lo, s, &checkpoint_lo);
  uint4 v_hi = v_lo;
  checkpoint_hi = checkpoint_lo;
  if (two_rows) v_hi = group_plane_piece(table, block_hi, s, &checkpoint_hi);
  const int lo = group_plane_rank(v_lo, checkpoint_lo, r_lo);
  const int count = group_plane_rank(v_hi, checkpoint_hi, r_hi) - lo;
  const int prefix = group_exclusive_prefix(j < FM_SIGMA ? count : 0, j);
  const int primary = __ldg(C + s) + lo;
  const int other = secondary + prefix;
  if (valid && j < FM_SIGMA) {
    const size_t at = (size_t)q * FM_SIGMA + j;
    new_lb[at] = left ? primary : other;
    new_lb_rev[at] = left ? other : primary;
    counts[at] = count;
  }
}

// SA row -> (reference id, position) (fm_locate_row)
__global__ void fm_locate_kernel(FmLocateTables tables,
                                 const int* __restrict__ rows, int B,
                                 int* __restrict__ seq_ids,
                                 int* __restrict__ positions) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fm_locate_row(tables, rows[i], seq_ids + i, positions + i);
}

FmRankTable make_table(const void* rows, const void* occ, const void* planes,
                       int row_offset) {
  FmRankTable table;
  table.rows = static_cast<const uint32_t*>(rows);
  table.occ = static_cast<const int32_t*>(occ);
  table.planes = static_cast<const uint32_t*>(planes);
  table.row_offset = row_offset;
  return table;
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

int group_blocks_for(int B) {
  return (B + kGroupQueries - 1) / kGroupQueries;
}

}  // namespace

extern "C" {

// rows: the combined table or null (then occ and planes of one direction)
int floxer_fm_rank(const void* rows, const void* occ, const void* planes,
                   int row_offset, const void* positions, int B, void* out,
                   void* stream) {
  const FmRankTable table = make_table(rows, occ, planes, row_offset);
  const int* p = static_cast<const int*>(positions);
  int* o = static_cast<int*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows != nullptr) {
    fm_rank_kernel<<<blocks_for(B), kThreads, 0, s>>>(table, p, B, o);
  } else {
    fm_rank_group_kernel<<<group_blocks_for(B), kThreads, 0, s>>>(table, p,
                                                                  B, o);
  }
  return (int)cudaGetLastError();
}

int floxer_fm_extend(const void* rows, const void* occ, const void* planes,
                     int row_offset, const void* C, const void* lb,
                     const void* lb_rev, const void* length, int B, int left,
                     void* new_lb, void* new_lb_rev, void* counts,
                     void* stream) {
  const FmRankTable table = make_table(rows, occ, planes, row_offset);
  const int* c = static_cast<const int*>(C);
  const int* a = static_cast<const int*>(lb);
  const int* b = static_cast<const int*>(lb_rev);
  const int* n = static_cast<const int*>(length);
  int* x = static_cast<int*>(new_lb);
  int* y = static_cast<int*>(new_lb_rev);
  int* z = static_cast<int*>(counts);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows != nullptr) {
    fm_extend_kernel<<<(B + kExtendThreads - 1) / kExtendThreads,
                       kExtendThreads, 0, s>>>(table, c, a, b, n, B, left, x,
                                               y, z);
  } else {
    fm_extend_group_kernel<<<group_blocks_for(B), kThreads, 0, s>>>(
        table, c, a, b, n, B, left, x, y, z);
  }
  return (int)cudaGetLastError();
}

// sample_plane: [n / 128 + 1, FM_SAMPLE_WORDS] (fm_rank.cuh); n the rows
int floxer_fm_locate(const void* rows, const void* occ, const void* planes,
                     const void* bwt, const void* C, const void* sample_plane,
                     const void* sampled_values, int n,
                     const void* seq_starts, int num_seqs, int sampling_rate,
                     const void* query_rows, int B, void* seq_ids,
                     void* positions, void* stream) {
  FmLocateTables tables;
  tables.fwd = make_table(rows, occ, planes, 0);
  tables.bwt = static_cast<const uint8_t*>(bwt);
  tables.C = static_cast<const int*>(C);
  tables.sample_plane = static_cast<const uint32_t*>(sample_plane);
  tables.sampled_values = static_cast<const int*>(sampled_values);
  tables.n = n;
  tables.seq_starts = static_cast<const int*>(seq_starts);
  tables.num_seqs = num_seqs;
  tables.sampling_rate = sampling_rate;
  fm_locate_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      tables, static_cast<const int*>(query_rows), B,
      static_cast<int*>(seq_ids), static_cast<int*>(positions));
  return (int)cudaGetLastError();
}

}  // extern "C"
