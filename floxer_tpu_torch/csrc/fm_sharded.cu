// K13, K13l: the row-sharded FM index's batched rank and locate, one
// thread per query: K13 reads every shard's table, K13l the table of the
// shard that owns each row.
//
// Replaces the XLA programs of the reference's sharded index: K13 is
// floxer_tpu/parallel/sharded_index.py's make_sharded_rank_fn (:93, body
// _local_rank_all :78; device_index.py rank_all's sharded branch
// :318-342), the occurrences of the six symbols before each global BWT
// position summed over the S shards; K13l is sharded_locate (:346), the
// locate_batch walk (device_index.py:455) whose bwt_at (:349-358) and
// _sample_lookup (:433-446) resolve through the shards. The reference
// runs a shard on each device of its index mesh axis and adds the
// partial counts with a psum; here the S shards lie on one device and one
// thread adds them (fm_rank.cuh's FmShardedRankTable).
//
// What bounds them on an H100: bytes. A sharded rank reads one 128-byte
// row of each shard (S rows at random blocks, the same row of a shard
// that the position falls before or after: its first or its last) and
// does ~86 int32 ops a shard; the queries are independent, so the row
// gathers' latency is hidden by occupancy (256 threads a block, every SM
// full at 2^20 queries), not by prefetch. The shard tables of a 4.6 Mb
// genome (~9.2 MB with both directions) stay in the 50 MB L2.
//
// Locate walks at most sampling_rate - 1 LF steps, each a dependent rank,
// then searches the sequence starts. Its design resolves the owner once
// a step (fm_rank.cuh's fm_lf and fm_sample_lookup over
// FmShardedLocateTables): each block first copies the shard layout
// (index/device_index.locate_layout: each shard's first row, its sample
// chunk's first row and size, and the symbol totals of the shards before
// it) into shared memory, so a step is S - 1 owner tests against it, one
// BWT byte and one 128-byte rank row of the owner, and one binary search
// of the one sample chunk that can hold the row (S - 1 tests more): the
// work of the unsharded walk (K9l) and 2 S compares, where summing every
// shard's rank and searching every chunk cost S of each. (Taking each
// step's LF before its sample search, to overlap the two, made K13l
// 1.23x K9l on an H100: the extra rank rows of the hit steps cost more
// than the overlap saved.)

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void fm_sharded_rank_kernel(FmShardedRankTable table,
                                       const int* __restrict__ positions,
                                       int B, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int counts[FM_SIGMA];
  fm_rank(table, positions[i], counts);
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) out[(size_t)i * FM_SIGMA + s] = counts[s];
}

// tables.layout: the shard layout in global memory, copied to shared
// memory (S * FM_LAYOUT_COLUMNS int32) before the walks read it
__global__ void fm_sharded_locate_kernel(FmShardedLocateTables tables,
                                         const int* __restrict__ rows, int B,
                                         int* __restrict__ seq_ids,
                                         int* __restrict__ positions) {
  extern __shared__ int layout[];
  const int words = tables.fwd.num_shards * FM_LAYOUT_COLUMNS;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    layout[w] = tables.layout[w];
  }
  __syncthreads();
  FmShardedLocateTables t = tables;
  t.layout = layout;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fm_locate_row(t, rows[i], seq_ids + i, positions + i);
}

FmShardedRankTable make_table(const void* rows, int shard_rows,
                              int row_offset, const void* starts,
                              const void* lengths, int num_shards) {
  FmShardedRankTable table;
  table.rows = static_cast<const uint32_t*>(rows);
  table.shard_rows = shard_rows;
  table.row_offset = row_offset;
  table.starts = static_cast<const int*>(starts);
  table.lengths = static_cast<const int*>(lengths);
  table.num_shards = num_shards;
  return table;
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// rows: [S, shard_rows, 32]; positions of the direction at row_offset
int floxer_fm_sharded_rank(const void* rows, int shard_rows, int row_offset,
                           const void* starts, const void* lengths,
                           int num_shards, const void* positions, int B,
                           void* out, void* stream) {
  fm_sharded_rank_kernel<<<blocks_for(B), kThreads, 0,
                           (cudaStream_t)stream>>>(
      make_table(rows, shard_rows, row_offset, starts, lengths, num_shards),
      static_cast<const int*>(positions), B, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// layout: [num_shards, FM_LAYOUT_COLUMNS] (fm_rank.cuh)
int floxer_fm_sharded_locate(const void* rows, int shard_rows,
                             int num_shards, const void* bwt, int bwt_stride,
                             const void* C, const void* sampled_rows,
                             const void* sampled_values, int ns,
                             const void* seq_starts, int num_seqs,
                             int sampling_rate, const void* layout,
                             const void* query_rows, int B, void* seq_ids,
                             void* positions, void* stream) {
  FmShardedLocateTables tables;
  tables.fwd = make_table(rows, shard_rows, 0, nullptr, nullptr, num_shards);
  tables.bwt = static_cast<const uint8_t*>(bwt);
  tables.bwt_stride = bwt_stride;
  tables.C = static_cast<const int*>(C);
  tables.sampled_rows = static_cast<const int*>(sampled_rows);
  tables.sampled_values = static_cast<const int*>(sampled_values);
  tables.ns = ns;
  tables.seq_starts = static_cast<const int*>(seq_starts);
  tables.num_seqs = num_seqs;
  tables.sampling_rate = sampling_rate;
  tables.layout = static_cast<const int*>(layout);
  const size_t shared_bytes =
      sizeof(int) * (size_t)num_shards * FM_LAYOUT_COLUMNS;
  fm_sharded_locate_kernel<<<blocks_for(B), kThreads, shared_bytes,
                             (cudaStream_t)stream>>>(
      tables, static_cast<const int*>(query_rows), B,
      static_cast<int*>(seq_ids), static_cast<int*>(positions));
  return (int)cudaGetLastError();
}

}  // extern "C"
