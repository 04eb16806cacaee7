// K13, K13l: the row-sharded FM index's batched rank and locate, one
// thread per query, each reading the table of the shard that owns its
// position or row.
//
// Replaces the XLA programs of the reference's sharded index: K13 is
// floxer_tpu/parallel/sharded_index.py's make_sharded_rank_fn (:93, body
// _local_rank_all :78; device_index.py rank_all's sharded branch
// :318-342), the occurrences of the six symbols before each global BWT
// position summed over the S shards; K13l is sharded_locate (:346), the
// locate_batch walk (device_index.py:455) whose bwt_at (:349-358) and
// _sample_lookup (:433-446) resolve through the shards. The reference
// runs a shard on each device of its index mesh axis and adds the
// partial counts with a psum; here the S shards lie on one device, and
// since they are contiguous and ascending, the shards before the one that
// owns a position add their totals and those after it add 0.
//
// What bounds them on an H100: bytes. A sharded rank (fm_rank.cuh's
// FmShardedRankTable) tests the S - 1 shard starts, selecting the owner's
// start and length beside the tests, reads the owner's one 128-byte rank
// row at a random block and adds its six totals of the shards before
// (index/device_index.shard_before): the work of K9 and S compares, where
// summing every shard's rank read S rows. Each block first copies the
// starts, lengths and totals (8 int32 a shard) to shared memory, as K13l
// copies its layout: read from there, K13 ran 1.12x faster on an H100
// than with the same words read through L1 at every rank. The queries are independent, so the row gathers' latency is
// hidden by occupancy (256 threads a block, every SM full at 2^20
// queries), not by prefetch. The shard tables of a 4.6 Mb genome (~9.2 MB
// with both directions) stay in the 50 MB L2.
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
// work of the unsharded walk (K9l before its sampled-row plane) and 2 S
// compares, where summing every shard's rank and searching every chunk
// cost S of each. (Taking each step's LF before its sample search, to
// overlap the two, made K13l 1.23x K9l on an H100: the extra rank rows of
// the hit steps cost more than the overlap saved.)

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 256;

// table.starts, lengths and before: in global memory, copied to shared
// memory (FM_STAGED_WORDS(S) int32) before the ranks read them
__global__ void fm_sharded_rank_kernel(FmShardedRankTable table,
                                       const int* __restrict__ positions,
                                       int B, int* __restrict__ out) {
  extern __shared__ int staged[];
  const FmShardedRankTable t = fm_stage_shards(table, staged);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int counts[FM_SIGMA];
  fm_rank(t, positions[i], counts);
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
                              const void* lengths, const void* before,
                              int num_shards) {
  FmShardedRankTable table;
  table.rows = static_cast<const uint32_t*>(rows);
  table.shard_rows = shard_rows;
  table.row_offset = row_offset;
  table.starts = static_cast<const int*>(starts);
  table.lengths = static_cast<const int*>(lengths);
  table.before = static_cast<const int*>(before);
  table.num_shards = num_shards;
  return table;
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// rows: [S, shard_rows, 32]; positions of the direction at row_offset;
// before: [S, 6], each symbol's total over the shards before
int floxer_fm_sharded_rank(const void* rows, int shard_rows, int row_offset,
                           const void* starts, const void* lengths,
                           const void* before, int num_shards,
                           const void* positions, int B, void* out,
                           void* stream) {
  const size_t shared_bytes = sizeof(int) * FM_STAGED_WORDS(num_shards);
  fm_sharded_rank_kernel<<<blocks_for(B), kThreads, shared_bytes,
                           (cudaStream_t)stream>>>(
      make_table(rows, shard_rows, row_offset, starts, lengths, before,
                 num_shards),
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
  tables.fwd = make_table(rows, shard_rows, 0, nullptr, nullptr, nullptr,
                          num_shards);
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
