// K9, K9x, K9l: the device FM index's batched rank, extension and locate,
// one thread per query.
//
// Replaces floxer_tpu/index/device_index.py's XLA programs: rank_all
// (:318, through _rank_all_planes :228 or rank_rows_lookup :260),
// extend_left_all / extend_right_all (:370, :387) and locate_batch (:455,
// with lf_step :448 and _sample_lookup :433).
//
// What bounds them on an H100: bytes. A rank reads one 128-byte row (the
// combined layout) or 24 + 96 bytes (the planes layout) at a random block
// and does ~90 int32 ops; the queries are independent, so the row gathers'
// latency is hidden by occupancy (one thread a query, 256 a block, every
// SM full at the batch sizes the callers use), not by prefetch. The
// table of a 4.6 Mb genome (9.2 MB for both directions) stays in the 50 MB
// L2. Locate walks at most sampling_rate - 1 LF steps (a dependent rank
// each), each step and the walk's end preceded by a lookup in the
// sampled-row plane (one 32-byte sector, and one sample value on a hit:
// fm_rank.cuh's fm_sample_lookup; the plane of that genome is 1.15 MB),
// then one binary search of the sequence starts. The lookup comes before
// the step's LF, as in the reference: the rank row of a step that hits
// would be read for nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void fm_rank_kernel(FmRankTable table, const int* __restrict__ positions,
                               int B, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int counts[FM_SIGMA];
  fm_rank(table, positions[i], counts);
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) out[(size_t)i * FM_SIGMA + s] = counts[s];
}

// one bidirectional extension step for every symbol (fm_extend_all)
__global__ void fm_extend_kernel(FmRankTable table, const int* __restrict__ C,
                                 const int* __restrict__ lb,
                                 const int* __restrict__ lb_rev,
                                 const int* __restrict__ length, int B,
                                 int left, int* __restrict__ new_lb,
                                 int* __restrict__ new_lb_rev,
                                 int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int child_lb[FM_SIGMA], child_lb_rev[FM_SIGMA], count[FM_SIGMA];
  fm_extend_all(table, C, lb[i], lb_rev[i], length[i], left != 0, child_lb,
                child_lb_rev, count);
#pragma unroll
  for (int s = 0; s < FM_SIGMA; ++s) {
    const size_t at = (size_t)i * FM_SIGMA + s;
    new_lb[at] = child_lb[s];
    new_lb_rev[at] = child_lb_rev[s];
    counts[at] = count[s];
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

}  // namespace

extern "C" {

// rows: the combined table or null (then occ and planes of one direction)
int floxer_fm_rank(const void* rows, const void* occ, const void* planes,
                   int row_offset, const void* positions, int B, void* out,
                   void* stream) {
  fm_rank_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_table(rows, occ, planes, row_offset),
      static_cast<const int*>(positions), B, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

int floxer_fm_extend(const void* rows, const void* occ, const void* planes,
                     int row_offset, const void* C, const void* lb,
                     const void* lb_rev, const void* length, int B, int left,
                     void* new_lb, void* new_lb_rev, void* counts,
                     void* stream) {
  fm_extend_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_table(rows, occ, planes, row_offset), static_cast<const int*>(C),
      static_cast<const int*>(lb), static_cast<const int*>(lb_rev),
      static_cast<const int*>(length), B, left, static_cast<int*>(new_lb),
      static_cast<int*>(new_lb_rev), static_cast<int*>(counts));
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
