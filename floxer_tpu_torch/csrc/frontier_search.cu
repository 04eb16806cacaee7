// K11: the per-query masked-frontier scheme search, one thread-block
// cluster a frontier.
//
// Replaces floxer_tpu/search_device.py's _frontier_search (:1333) with
// _frontier_block (:921) and _compact_done_rows (:1391): the XLA program
// that advances a block of seeds' search states together. Each
// iteration replaces every state of the frontier by its children in the
// host DFS's edge order (itself when done, finishing or advancing a
// part; the match; substitutions by symbol, the pattern's own skipped;
// insertions by symbol; the deletion), written in (parent slot, edge)
// order, so the frontier stays a DFS-prefix ordering and the done rows
// of the last frontier, in slot order, are the reports in host-DFS order.
// Children past the capacity are dropped and set the overflow flag, which
// ends the loop; the truncated frontier still yields its done rows. The
// output equals the reference's bit for bit, the report order and the
// overflow flag included.
//
// Design: the frontier, [10 fields, C] int32 field-major, is double
// buffered in global scratch (it stays in L2). A frontier runs on a
// cluster of B blocks (the launch's cluster dimension: 1, 2, 4, 8 or 16,
// picked by the wrapper), which walks the current frontier in rounds of
// B x kThreads consecutive slots, block r of the cluster taking slots
// [round + r kThreads, +kThreads), one slot a thread: the thread finds
// its state's kinds of child (the ranks of all six symbols at both ends
// of its interval when the state extends, fm_extend_all: one rank row
// when the interval lies in one block, two otherwise), a block-wide
// exclusive scan of the child counts gives each parent its offset within
// its block, and each block
// publishes its total in shared memory; after a cluster barrier every
// warp reads the totals of the cluster's blocks through distributed
// shared memory (cluster.map_shared_rank), so a block's children follow
// those of the blocks of lower rank and of the earlier rounds: exactly
// the slot order one block writes, so the slot order, the capacity cut
// and the overflow flag do not depend on B. The published totals are
// double buffered by exchange parity, so one cluster barrier a round
// suffices. At an iteration's end the blocks' alive flags are exchanged
// the same way; that exchange's cluster barrier (cluster.sync():
// barrier.cluster.arrive.release and barrier.cluster.wait.acquire) also
// orders this iteration's frontier writes before the next iteration's
// reads of them in the other blocks of the cluster, and those reads go
// to L2 (__ldcg), never to a stale line of the reading SM's L1. A last
// pass of rounds compacts the done rows into the reports the same way,
// and the expanded states are summed over the cluster. B = 1 is a plain
// launch with no exchange and the frontier read through L1: the block's
// scans and barriers are those of the one-block kernel it replaces.
// A launch takes F independent frontiers of one shape, one cluster each,
// every one with its own capacity and flag.
//
// What bounds it on an H100: operations, ~250 int32 ops an expanded state
// (two ranks of 6 symbols x 4 masked popcounts, the 13 kinds' tests, the
// children's intervals; chip_smoke.py's FRONTIER_OPS_PER_STATE) plus the
// copy of every kept row, against a bound counted from the states this
// run expanded. A small frontier (the per-query path, one frontier a
// launch) is latency-bound: every round pays the slot loads, two rank-row
// gathers, a block scan and the children's writes, so a cluster that
// takes an iteration's whole frontier in one round cuts the iteration to
// about one round's latency plus two cluster barriers; a launch of many
// frontiers (the legacy block loop) fills the card with B = 1.
//
// Over the row-sharded index (frontier_kernel<FmShardedRankTable>, the
// counterpart of floxer_tpu/parallel/sharded_index.py's
// sharded_frontier_search :371) each rank reads the one row of the shard
// that owns its position and adds the earlier shards' totals
// (fm_rank.cuh), the reference's sum over the shards; the frontier, its
// order and its flag are those of the unsharded kernel, since the counts
// are. Each block first copies both directions' shard starts, lengths and
// totals to shared memory (stage_tables; 2-3% faster on an H100 than
// reading them through L1 at every rank).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// the largest cluster a frontier may take (above 8 blocks a non-portable
// size, placed only where cudaOccupancyMaxActiveClusters says it fits)
constexpr int kMaxCluster = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 10;
constexpr int kKinds = 13;

enum { kOpM = 0, kOpI = 1, kOpD = 2 };
// frontier fields
enum { fLb, fLbRev, fLen, fPos, fErr, fOp, fPart, fSearch, fSeed, fDone };
// fused scheme row: direction, start, end, lower, upper, then the next
// part's direction, start, end
enum { kDir, kStart, kEnd, kLower, kUpper, kNextDir, kNextStart, kNextEnd };
// a frontier's stats row
enum { sReports, sOverflow, sIterations, sExpanded, kStats };

template <class Table>
struct Params {
  Table fwd, rev;
  const int* C;
  int n;
  const int* patterns;    // [F * S, L]
  const int* seed_class;  // [F * S]
  int num_seeds, pad_len;
  const int* scheme;  // [classes * searches * parts, 8]
  int num_searches, num_parts;
  int capacity, report_capacity, max_iterations;
  int* frontier;  // [F, 2, kFields, capacity]
  int* reports;   // [F, report_capacity, 5], zeroed by the caller
  int* stats;     // [F, kStats]
};

__device__ inline int pick(const int (&a)[FM_SIGMA], int s) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < FM_SIGMA; ++i) v = i == s ? a[i] : v;
  return v;
}

// exclusive prefix of `value` over the block's threads in thread order;
// *total gets the block's sum (every thread must call it)
__device__ inline int block_exclusive_scan(int value, int* warp_sums,
                                           int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inclusive = value;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, inclusive, d);
    if (lane >= d) inclusive += v;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < kWarps ? warp_sums[lane] : 0;
    int running = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, running, d);
      if (lane >= d) running += v;
    }
    if (lane < kWarps) warp_sums[lane] = running - mine;
    if (lane == kWarps - 1) warp_sums[kWarps] = running;
  }
  __syncthreads();
  const int prefix = warp_sums[warp] + inclusive - value;
  *total = warp_sums[kWarps];
  __syncthreads();  // warp_sums is free for the next scan
  return prefix;
}

// one int of each block summed over the cluster: (the blocks of lower
// rank, all blocks). Every thread calls it with its block's value; each
// warp reads the cluster's published values through distributed shared
// memory after the cluster barrier. `exchange` is double buffered by
// `parity`, which the caller flips after each call: a block rewrites a
// buffer only after the next exchange's barrier, which every block passes
// once it has read this one.
__device__ inline void cluster_sums(cg::cluster_group& cluster,
                                    int blocks, int rank, int* exchange,
                                    int& parity, int value, int& lower,
                                    int& all) {
  if (blocks == 1) {
    lower = 0;
    all = value;
    return;
  }
  if (threadIdx.x == 0) exchange[parity] = value;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const int v =
      lane < blocks ? *cluster.map_shared_rank(exchange + parity, lane) : 0;
  lower = __reduce_add_sync(0xFFFFFFFFu, lane < rank ? v : 0);
  all = __reduce_add_sync(0xFFFFFFFFu, v);
  parity ^= 1;
}

// a frontier field: through L1 when this block wrote the frontier alone,
// from L2 when other blocks of the cluster wrote part of it
__device__ inline int field(const int* at, bool alone) {
  return alone ? *at : __ldcg(at);
}

__device__ inline void put(int* buffer, int C, int slot, int lb, int lb_rev,
                           int len, int pos, int err, int op, int part,
                           int search, int seed, int done) {
  buffer[fLb * C + slot] = lb;
  buffer[fLbRev * C + slot] = lb_rev;
  buffer[fLen * C + slot] = len;
  buffer[fPos * C + slot] = pos;
  buffer[fErr * C + slot] = err;
  buffer[fOp * C + slot] = op;
  buffer[fPart * C + slot] = part;
  buffer[fSearch * C + slot] = search;
  buffer[fSeed * C + slot] = seed;
  buffer[fDone * C + slot] = done;
}

// the sharded instance's blocks read the shard tables' starts, lengths
// and totals from shared memory (both directions, staged at the start)
__device__ inline void stage_tables(Params<FmRankTable>&, int*) {}
__device__ inline void stage_tables(Params<FmShardedRankTable>& p,
                                    int* staged) {
  p.fwd = fm_stage_shards(p.fwd, staged);
  p.rev = fm_stage_shards(p.rev, staged + FM_STAGED_WORDS(p.fwd.num_shards));
  __syncthreads();
}
inline size_t staged_bytes(const Params<FmRankTable>&) { return 0; }
inline size_t staged_bytes(const Params<FmShardedRankTable>& p) {
  return 2 * sizeof(int) * FM_STAGED_WORDS(p.fwd.num_shards);
}

template <class Table>
__global__ void __launch_bounds__(kThreads) frontier_kernel(Params<Table> p) {
  __shared__ int warp_sums[kWarps + 1];
  __shared__ int exchange[2];
  extern __shared__ int staged[];
  stage_tables(p, staged);
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool alone = blocks == 1;
  const int width = blocks * kThreads;  // slots a round
  const int mine = rank * kThreads + threadIdx.x;  // this thread's slot in it
  int parity = 0;
  const int C = p.capacity;
  const int parts = p.num_parts;
  const size_t frontier_id = blockIdx.x / blocks;
  const int* patterns =
      p.patterns + frontier_id * (size_t)p.num_seeds * p.pad_len;
  const int* seed_class = p.seed_class + frontier_id * (size_t)p.num_seeds;
  int* cur = p.frontier + frontier_id * 2 * kFields * (size_t)C;
  int* next = cur + kFields * (size_t)C;

  // the initial frontier: one state per (seed, search), search-minor; a
  // capacity below it is an immediate overflow
  const long long init_count = (long long)p.num_seeds * p.num_searches;
  bool overflow = init_count > C;
  int count = overflow ? C : (int)init_count;
  for (int j = mine; j < count; j += width) {
    const int seed = j / p.num_searches;
    const int search = j - seed * p.num_searches;
    const int* row0 =
        p.scheme + (size_t)(seed_class[seed] * p.num_searches + search) * parts * 8;
    const int dir0 = row0[kDir];
    put(cur, C, j, 0, 0, p.n,
        row0[kStart] * (dir0 > 0) + (row0[kEnd] - 1) * (dir0 < 0), 0, kOpM,
        0, search, seed, 0);
  }
  bool alive = count > 0;
  int iterations = 0;
  int expanded = 0;  // this thread's expanded states
  if (alone) {
    __syncthreads();
  } else {
    cluster.sync();
  }

  while (iterations < p.max_iterations && !overflow && alive) {
    int written = 0;  // children of the earlier rounds (cluster-uniform)
    bool wrote_alive = false;
    for (int round = 0; round < count; round += width) {
      const int j = round + mine;
      unsigned mask = 0;
      int lb = 0, lb_rev = 0, len = 0, pos = 0, err = 0, op = kOpM, part = 0;
      int search = 0, seed = 0, done = 0, dir = 1, ms = 0;
      int pos_self = 0, part_self = 0, done_self = 0;
      int child_lb[FM_SIGMA], child_lb_rev[FM_SIGMA], counts[FM_SIGMA];
#pragma unroll
      for (int s = 0; s < FM_SIGMA; ++s) {
        child_lb[s] = 0;
        child_lb_rev[s] = 0;
        counts[s] = 0;
      }
      if (j < count) {
        lb = field(cur + fLb * C + j, alone);
        lb_rev = field(cur + fLbRev * C + j, alone);
        len = field(cur + fLen * C + j, alone);
        pos = field(cur + fPos * C + j, alone);
        err = field(cur + fErr * C + j, alone);
        op = field(cur + fOp * C + j, alone);
        part = field(cur + fPart * C + j, alone);
        search = field(cur + fSearch * C + j, alone);
        seed = field(cur + fSeed * C + j, alone);
        done = field(cur + fDone * C + j, alone);
        // the row of the clipped part; the raw part decides the finish
        const int part_c = part < 0 ? 0 : (part > parts - 1 ? parts - 1 : part);
        const int* row =
            p.scheme +
            ((size_t)(seed_class[seed] * p.num_searches + search) * parts + part_c) * 8;
        dir = row[kDir];
        const bool alive_state = done == 0;
        const bool at_boundary =
            alive_state && (dir > 0 ? pos >= row[kEnd] : pos < row[kStart]);
        const bool meets_lower = err >= row[kLower];
        const bool finished = at_boundary && meets_lower && part == parts - 1;
        const bool advancing = at_boundary && meets_lower && !finished;
        const int next_first =
            row[kNextDir] > 0 ? row[kNextStart] : row[kNextEnd] - 1;
        pos_self = advancing ? next_first : pos;
        part_self = advancing ? part + 1 : part;
        done_self = (done != 0 || finished) ? 1 : 0;
        if (done != 0 || finished || advancing) mask |= 1u;
        if (alive_state && !at_boundary) {
          ++expanded;
          const bool left = dir < 0;
          fm_extend_all(fm_pick(p.fwd, p.rev, left), p.C, lb, lb_rev, len,
                        left, child_lb, child_lb_rev, counts);
          int pc = pos < 0 ? 0 : (pos > p.pad_len - 1 ? p.pad_len - 1 : pos);
          const int symbol = patterns[(size_t)seed * p.pad_len + pc];
          ms = symbol >= 1 && symbol < FM_SIGMA ? symbol : 0;
          if (pick(counts, ms) > 0) mask |= 1u << 1;
          if (err < row[kUpper]) {
#pragma unroll
            for (int s = 1; s < FM_SIGMA; ++s) {
              if (symbol != s && counts[s] > 0) mask |= 1u << (1 + s);
              if (counts[s] > 0 && op != kOpD) mask |= 1u << (6 + s);
            }
            if (op != kOpI) mask |= 1u << 12;
          }
        }
      }
      int block_total, lower, round_total;
      const int prefix = block_exclusive_scan(__popc(mask), warp_sums,
                                              &block_total);
      cluster_sums(cluster, blocks, rank, exchange, parity, block_total,
                   lower, round_total);
      int at = written + lower + prefix;
#pragma unroll
      for (int k = 0; k < kKinds; ++k) {
        if (mask & (1u << k)) {
          if (at < C) {
            if (k == 0) {
              put(next, C, at, lb, lb_rev, len, pos_self, err, op, part_self,
                  search, seed, done_self);
              wrote_alive |= done_self == 0;
            } else if (k == 1) {
              put(next, C, at, pick(child_lb, ms), pick(child_lb_rev, ms),
                  pick(counts, ms), pos + dir, err, kOpM, part, search, seed,
                  0);
              wrote_alive = true;
            } else if (k <= 6) {
              const int s = k - 1;
              put(next, C, at, child_lb[s], child_lb_rev[s], counts[s],
                  pos + dir, err + 1, kOpM, part, search, seed, 0);
              wrote_alive = true;
            } else if (k <= 11) {
              const int s = k - 6;
              put(next, C, at, child_lb[s], child_lb_rev[s], counts[s], pos,
                  err + 1, kOpI, part, search, seed, 0);
              wrote_alive = true;
            } else {
              put(next, C, at, lb, lb_rev, len, pos + dir, err + 1, kOpD,
                  part, search, seed, 0);
              wrote_alive = true;
            }
          }
          ++at;
        }
      }
      written += round_total;
    }
    overflow = written > C;
    count = overflow ? C : written;
    int* swap = cur;
    cur = next;
    next = swap;
    ++iterations;
    // the cluster's alive flag; with B > 1 its exchange's barrier orders
    // this iteration's frontier writes before the next one's reads
    const int block_alive = __syncthreads_or(wrote_alive);
    int lower, any;
    cluster_sums(cluster, blocks, rank, exchange, parity, block_alive, lower,
                 any);
    alive = any != 0;
  }

  // the done rows of the final frontier, in slot order
  int num_done = 0;
  int* reports = p.reports + frontier_id * (size_t)p.report_capacity * 5;
  for (int round = 0; round < count; round += width) {
    const int j = round + mine;
    const int is_done =
        j < count && field(cur + fDone * C + j, alone) != 0 ? 1 : 0;
    int block_total, lower, round_total;
    const int prefix = block_exclusive_scan(is_done, warp_sums, &block_total);
    cluster_sums(cluster, blocks, rank, exchange, parity, block_total, lower,
                 round_total);
    const int at = num_done + lower + prefix;
    if (is_done && at < p.report_capacity) {
      int* row = reports + (size_t)at * 5;
      row[0] = field(cur + fLb * C + j, alone);
      row[1] = field(cur + fLbRev * C + j, alone);
      row[2] = field(cur + fLen * C + j, alone);
      row[3] = field(cur + fErr * C + j, alone);
      row[4] = field(cur + fSeed * C + j, alone);
    }
    num_done += round_total;
  }
  int block_expanded, lower, expanded_total;
  block_exclusive_scan(expanded, warp_sums, &block_expanded);
  cluster_sums(cluster, blocks, rank, exchange, parity, block_expanded, lower,
               expanded_total);
  if (rank == 0 && threadIdx.x == 0) {
    int* stats = p.stats + frontier_id * kStats;
    stats[sReports] =
        num_done < p.report_capacity ? num_done : p.report_capacity;
    stats[sOverflow] = overflow || num_done > p.report_capacity ? 1 : 0;
    stats[sIterations] = iterations;
    stats[sExpanded] = expanded_total;
  }
  // no block leaves while another may still read its shared memory
  if (blocks > 1) cluster.sync();
}

// the operands both tables' launches share
template <class Table>
void fill_common(Params<Table>& p, const void* C, int n, const void* patterns,
                 const void* seed_class, int num_seeds, int pad_len,
                 const void* scheme, int num_searches, int num_parts,
                 int capacity, int report_capacity, int max_iterations,
                 void* frontier, void* reports, void* stats) {
  p.C = static_cast<const int*>(C);
  p.n = n;
  p.patterns = static_cast<const int*>(patterns);
  p.seed_class = static_cast<const int*>(seed_class);
  p.num_seeds = num_seeds;
  p.pad_len = pad_len;
  p.scheme = static_cast<const int*>(scheme);
  p.num_searches = num_searches;
  p.num_parts = num_parts;
  p.capacity = capacity;
  p.report_capacity = report_capacity;
  p.max_iterations = max_iterations;
  p.frontier = static_cast<int*>(frontier);
  p.reports = static_cast<int*>(reports);
  p.stats = static_cast<int*>(stats);
}

// clusters of `cluster` blocks of `kernel` the card holds at once (0 when
// none fits); above 8 blocks the kernel is first allowed a non-portable
// size
cudaError_t max_active_clusters(const void* kernel, int cluster, int* out) {
  *out = 0;
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (cluster > 8) {
    const cudaError_t error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (error != cudaSuccess) return error;
  }
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kThreads);
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &config);
}

// F frontiers on clusters of `cluster` blocks (grid F x cluster; one
// block a frontier is a launch without clusters). A cluster size outside
// 1..kMaxCluster, or one the card cannot place (no cluster of it fits),
// is refused with an error, as a launch the runtime rejects is.
template <class Table>
cudaError_t launch_frontiers(const Params<Table>& p, int num_frontiers,
                             int cluster, void* stream) {
  void (*kernel)(Params<Table>) = frontier_kernel<Table>;
  cudaError_t error;
  if (cluster != 1) {
    // whether a cluster of this size fits, asked once a size
    static int fits[kMaxCluster + 1] = {-1, -1, -1, -1, -1, -1, -1, -1, -1,
                                        -1, -1, -1, -1, -1, -1, -1, -1};
    if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
    if (fits[cluster] < 0) {
      error = max_active_clusters((const void*)kernel, cluster,
                                  &fits[cluster]);
      if (error != cudaSuccess) return error;
    }
    if (fits[cluster] < 1) return cudaErrorLaunchOutOfResources;
  }
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(num_frontiers * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = staged_bytes(p);
  config.stream = (cudaStream_t)stream;
  config.attrs = attribute;
  config.numAttrs = cluster > 1 ? 1 : 0;
  error = cudaLaunchKernelEx(&config, kernel, p);
  if (error != cudaSuccess) return error;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// clusters of `cluster` blocks the card holds at once, of the instance
// over the index (sharded = 0) or over the shard tables (sharded = 1);
// 0 when none fits (written to an int on the host)
int floxer_frontier_max_clusters(int sharded, int cluster, void* out) {
  void (*index_kernel)(Params<FmRankTable>) = frontier_kernel<FmRankTable>;
  void (*sharded_kernel)(Params<FmShardedRankTable>) =
      frontier_kernel<FmShardedRankTable>;
  return (int)max_active_clusters(
      sharded ? (const void*)sharded_kernel : (const void*)index_kernel,
      cluster, static_cast<int*>(out));
}

// rows: the combined rank table, or null for the per-direction planes
// layout (fwd_occ, fwd_planes, rev_occ, rev_planes); F frontiers of
// num_seeds seeds each, one cluster of `cluster` blocks each
int floxer_frontier_search(
    const void* rows, const void* fwd_occ, const void* fwd_planes,
    const void* rev_occ, const void* rev_planes, int rev_block_offset,
    const void* C, int n, const void* patterns, const void* seed_class,
    int num_frontiers, int num_seeds, int pad_len, const void* scheme,
    int num_searches, int num_parts, int capacity, int report_capacity,
    int max_iterations, void* frontier, void* reports, void* stats,
    int cluster, void* stream) {
  Params<FmRankTable> p;
  p.fwd.rows = static_cast<const uint32_t*>(rows);
  p.fwd.occ = static_cast<const int32_t*>(fwd_occ);
  p.fwd.planes = static_cast<const uint32_t*>(fwd_planes);
  p.fwd.row_offset = 0;
  p.rev.rows = static_cast<const uint32_t*>(rows);
  p.rev.occ = static_cast<const int32_t*>(rev_occ);
  p.rev.planes = static_cast<const uint32_t*>(rev_planes);
  p.rev.row_offset = rev_block_offset;
  fill_common(p, C, n, patterns, seed_class, num_seeds, pad_len, scheme,
              num_searches, num_parts, capacity, report_capacity,
              max_iterations, frontier, reports, stats);
  return (int)launch_frontiers(p, num_frontiers, cluster, stream);
}

// over the row-sharded index: rows [S, shard_rows, 32], each shard's
// combined table (the reverse direction from row rev_block_offset), the
// shards' starts, lengths and the totals before each ([S, 6]), both
// directions'; n the global length
int floxer_frontier_search_sharded(
    const void* rows, int shard_rows, int rev_block_offset,
    const void* fwd_starts, const void* fwd_lengths, const void* fwd_before,
    const void* rev_starts, const void* rev_lengths, const void* rev_before,
    int num_shards, const void* C, int n,
    const void* patterns, const void* seed_class, int num_frontiers,
    int num_seeds, int pad_len, const void* scheme, int num_searches,
    int num_parts, int capacity, int report_capacity, int max_iterations,
    void* frontier, void* reports, void* stats, int cluster, void* stream) {
  Params<FmShardedRankTable> p;
  p.fwd.rows = static_cast<const uint32_t*>(rows);
  p.fwd.shard_rows = shard_rows;
  p.fwd.row_offset = 0;
  p.fwd.starts = static_cast<const int*>(fwd_starts);
  p.fwd.lengths = static_cast<const int*>(fwd_lengths);
  p.fwd.before = static_cast<const int*>(fwd_before);
  p.fwd.num_shards = num_shards;
  p.rev = p.fwd;
  p.rev.row_offset = rev_block_offset;
  p.rev.starts = static_cast<const int*>(rev_starts);
  p.rev.lengths = static_cast<const int*>(rev_lengths);
  p.rev.before = static_cast<const int*>(rev_before);
  fill_common(p, C, n, patterns, seed_class, num_seeds, pad_len, scheme,
              num_searches, num_parts, capacity, report_capacity,
              max_iterations, frontier, reports, stats);
  return (int)launch_frontiers(p, num_frontiers, cluster, stream);
}

}  // extern "C"
