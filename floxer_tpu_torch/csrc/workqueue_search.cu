// K10: the work-queue seed search of --device-search, one thread per
// (seed, search) root.
//
// Replaces floxer_tpu/search_queue.py's _workqueue_search (:90-511), the
// reference's windowed LIFO work queue, whose window loop answered a TPU's
// per-launch gather latency. On the card each thread takes a root from a
// shared counter and runs the host's depth-first scheme search
// (search_host._run_scheme_search) on it with an explicit stack, in the
// host's edge order: match, substitutions by symbol, insertions by
// symbol, deletion. Every expansion writes its kind (1..12) as a nibble at
// the parent's depth into the path key, so the host sorts the reports
// into DFS order (search_queue.sort_reports); a boundary advance writes
// none.
//
// State: the current node in registers; the path key in shared memory
// (MAX_KEY_WORDS words a thread, word w at keys[w * THREADS]; a local
// array indexed by depth would be a stack frame); a frame a branching
// node on a stack in global scratch, thread-minor so a warp's frames at
// one depth are adjacent. The scratch, not local memory, because the
// stack's depth is set at launch (pad_len + max_errors + 2 frames) and a
// local array needs it at compile time. A frame holds the node's state,
// the mask of the kinds still to take, and its six (C[s] + lo[s],
// count[s]) pairs, 20 ints: a backtrack then costs one frame read and no
// rank, where recomputing would add two dependent rank-row gathers to
// every resumed node. A node with one valid child pushes no frame, and
// the match child (the first kind) is always taken at expansion, so
// frames never need the pattern. Reports are appended at an atomicAdd
// offset; nodes are added once a thread, the largest tree once a root.
// The search has no stack capacity to overflow; it flags overflow when
// the reports pass their capacity, a path reaches the key's 8 x KW
// nibbles, or the frames their count (none of which a complete search
// of these seeds reaches).
//
// What bounds it on an H100: operations, the larger of (a) ~250 int32
// ops an expanded node (two ranks of 6 symbols x 4 masked popcounts, the
// 13 kinds' tests, the children's intervals, a branching node's frame;
// chip_smoke.py's SEARCH_OPS_PER_NODE) times the nodes these seeds need,
// over 3.345e13 int32 ops/s, and (b) the bytes of the rank table, the
// patterns and the scheme rows read once and the reports written once,
// over 3.35 TB/s. Its rank-row gathers are latency-bound and dependent
// along a path: occupancy hides them (every SM full of threads, each on
// its own root), not prefetch. Its known risk is the tail: one root with
// a huge tree (a repetitive seed) runs alone at the end.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxKeyWords = 16;
constexpr int kFrameInts = 20;
constexpr int kKindDelete = 12;

enum { kOpM = 0, kOpI = 1, kOpD = 2 };
// fused scheme row: direction, start, end, lower, upper, then the next
// part's direction, start, end
enum { kDir, kStart, kEnd, kLower, kUpper, kNextDir, kNextStart, kNextEnd };
// frame fields (primary[6] and count[6] follow kMask)
enum { kLb, kLbRev, kLen, kPos, kErr, kPart, kDepth, kMask, kPrimary };
constexpr int kCount = kPrimary + FM_SIGMA;
// counters
enum { cReports, cOverflow, cNextRoot, cNodes, cLargest };

struct Params {
  FmRankTable fwd, rev;
  const int* C;
  int n;
  const int* patterns;  // [S, L]
  int num_seeds, pad_len;
  const int* seed_class;
  const int* scheme;  // [classes * searches * parts, 8]
  int num_searches, num_parts, key_words, report_capacity;
  int* reports;  // [report_capacity, 6 + key_words]
  unsigned long long* counters;
  int* scratch;  // [frame_capacity * kFrameInts, grid threads]
  int frame_capacity;
};

struct Node {
  int lb, lb_rev, len, pos, err, op, part, depth;
};

__device__ inline int pick(const int (&a)[FM_SIGMA], int s) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < FM_SIGMA; ++i) v = i == s ? a[i] : v;
  return v;
}

__device__ inline int prefix_below(const int (&a)[FM_SIGMA], int s) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < FM_SIGMA; ++i) v += i < s ? a[i] : 0;
  return v;
}

__device__ inline void flag_overflow(const Params& p) {
  atomicExch(p.counters + cOverflow, 1ull);
}

// the child of `node` by `kind` (1..12); false when its depth would reach
// the key's 8 * key_words nibbles (an overflow)
__device__ inline bool descend(const Params& p, Node& node, int kind,
                               int dir, int match_symbol,
                               const int (&primary)[FM_SIGMA],
                               const int (&count)[FM_SIGMA], uint32_t* keys) {
  if (node.depth + 1 >= 8 * p.key_words) {
    flag_overflow(p);
    return false;
  }
  const int word = node.depth >> 3;
  const int shift = 4 * (7 - (node.depth & 7));
  uint32_t key = keys[word * kThreads];
  keys[word * kThreads] = (key & ~(0xFu << shift)) | ((uint32_t)kind << shift);
  node.depth += 1;
  if (kind == kKindDelete) {
    node.pos += dir;
    node.err += 1;
    node.op = kOpD;
    return true;
  }
  int s;
  if (kind == 1) {
    s = match_symbol;
    node.pos += dir;
    node.op = kOpM;
  } else if (kind <= 6) {
    s = kind - 1;
    node.pos += dir;
    node.err += 1;
    node.op = kOpM;
  } else {
    s = kind - 6;
    node.err += 1;
    node.op = kOpI;
  }
  const bool left = dir < 0;
  const int primary_s = pick(primary, s);
  const int secondary = (left ? node.lb_rev : node.lb) + prefix_below(count, s);
  node.lb = left ? primary_s : secondary;
  node.lb_rev = left ? secondary : primary_s;
  node.len = pick(count, s);
  return true;
}

__device__ inline void report(const Params& p, const Node& node, int seed,
                              int search, const uint32_t* keys) {
  const unsigned long long at = atomicAdd(p.counters + cReports, 1ull);
  if (at >= (unsigned long long)p.report_capacity) {
    flag_overflow(p);
    return;
  }
  int* row = p.reports + at * (6 + p.key_words);
  row[0] = node.lb;
  row[1] = node.lb_rev;
  row[2] = node.len;
  row[3] = node.err;
  row[4] = seed;
  row[5] = search;
  for (int w = 0; w < p.key_words; ++w) {
    // the nibbles of depths below the node's: stale deeper ones are masked
    const int kept = node.depth - 8 * w;
    const uint32_t mask =
        kept >= 8 ? 0xFFFFFFFFu : (kept <= 0 ? 0u : ~0u << (32 - 4 * kept));
    row[6 + w] = (int)(keys[w * kThreads] & mask);
  }
}

__global__ void __launch_bounds__(kThreads)
workqueue_kernel(Params p) {
  __shared__ uint32_t key_words[kMaxKeyWords * kThreads];
  uint32_t* keys = key_words + threadIdx.x;
  const int grid_threads = gridDim.x * blockDim.x;
  int* frames = p.scratch + blockIdx.x * blockDim.x + threadIdx.x;
  const int num_roots = p.num_seeds * p.num_searches;
  const int parts = p.num_parts;

  unsigned long long nodes = 0;
  long long tree = 0;
  int root = -1, seed = 0, search = 0, cls = 0, top = 0;
  bool live = false;
  Node node{};

  while (true) {
    if (root < 0) {
      root = (int)atomicAdd(p.counters + cNextRoot, 1ull);
      if (root >= num_roots) break;
      seed = root / p.num_searches;
      search = root - seed * p.num_searches;
      cls = p.seed_class[seed];
      const int* row0 = p.scheme + (size_t)(cls * p.num_searches + search) * parts * 8;
      const int dir0 = row0[kDir];
      node.lb = 0;
      node.lb_rev = 0;
      node.len = p.n;
      node.pos = row0[kStart] * (dir0 > 0) + (row0[kEnd] - 1) * (dir0 < 0);
      node.err = 0;
      node.op = kOpM;
      node.part = 0;
      node.depth = 0;
      top = 0;
      tree = 0;
      live = true;
    }
    if (live) {
      const int* row =
          p.scheme + ((size_t)(cls * p.num_searches + search) * parts + node.part) * 8;
      const int dir = row[kDir];
      const bool boundary = dir > 0 ? node.pos >= row[kEnd] : node.pos < row[kStart];
      if (boundary) {
        if (node.err < row[kLower]) {
          live = false;
        } else if (node.part == parts - 1) {
          report(p, node, seed, search, keys);
          live = false;
        } else {
          node.pos = row[kNextDir] > 0 ? row[kNextStart] : row[kNextEnd] - 1;
          node.part += 1;
          continue;
        }
      } else {
        // expand: two ranks on the direction of the part
        ++nodes;
        ++tree;
        const bool left = dir < 0;
        const int base = left ? node.lb : node.lb_rev;
        int lo[FM_SIGMA], hi[FM_SIGMA], primary[FM_SIGMA], count[FM_SIGMA];
        fm_rank(left ? p.fwd : p.rev, base, lo);
        fm_rank(left ? p.fwd : p.rev, base + node.len, hi);
#pragma unroll
        for (int s = 0; s < FM_SIGMA; ++s) {
          count[s] = hi[s] - lo[s];
          primary[s] = __ldg(p.C + s) + lo[s];
        }
        int pos = node.pos < 0 ? 0 : node.pos;
        pos = pos < p.pad_len - 1 ? pos : p.pad_len - 1;
        const int symbol = p.patterns[(size_t)seed * p.pad_len + pos];
        const int match_symbol = symbol >= 1 && symbol < FM_SIGMA ? symbol : 0;
        uint32_t mask = pick(count, match_symbol) > 0 ? 1u << 1 : 0u;
        if (node.err < row[kUpper]) {
#pragma unroll
          for (int s = 1; s < FM_SIGMA; ++s) {
            if (symbol != s && count[s] > 0) mask |= 1u << (1 + s);
            if (node.op != kOpD && count[s] > 0) mask |= 1u << (6 + s);
          }
          if (node.op != kOpI) mask |= 1u << kKindDelete;
        }
        if (mask == 0) {
          live = false;
        } else {
          const int kind = __ffs(mask) - 1;
          mask &= mask - 1;
          if (mask != 0) {
            if (top >= p.frame_capacity) {
              flag_overflow(p);
            } else {
              int* f = frames + (size_t)top * kFrameInts * grid_threads;
              f[kLb * grid_threads] = node.lb;
              f[kLbRev * grid_threads] = node.lb_rev;
              f[kLen * grid_threads] = node.len;
              f[kPos * grid_threads] = node.pos;
              f[kErr * grid_threads] = node.err;
              f[kPart * grid_threads] = node.part;
              f[kDepth * grid_threads] = node.depth;
              f[kMask * grid_threads] = (int)mask;
#pragma unroll
              for (int s = 0; s < FM_SIGMA; ++s) {
                f[(kPrimary + s) * grid_threads] = primary[s];
                f[(kCount + s) * grid_threads] = count[s];
              }
              ++top;
            }
          }
          live = descend(p, node, kind, dir, match_symbol, primary, count, keys);
        }
        continue;
      }
    }
    // the current node is done: resume the deepest frame with kinds left
    if (top == 0) {
      atomicMax(p.counters + cLargest, (unsigned long long)tree);
      root = -1;
      continue;
    }
    int* f = frames + (size_t)(top - 1) * kFrameInts * grid_threads;
    uint32_t mask = (uint32_t)f[kMask * grid_threads];
    const int kind = __ffs(mask) - 1;
    mask &= mask - 1;
    if (mask != 0) {
      f[kMask * grid_threads] = (int)mask;
    } else {
      --top;
    }
    node.lb = f[kLb * grid_threads];
    node.lb_rev = f[kLbRev * grid_threads];
    node.len = f[kLen * grid_threads];
    node.pos = f[kPos * grid_threads];
    node.err = f[kErr * grid_threads];
    node.part = f[kPart * grid_threads];
    node.depth = f[kDepth * grid_threads];
    int primary[FM_SIGMA], count[FM_SIGMA];
#pragma unroll
    for (int s = 0; s < FM_SIGMA; ++s) {
      primary[s] = f[(kPrimary + s) * grid_threads];
      count[s] = f[(kCount + s) * grid_threads];
    }
    const int* row =
        p.scheme + ((size_t)(cls * p.num_searches + search) * parts + node.part) * 8;
    // kinds 2..12 only (the match was taken at expansion), which need no
    // pattern symbol
    live = descend(p, node, kind, row[kDir], 0, primary, count, keys);
  }
  atomicAdd(p.counters + cNodes, nodes);
}

}  // namespace

extern "C" {

// blocks of the kernel one SM holds at once
int floxer_workqueue_occupancy(void* blocks_out) {
  int blocks = 0;
  cudaError_t error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, workqueue_kernel, kThreads, 0);
  *static_cast<int*>(blocks_out) = blocks;
  return (int)error;
}

// rows: the combined rank table, or null for the per-direction planes
// layout (fwd_occ, fwd_planes, rev_occ, rev_planes); counters: int64 [8],
// zeroed by the caller
int floxer_workqueue_search(
    const void* rows, const void* fwd_occ, const void* fwd_planes,
    const void* rev_occ, const void* rev_planes, int rev_block_offset,
    const void* C, int n, const void* patterns, int num_seeds, int pad_len,
    const void* seed_class, const void* scheme, int num_searches,
    int num_parts, int key_words, int report_capacity, void* reports,
    void* counters, void* scratch, int frame_capacity, int blocks,
    void* stream) {
  Params p;
  p.fwd.rows = static_cast<const uint32_t*>(rows);
  p.fwd.occ = static_cast<const int32_t*>(fwd_occ);
  p.fwd.planes = static_cast<const uint32_t*>(fwd_planes);
  p.fwd.row_offset = 0;
  p.rev.rows = static_cast<const uint32_t*>(rows);
  p.rev.occ = static_cast<const int32_t*>(rev_occ);
  p.rev.planes = static_cast<const uint32_t*>(rev_planes);
  p.rev.row_offset = rev_block_offset;
  p.C = static_cast<const int*>(C);
  p.n = n;
  p.patterns = static_cast<const int*>(patterns);
  p.num_seeds = num_seeds;
  p.pad_len = pad_len;
  p.seed_class = static_cast<const int*>(seed_class);
  p.scheme = static_cast<const int*>(scheme);
  p.num_searches = num_searches;
  p.num_parts = num_parts;
  p.key_words = key_words;
  p.report_capacity = report_capacity;
  p.reports = static_cast<int*>(reports);
  p.counters = static_cast<unsigned long long*>(counters);
  p.scratch = static_cast<int*>(scratch);
  p.frame_capacity = frame_capacity;
  workqueue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
