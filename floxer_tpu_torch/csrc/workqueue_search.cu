// K10: the work-queue seed search of --device-search: a thread a (seed,
// search) root, at most a budget of nodes at a time, the rest of a large
// tree spilled to a work list that every idle thread takes from.
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
// node on a stack in global scratch, each thread's frames contiguous and
// a frame 80 bytes written and read as five 16-byte vectors (3 sectors).
// The scratch, not local memory, because the stack's depth is set at
// launch (pad_len + max_errors + 2 frames) and a local array needs it at
// compile time. A frame holds the node's state,
// the mask of the kinds still to take, and its six (C[s] + lo[s],
// count[s]) pairs, 20 ints: a backtrack then costs one frame read and no
// rank, where recomputing would add two dependent rank-row gathers to
// every resumed node. A node with one valid child pushes no frame, and
// the match child (the first kind) is always taken at expansion, so
// frames never need the pattern.
//
// The tail: one thread walking a root's whole tree alone would set the
// launch's time (pass A's largest tree is 1645 nodes against a mean of
// 38). So a unit of work, a root or a spilled entry, expands at most
// `budget` nodes; the node that reaches it joins the stack as a frame
// with all its kinds, and the whole stack is spilled to the work list,
// bottom frame first (the bottom frames hold the largest subtrees). An
// entry is a frame, its (seed, search) and the path key's words up to
// the frame's depth (kEntryInts ints); the thread that takes it restores
// the key prefix into its shared-memory words and resumes the frame, so
// every report carries the key of the single-thread DFS and the sorted
// rows do not depend on the budget. The search runs in generations, one
// launch each (ops/cuda_search_queue.py enqueues them a few at a time,
// with no synchronization between them): the first takes the roots from
// a counter, each later one the entries the one before it spilled (their
// count read from the card), from a counter over its input list, and
// spills to the other list; the kernel boundary orders an entry's writes
// before its reads, so no thread ever waits on another. A thread leaves
// when its counter runs out; a generation with no input, or after an
// overflow, ends at once. An output list past its capacity drops the entries
// and flags overflow; the runner then retries at 4x. Reports are
// appended at an atomicAdd offset; nodes are added once a thread a
// launch; each unit adds its nodes to its root's count, and the largest
// tree is the largest root count any unit leaves. Overflow is flagged
// when the reports pass their capacity, a path reaches the key's 8 x KW
// nibbles, the frames their count or a list its capacity.
//
// What bounds it on an H100: operations, the larger of (a) ~250 int32
// ops an expanded node (two ranks of 6 symbols x 4 masked popcounts, the
// 13 kinds' tests, the children's intervals, a branching node's frame;
// chip_smoke.py's SEARCH_OPS_PER_NODE) times the nodes these seeds need,
// over 3.345e13 int32 ops/s, and (b) the bytes of the rank table, the
// patterns and the scheme rows read once and the reports written once,
// over 3.35 TB/s. Its rank-row gathers are latency-bound and dependent
// along a path: occupancy hides them (every SM full of threads, each on
// its own root or entry), not prefetch. A node's two ranks (at both ends
// of its interval) read one row when the interval lies in one block, as
// it does deep in a tree (fm_rank.cuh's fm_interval_rank).

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxKeyWords = 16;
constexpr int kFrameInts = 20;
// a spilled entry: a frame, its seed and search, the path key's words,
// two ints of padding (entries 16-byte aligned)
constexpr int kEntryInts = kFrameInts + 2 + kMaxKeyWords + 2;
constexpr int kKindDelete = 12;

enum { kOpM = 0, kOpI = 1, kOpD = 2 };
// fused scheme row: direction, start, end, lower, upper, then the next
// part's direction, start, end
enum { kDir, kStart, kEnd, kLower, kUpper, kNextDir, kNextStart, kNextEnd };
// frame fields (primary[6] and count[6] follow kMask); kMask holds the
// kinds still to take (bits 1..12) and the match's symbol above them
enum { kLb, kLbRev, kLen, kPos, kErr, kPart, kDepth, kMask, kPrimary };
constexpr uint32_t kKindsMask = 0x1FFEu;
constexpr int kSymbolShift = 16;
constexpr int kCount = kPrimary + FM_SIGMA;
// entry fields after its frame's
enum { kSeed = kFrameInts, kSearch, kKey };
// counters (int64): reports appended, the overflow flag, the next root,
// nodes expanded, the largest tree, entries spilled in all generations,
// the most one generation spilled
enum { cReports, cOverflow, cNextRoot, cNodes, cLargest, cSpilled,
       cListPeak, kCounters };
// a generation's own counters (int64, zeroed by the caller before it):
// its next input entry, its output entries
enum { gNextEntry, gOutEntries, kGenerationCounters };

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
  int* scratch;  // [grid threads, frame_capacity, kFrameInts]
  int frame_capacity;
  int budget;         // nodes a unit expands before it spills
  const int* in_list;  // [*in_entries, kEntryInts], the last launch's
  const unsigned long long* in_entries;  // null in the first generation
  unsigned long long* generation;        // [kGenerationCounters]
  int* out_list;       // [list_capacity, kEntryInts]
  long long list_capacity;
  int* root_nodes;    // [roots], zeroed by the caller
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

// a frame's five 16-byte vectors
__device__ inline void copy_frame(int* to, const int* from) {
#pragma unroll
  for (int v = 0; v < kFrameInts / 4; ++v) {
    reinterpret_cast<int4*>(to)[v] = reinterpret_cast<const int4*>(from)[v];
  }
}

// the thread's stack, bottom frame first, to this launch's output list at
// an atomicAdd offset; entries past the capacity are dropped and flag
// overflow
__device__ inline void spill(const Params& p, const int* frames, int top,
                             int seed, int search, const uint32_t* keys) {
  atomicAdd(p.counters + cSpilled, (unsigned long long)top);
  const unsigned long long first =
      atomicAdd(p.generation + gOutEntries, (unsigned long long)top);
  atomicMax(p.counters + cListPeak, first + top);
  for (int i = 0; i < top; ++i) {
    const unsigned long long slot = first + i;
    if (slot >= (unsigned long long)p.list_capacity) {
      flag_overflow(p);
      break;
    }
    int* entry = p.out_list + slot * kEntryInts;
    const int* f = frames + i * kFrameInts;
    copy_frame(entry, f);
    entry[kSeed] = seed;
    entry[kSearch] = search;
    const int words = (f[kDepth] + 7) >> 3;
    for (int w = 0; w < words; ++w) entry[kKey + w] = (int)keys[w * kThreads];
  }
}

__global__ void __launch_bounds__(kThreads)
workqueue_kernel(Params p) {
  __shared__ uint32_t key_words[kMaxKeyWords * kThreads];
  uint32_t* keys = key_words + threadIdx.x;
  int* frames = p.scratch + (size_t)(blockIdx.x * blockDim.x + threadIdx.x) *
                                p.frame_capacity * kFrameInts;
  const int num_roots = p.num_seeds * p.num_searches;
  const int parts = p.num_parts;
  // an earlier generation overflowed: the search's result is flagged
  // already and this generation's work would not be read
  if (p.counters[cOverflow] != 0) return;
  const unsigned long long in_entries =
      p.in_entries == nullptr ? 0ull : *p.in_entries;

  unsigned long long nodes = 0;
  int unit_nodes = 0;  // nodes this unit expanded
  int root = -1;       // the unit's root, -1 between units
  int seed = 0, search = 0, cls = 0, top = 0;
  bool live = false, roots_left = true;
  Node node{};

  while (true) {
    if (root < 0) {
      // a new unit: a root while any is left (the first launch), then
      // the input list's entries (the later ones)
      if (roots_left) {
        const int next = (int)atomicAdd(p.counters + cNextRoot, 1ull);
        if (next < num_roots) {
          root = next;
          seed = root / p.num_searches;
          search = root - seed * p.num_searches;
          cls = p.seed_class[seed];
          const int* row0 =
              p.scheme + (size_t)(cls * p.num_searches + search) * parts * 8;
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
          live = true;
        } else {
          roots_left = false;
        }
      }
      if (root < 0) {
        const unsigned long long taken =
            atomicAdd(p.generation + gNextEntry, 1ull);
        if (taken >= in_entries) break;
        // the entry becomes frame 0 of the stack, its key prefix the key's
        const int* entry = p.in_list + taken * kEntryInts;
        seed = entry[kSeed];
        search = entry[kSearch];
        root = seed * p.num_searches + search;
        cls = p.seed_class[seed];
        copy_frame(frames, entry);
        const int words = (entry[kDepth] + 7) >> 3;
        for (int w = 0; w < words; ++w) keys[w * kThreads] = entry[kKey + w];
        top = 1;
        live = false;
      }
      unit_nodes = 0;
    }
    if (!live) {
      // the current node is done: resume the deepest frame with kinds
      // left, and take the child in this same pass (a lane that resumes
      // then expands with the lanes that expand)
      if (top == 0) {
        const int before = atomicAdd(p.root_nodes + root, unit_nodes);
        atomicMax(p.counters + cLargest,
                  (unsigned long long)(before + unit_nodes));
        root = -1;
        continue;
      }
      int* f = frames + (top - 1) * kFrameInts;
      const int4* v = reinterpret_cast<const int4*>(f);
      const int4 v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3], v4 = v[4];
      const uint32_t word = (uint32_t)v1.w;
      const int match_symbol = (int)(word >> kSymbolShift);
      uint32_t mask = word & kKindsMask;
      const int kind = __ffs(mask) - 1;
      mask &= mask - 1;
      if (mask != 0) {
        f[kMask] = (int)(mask | (word & ~kKindsMask));
      } else {
        --top;
      }
      node.lb = v0.x;
      node.lb_rev = v0.y;
      node.len = v0.z;
      node.pos = v0.w;
      node.err = v1.x;
      node.part = v1.y;
      node.depth = v1.z;
      const int primary[FM_SIGMA] = {v2.x, v2.y, v2.z, v2.w, v3.x, v3.y};
      const int count[FM_SIGMA] = {v3.z, v3.w, v4.x, v4.y, v4.z, v4.w};
      const int* row =
          p.scheme + ((size_t)(cls * p.num_searches + search) * parts + node.part) * 8;
      // kind 1 (the match) only from a spilled node's frame; the frame
      // keeps the match's symbol, so the pattern need not be read
      live = descend(p, node, kind, row[kDir], match_symbol, primary, count,
                     keys);
      if (!live) continue;
    }
    {  // the live node: a boundary, or an expansion
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
        // expand: the interval rank on the direction of the part (one row
        // when the interval lies in one block)
        ++nodes;
        ++unit_nodes;
        const bool left = dir < 0;
        const int base = left ? node.lb : node.lb_rev;
        int lo[FM_SIGMA], primary[FM_SIGMA], count[FM_SIGMA];
        fm_interval_rank(left ? p.fwd : p.rev, base, node.len, lo, count);
#pragma unroll
        for (int s = 0; s < FM_SIGMA; ++s) {
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
        // the unit's budget spent: the node joins the stack with all its
        // kinds, kind 1 (the match) included, and the stack spills
        const bool spend = unit_nodes >= p.budget;
        if (mask == 0) {
          live = false;
        } else {
          const int kind = __ffs(mask) - 1;
          if (!spend) mask &= mask - 1;
          if (mask != 0) {
            if (top >= p.frame_capacity) {
              flag_overflow(p);
            } else {
              int4* f = reinterpret_cast<int4*>(frames + top * kFrameInts);
              f[0] = make_int4(node.lb, node.lb_rev, node.len, node.pos);
              f[1] = make_int4(
                  node.err, node.part, node.depth,
                  (int)(mask | ((uint32_t)match_symbol << kSymbolShift)));
              f[2] = make_int4(primary[0], primary[1], primary[2],
                               primary[3]);
              f[3] = make_int4(primary[4], primary[5], count[0], count[1]);
              f[4] = make_int4(count[2], count[3], count[4], count[5]);
              ++top;
            }
          }
          if (spend) {
            live = false;
          } else {
            live = descend(p, node, kind, dir, match_symbol, primary, count,
                           keys);
          }
        }
        if (!spend) continue;
        if (top > 0) spill(p, frames, top, seed, search, keys);
        top = 0;
      }
    }
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

// one generation: rows, the combined rank table, or null for the
// per-direction planes layout (fwd_occ, fwd_planes, rev_occ, rev_planes);
// counters int64 [kCounters] and the roots' node counts [num_seeds *
// num_searches] zeroed by the caller before the first generation, the
// generation's counters int64 [kGenerationCounters] before it; the first
// generation with in_entries null, each later one with the output count
// of the one before
int floxer_workqueue_search(
    const void* rows, const void* fwd_occ, const void* fwd_planes,
    const void* rev_occ, const void* rev_planes, int rev_block_offset,
    const void* C, int n, const void* patterns, int num_seeds, int pad_len,
    const void* seed_class, const void* scheme, int num_searches,
    int num_parts, int key_words, int report_capacity, void* reports,
    void* counters, void* scratch, int frame_capacity, int budget,
    const void* in_list, const void* in_entries, void* generation,
    void* out_list, long long list_capacity, void* root_nodes,
    int blocks, void* stream) {
  if (budget < 1) return (int)cudaErrorInvalidValue;
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
  p.budget = budget;
  p.in_list = static_cast<const int*>(in_list);
  p.in_entries = static_cast<const unsigned long long*>(in_entries);
  p.generation = static_cast<unsigned long long*>(generation);
  p.out_list = static_cast<int*>(out_list);
  p.list_capacity = list_capacity;
  p.root_nodes = static_cast<int*>(root_nodes);
  workqueue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
