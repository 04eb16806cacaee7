// Banded CIGAR traceback for accepted PEX roots (K4), one launch per batch.
//
// Replaces the XLA program
// floxer_tpu/ops/traceback_device.py::_banded_directions_and_walk: per
// task, the semi-global DP restricted to the band of W = 2 half + 1 cells
// around the optimal path's diagonal (cell d of row i is column
// i + end_col - m - half + d, half = max(distance, 0)), a 2-bit direction
// code per cell (the move the host walk takes there, ties I, then
// diagonal, then D), and the walk back from (m, half) over those codes.
// The arithmetic is the reference's int32 arithmetic: BIG in invalid
// cells, BIG + 1 for the vertical predecessor past the band's right edge,
// diagonal only for columns >= 1, the valid mask
// 0 <= col <= n && d < 2 half + 1. Every code on a cell of finite value
// equals the reference's, so the walk from (m, half), which never leaves
// such cells when (end_col, distance) is the DP's own, does too.
//
// What bounds it on an H100: the rows are a serial chain (m ~ 20.6k at the
// 20 kb root shape), each a min-plus prefix scan over the band
// (dp = min(best, cummin(best - d) + d)); the codes leave as 2 bits per
// cell. So a row's latency, not the card's rates, sets the time, and the
// design cuts the work and the synchronisation on that chain:
//
// - Ragged tasks in one launch: a table row per task (offsets of its
//   window, pattern, codes and ops; its own m, n, end_col, distance and
//   layout), one block per task, so a batch of 128 roots occupies 128 SMs
//   at once. Each block runs its own task's layout: a batch that mixes
//   widths pads no task to another's.
// - The band row in registers: each lane owns C contiguous cells (C = 8
//   up to 4096 band cells, 16 up to 8192, 32 up to 16384; a task takes
//   ceil(W / 32C) warps of the block, at most 16, the others exit), their
//   dp values and their window chars. The chars slide: cell d of row i + 1
//   reads the char cell d + 1 read in row i, so a lane takes one new char
//   a row, by shuffle from its right neighbour (lane 31 loads it). At 8
//   cells a lane the chars are a register each and the candidates are
//   kept between the passes; at 16 and 32 the chars are packed four to a
//   register and pass 2 recomputes the candidates, so a thread stays
//   within the 128 registers a 512-thread block leaves it.
// - The prefix min: a lane's minimum of (best - d), a warp scan on
//   shuffles, and one published total per warp, read after the row's one
//   barrier (a lane reads the earlier warps' totals as broadcasts); the
//   exchange slots are double-buffered by row parity (as in
//   csrc/myers_banded_wide.cu), so no second barrier is needed. The
//   vertical predecessor of a warp's last cell is the next warp's first
//   cell of the previous row: that warp also publishes its first cell's
//   candidate, and lane 31 finishes the value itself from its own prefix,
//   min(candidate, prefix + d).
// - Rows where every cell of a warp is valid (most rows of a long root)
//   take a step without masks, where dp is the running prefix + d.
// - Codes packed in a register and stored as one 16-bit (8 cells) or
//   32-bit word per lane and 16 cells.
// - Bands past 16384 cells (up to 57856) hold more cells than the
//   registers: 64, 96 or 128 a lane, whose dp values live in shared
//   memory, cell k of thread t at k * owners + t (owners = the threads
//   that hold band cells), so a warp's accesses fall in 32 banks. A lane
//   runs its cells 16 at a time (values and chars in registers for the
//   chunk, the loop over chunks not unrolled, so it stays within the
//   registers); a chunk's 16 chars come as five aligned 32-bit loads,
//   funnel-shifted into place.
// - The walk by warp 0 from shared memory: it stages the codes of the 32
//   rows above the current cell, 32 words (512 cells) around it, in one
//   coalesced load a row, and walks in the tile until the path leaves it.
//   It writes the ops from the end of the task's slots backwards, so they
//   read forward and the host run-length encodes the whole batch at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 20;
constexpr int kInf = 0x3fffffff;  // above every (best - d) a cell can hold
constexpr int kDirI = 0, kDirEq = 1, kDirX = 2, kDirD = 3;
constexpr int kTileRows = 32;     // rows of codes the walk stages at once
constexpr int kTileWords = 32;    // words (of 16 codes) a staged row holds
constexpr int kExchangeInts = 128;
constexpr int kMaxThreads = 512;
constexpr int kTableCols = 10;

// the task table's columns (int64)
enum {
  kWinOff, kNLen, kPatOff, kMLen, kEndCol, kDistance, kDirsOff, kOpsOff,
  kCells, kSharedRow
};

struct Task {
  const uint8_t* win;
  const uint8_t* pat;
  uint32_t* dirs;
  int8_t* ops;
  int n, m, half, width, base, cells;
  bool shared_row;
};

__device__ __forceinline__ Task load_task(
    const int64_t* table, const uint8_t* windows, const uint8_t* patterns,
    uint32_t* dirs, int8_t* ops, int t) {
  const int64_t* row = table + static_cast<size_t>(t) * kTableCols;
  Task task;
  task.win = windows + row[kWinOff];
  task.pat = patterns + row[kPatOff];
  task.dirs = dirs + row[kDirsOff];
  task.ops = ops + row[kOpsOff];
  task.n = static_cast<int>(row[kNLen]);
  task.m = static_cast<int>(row[kMLen]);
  const int distance = static_cast<int>(row[kDistance]);
  task.half = distance > 0 ? distance : 0;
  task.width = 2 * task.half + 1;
  task.base = static_cast<int>(row[kEndCol]) - task.m - task.half;
  task.cells = static_cast<int>(row[kCells]);
  task.shared_row = row[kSharedRow] != 0;
  return task;
}

// the window char at position p (0 past either end)
__device__ __forceinline__ int char_at(const Task& task, int p) {
  return (p >= 0 && p < task.n) ? __ldg(task.win + p) : 0;
}

__device__ __forceinline__ bool valid_cell(const Task& task, int col, int d) {
  return col >= 0 && col <= task.n && d < task.width;
}

// lanes below `offset` get their own value from __shfl_up_sync, and
// min(v, v) = v, so the scan needs no lane test
__device__ __forceinline__ int warp_inclusive_min(int v) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    v = min(v, __shfl_up_sync(kFull, v, offset));
  }
  return v;
}

__device__ __forceinline__ void block_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// One cell's candidates: the diagonal (BIG at column 0 and left of it)
// and the vertical predecessor (+1).
__device__ __forceinline__ void candidates(int prev_d, int prev_right, int ch,
                                           int pc, int col, int& diag,
                                           int& up) {
  diag = col >= 1 ? prev_d + (ch != pc) : kBig;
  up = prev_right + 1;
}

__device__ __forceinline__ int direction(int dp, int diag, int up, bool sub) {
  return dp == up ? kDirI : dp == diag ? (sub ? kDirX : kDirEq) : kDirD;
}

// The exchange of one row, after pass 1 of every warp: publishes this
// warp's scan total and its first cell's candidate (or -1 when that cell
// is invalid), passes the row's barrier and returns the prefix min of
// (best - d) over the cells left of this lane's; `next_head` is the next
// warp's published candidate (-1 when there is none). Lane w reads warp
// w's total and one warp reduction (REDUX) takes the earlier warps' min.
__device__ __forceinline__ int exchange(int local, bool head_valid,
                                        int head_best, int* xmin, int* xhead,
                                        int parity, int warp, int warps,
                                        int lane, int threads,
                                        int& next_head) {
  const int inclusive = warp_inclusive_min(local);
  int exclusive = __shfl_up_sync(kFull, inclusive, 1);
  if (lane == 0) exclusive = kInf;
  int* slot_min = xmin + parity * 32;
  int* slot_head = xhead + parity * 32;
  if (lane == 31) slot_min[warp] = inclusive;
  if (lane == 0) slot_head[warp] = head_valid ? head_best : -1;
  block_barrier(threads);
  const int earlier =
      __reduce_min_sync(kFull, lane < warp ? slot_min[lane] : kInf);
  next_head = warp + 1 < warps ? slot_head[warp + 1] : -1;
  return min(earlier, exclusive);
}

// The walk, by warp 0: from (m, half) back to row 0 over the codes, from
// tiles staged in shared memory. The ops fill the task's slots from the
// end, so they read forward (row 1 first) and end at the last slot; the
// slots before them get -1.
__device__ __forceinline__ void walk(const Task& task, int row_words,
                                     int lane, uint32_t* tile,
                                     int32_t* num_ops, int32_t* begin_cols,
                                     int t) {
  const int cap = task.m + task.width;
  int i = task.m, d = task.half, count = 0;
  int r_lo = 1, r_hi = 0, w_lo = 0;
  while (i > 0 && count < cap && d >= 0 && d < task.width) {
    const int r = i - 1;
    const int word = d >> 4;
    if (r < r_lo || r > r_hi || word < w_lo || word >= w_lo + kTileWords) {
      r_hi = r;
      r_lo = max(0, r - (kTileRows - 1));
      w_lo = min(max(word - kTileWords / 2, 0), max(row_words - kTileWords, 0));
      // every row's load issued before the first is stored, so one
      // memory round trip stages the tile
      const bool column = w_lo + lane < row_words;
      const uint32_t* src =
          task.dirs + static_cast<size_t>(r_lo) * row_words + w_lo + lane;
      uint32_t staged[kTileRows];
#pragma unroll
      for (int rr = 0; rr < kTileRows; ++rr) {
        staged[rr] = column && rr <= r_hi - r_lo
                         ? src[static_cast<size_t>(rr) * row_words]
                         : 0u;
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < kTileRows; ++rr) {
        tile[rr * kTileWords + lane] = staged[rr];
      }
      __syncwarp();
    }
    const int code =
        (tile[(r - r_lo) * kTileWords + word - w_lo] >> (2 * (d & 15))) & 3;
    if (lane == 0) task.ops[cap - 1 - count] = static_cast<int8_t>(code);
    ++count;
    if (code == kDirI) {
      --i;
      ++d;
    } else if (code == kDirD) {
      --d;
    } else {
      --i;
    }
  }
  for (int s = lane; s < cap - count; s += 32) task.ops[s] = -1;
  if (lane == 0) {
    num_ops[t] = count;
    begin_cols[t] = task.base + d;
  }
}

// ---- 8 cells a lane: chars a register each, candidates kept ------------

// Pass 1 of a lane's C cells: their candidates and the minimum of
// (best - d), BIG - d on an invalid cell. kAllValid: every cell valid and
// at column >= 1, so no masks.
template <int C, bool kAllValid>
__device__ __forceinline__ int pass1(const Task& task, const int (&prev)[C],
                                     int right, const int (&ch)[C], int pc,
                                     int col0, int d0, int (&diag)[C],
                                     int (&up)[C]) {
  int local = kInf;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int prev_right = k + 1 < C ? prev[k + 1] : right;
    if (kAllValid) {
      diag[k] = prev[k] + (ch[k] != pc);
      up[k] = prev_right + 1;
      local = min(local, min(diag[k], up[k]) - (d0 + k));
    } else {
      candidates(prev[k], prev_right, ch[k], pc, col0 + k, diag[k], up[k]);
      const int best = min(diag[k], up[k]);
      local = min(local, (valid_cell(task, col0 + k, d0 + k) ? best : kBig) -
                             (d0 + k));
    }
  }
  return local;
}

// Pass 2: the running prefix from `run` (the min of (best - d) left of
// the lane), each cell's dp and direction code; the dp values replace
// prev. On a valid cell the prefix is at most best - d, so
// dp = min(best, prefix + d) = prefix + d.
template <int C, bool kAllValid>
__device__ __forceinline__ uint32_t pass2(const Task& task, int& run,
                                          int (&prev)[C], const int (&diag)[C],
                                          const int (&up)[C],
                                          const int (&ch)[C], int pc,
                                          int col0, int d0) {
  uint32_t codes = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int best = min(diag[k], up[k]);
    int dp;
    if (kAllValid) {
      run = min(run, best - (d0 + k));
      dp = run + d0 + k;
    } else {
      const bool valid = valid_cell(task, col0 + k, d0 + k);
      run = min(run, (valid ? best : kBig) - (d0 + k));
      dp = valid ? min(best, run + d0 + k) : kBig;
    }
    codes |= static_cast<uint32_t>(direction(dp, diag[k], up[k], ch[k] != pc))
             << (2 * k);
    prev[k] = dp;
  }
  return codes;
}

__device__ __forceinline__ void rows_reg8(const Task& task, int* xmin,
                                          int* xhead, int tid, int warps,
                                          int row_words) {
  constexpr int C = 8;
  const int lane = tid & 31, warp = tid >> 5, threads = warps * 32;
  const int d0 = tid * C;
  int prev[C], ch[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    prev[k] = valid_cell(task, task.base + d0 + k, d0 + k) ? 0 : kBig;
    ch[k] = char_at(task, task.base + d0 + k);
  }
  // the previous row's value right of this lane's run
  int right = valid_cell(task, task.base + d0 + C, d0 + C) ? 0 : kBig;
  int pc = task.m > 0 ? __ldg(task.pat) : 0;

  for (int i = 1; i <= task.m; ++i) {
    const int pc_next = i < task.m ? __ldg(task.pat + i) : 0;
    // lane 31's new char for row i + 1 (its right neighbour's, this row)
    const int ch_load =
        lane == 31 ? char_at(task, i + task.base + d0 + C - 1) : 0;
    const int col0 = i + task.base + d0;
    // every cell of the warp valid and right of column 0: the row step
    // without masks (most rows of a long root)
    const bool all_valid = __all_sync(
        kFull, col0 >= 1 && col0 + C - 1 <= task.n && d0 + C <= task.width);
    int diag[C], up[C];
    const int local = all_valid
        ? pass1<C, true>(task, prev, right, ch, pc, col0, d0, diag, up)
        : pass1<C, false>(task, prev, right, ch, pc, col0, d0, diag, up);
    int next_head;
    int run = exchange(local, valid_cell(task, col0, d0),
                       min(diag[0], up[0]), xmin, xhead, i & 1, warp, warps,
                       lane, threads, next_head);
    const uint32_t codes = all_valid
        ? pass2<C, true>(task, run, prev, diag, up, ch, pc, col0, d0)
        : pass2<C, false>(task, run, prev, diag, up, ch, pc, col0, d0);
    uint32_t* out = task.dirs + static_cast<size_t>(i - 1) * row_words;
    reinterpret_cast<uint16_t*>(out)[tid] = static_cast<uint16_t>(codes);
    // the next row's right neighbour value and chars
    const int shifted_prev = __shfl_down_sync(kFull, prev[0], 1);
    const int shifted_ch = __shfl_down_sync(kFull, ch[0], 1);
    right = lane < 31 ? shifted_prev
                      : (next_head < 0 ? kBig : min(next_head, run + d0 + C));
#pragma unroll
    for (int k = 0; k + 1 < C; ++k) ch[k] = ch[k + 1];
    ch[C - 1] = lane < 31 ? shifted_ch : ch_load;
    pc = pc_next;
  }
}

// ---- 16 cells a lane and more: packed chars, candidates recomputed -----

// A lane's C window chars, four to a word: cell k's is byte k & 3 of word
// k >> 2.
template <int C>
struct PackedChars {
  uint32_t w[C / 4];

  __device__ __forceinline__ int at(int k) const {
    return (w[k >> 2] >> (8 * (k & 3))) & 0xff;
  }

  // every cell takes its right neighbour's char; the last takes the low
  // byte of `incoming`
  __device__ __forceinline__ void slide(uint32_t incoming) {
#pragma unroll
    for (int j = 0; j + 1 < C / 4; ++j) w[j] = __funnelshift_r(w[j], w[j + 1], 8);
    w[C / 4 - 1] = __funnelshift_r(w[C / 4 - 1], incoming, 8);
  }
};

// One cell's (diag, up, best) from the previous row's values `cur` (this
// cell) and `nxt` (the next), as pass 1 and pass 2 both compute them.
template <bool kAllValid>
__device__ __forceinline__ void cell_candidates(int cur, int nxt, bool sub,
                                                int col, int& diag, int& up,
                                                int& best) {
  diag = (kAllValid || col >= 1) ? cur + sub : kBig;
  up = nxt + 1;
  best = min(diag, up);
}

template <int C, bool kAllValid>
__device__ __forceinline__ int packed_pass1(const Task& task,
                                            const int (&dp)[C], int right,
                                            const PackedChars<C>& ch, int pc,
                                            int col0, int d0, int& head_best) {
  int local = kInf;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int nxt = k + 1 < C ? dp[k + 1] : right;
    int diag, up, best;
    cell_candidates<kAllValid>(dp[k], nxt, ch.at(k) != pc, col0 + k, diag,
                               up, best);
    if (k == 0) head_best = best;
    if (kAllValid) {
      local = min(local, best - (d0 + k));
    } else {
      local = min(local, (valid_cell(task, col0 + k, d0 + k) ? best : kBig) -
                             (d0 + k));
    }
  }
  return local;
}

// Pass 2 at C >= 16 cells: as pass2, with the candidates recomputed (each
// cell reads its right neighbour's previous value before its own new one
// replaces it) and the codes stored as C / 16 words from `out`; returns
// the first cell's new dp.
template <int C, bool kAllValid>
__device__ __forceinline__ int packed_pass2(const Task& task, int& run,
                                            int (&dp)[C], int right,
                                            const PackedChars<C>& ch, int pc,
                                            int col0, int d0, uint32_t* out) {
  int first = 0;
  uint32_t codes = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int nxt = k + 1 < C ? dp[k + 1] : right;
    const bool sub = ch.at(k) != pc;
    int diag, up, best, value;
    cell_candidates<kAllValid>(dp[k], nxt, sub, col0 + k, diag, up, best);
    if (kAllValid) {
      run = min(run, best - (d0 + k));
      value = run + d0 + k;
    } else {
      const bool valid = valid_cell(task, col0 + k, d0 + k);
      run = min(run, (valid ? best : kBig) - (d0 + k));
      value = valid ? min(best, run + d0 + k) : kBig;
    }
    codes |= static_cast<uint32_t>(direction(value, diag, up, sub))
             << (2 * (k & 15));
    if ((k & 15) == 15) {
      out[k >> 4] = codes;
      codes = 0;
    }
    if (k == 0) first = value;
    dp[k] = value;
  }
  return first;
}

// The packed chars of a lane's cells d0 .. d0 + C - 1 in row 1.
template <int C>
__device__ __forceinline__ PackedChars<C> first_chars(const Task& task,
                                                      int d0) {
  PackedChars<C> ch;
#pragma unroll
  for (int j = 0; j < C / 4; ++j) ch.w[j] = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    ch.w[k >> 2] |= static_cast<uint32_t>(char_at(task, task.base + d0 + k))
                    << (8 * (k & 3));
  }
  return ch;
}

// C = 16 or 32 cells a lane, their dp values in registers.
template <int C>
__device__ __forceinline__ void rows_packed(const Task& task, int* xmin,
                                            int* xhead, int tid, int warps,
                                            int row_words) {
  static_assert(C % 16 == 0, "whole code words a lane");
  const int lane = tid & 31, warp = tid >> 5, threads = warps * 32;
  const int d0 = tid * C;
  int dp[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    dp[k] = valid_cell(task, task.base + d0 + k, d0 + k) ? 0 : kBig;
  }
  PackedChars<C> ch = first_chars<C>(task, d0);
  int right = valid_cell(task, task.base + d0 + C, d0 + C) ? 0 : kBig;

  // the pattern char and lane 31's new char are loaded where they are
  // used (not a row ahead, as at 8 cells): at 32 cells a lane the
  // registers are full
  for (int i = 1; i <= task.m; ++i) {
    const int pc = __ldg(task.pat + i - 1);
    const int col0 = i + task.base + d0;
    const bool all_valid = __all_sync(
        kFull, col0 >= 1 && col0 + C - 1 <= task.n && d0 + C <= task.width);
    int head_best;
    const int local = all_valid
        ? packed_pass1<C, true>(task, dp, right, ch, pc, col0, d0, head_best)
        : packed_pass1<C, false>(task, dp, right, ch, pc, col0, d0,
                                 head_best);
    int next_head;
    int run = exchange(local, valid_cell(task, col0, d0), head_best, xmin,
                       xhead, i & 1, warp, warps, lane, threads, next_head);
    uint32_t* out = task.dirs + static_cast<size_t>(i - 1) * row_words +
                    static_cast<size_t>(tid) * (C / 16);
    const int first = all_valid
        ? packed_pass2<C, true>(task, run, dp, right, ch, pc, col0, d0, out)
        : packed_pass2<C, false>(task, run, dp, right, ch, pc, col0, d0, out);
    const int shifted_first = __shfl_down_sync(kFull, first, 1);
    const uint32_t shifted_chars = __shfl_down_sync(kFull, ch.w[0], 1);
    right = lane < 31 ? shifted_first
                      : (next_head < 0 ? kBig : min(next_head, run + d0 + C));
    const int ch_load =
        lane == 31 ? char_at(task, i + task.base + d0 + C - 1) : 0;
    ch.slide(lane < 31 ? shifted_chars : static_cast<uint32_t>(ch_load));
  }
}

// The packed chars of 16 cells whose first reads window position p. In a
// row where every cell of the warp is valid they all lie inside the
// window: five aligned words (the host starts each window at a multiple of
// 4 bytes and pads the buffer's end), funnel-shifted into place; else one
// char_at a cell.
template <bool kAllValid>
__device__ __forceinline__ PackedChars<16> chunk_chars(const Task& task,
                                                       int p) {
  PackedChars<16> ch;
  if (kAllValid) {
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(task.win) + (p >> 2);
    const int shift = 8 * (p & 3);
    uint32_t u[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = __ldg(words + j);
#pragma unroll
    for (int j = 0; j < 4; ++j) ch.w[j] = __funnelshift_r(u[j], u[j + 1], shift);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) ch.w[j] = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      ch.w[k >> 2] |= static_cast<uint32_t>(char_at(task, p + k))
                      << (8 * (k & 3));
    }
  }
  return ch;
}

// One pass over a thread's NQ chunks of 16 shared-row cells (cell c at
// cells[c * stride]; a thread past the band's owners reads BIG and stores
// nothing): each chunk's values and chars come into registers, pass 1 or
// pass 2 runs on them, and pass 2 stores them back. The loop over chunks
// is not unrolled: the registers hold one chunk's work. Pass 1 returns
// the minimum of (best - d) and sets head_best; pass 2 advances `run`,
// writes a code word a chunk and returns the first cell's new dp.
template <int NQ, bool kPass2, bool kAllValid>
__device__ __forceinline__ int shared_pass(const Task& task, int* cells,
                                           int stride, bool owns, int right,
                                           int pc, int col0, int d0, int& run,
                                           int& head_best, uint32_t* out) {
  int result = kPass2 ? 0 : kInf;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    int dp[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dp[k] = owns ? cells[(16 * q + k) * stride] : kBig;
    }
    const int chunk_right = q + 1 < NQ
        ? (owns ? cells[16 * (q + 1) * stride] : kBig) : right;
    const PackedChars<16> ch = chunk_chars<kAllValid>(task, col0 + 16 * q - 1);
    if (kPass2) {
      const int first = packed_pass2<16, kAllValid>(
          task, run, dp, chunk_right, ch, pc, col0 + 16 * q, d0 + 16 * q,
          out + q);
      if (q == 0) result = first;
      if (owns) {
#pragma unroll
        for (int k = 0; k < 16; ++k) cells[(16 * q + k) * stride] = dp[k];
      }
    } else {
      int head;
      result = min(result, packed_pass1<16, kAllValid>(
                               task, dp, chunk_right, ch, pc, col0 + 16 * q,
                               d0 + 16 * q, head));
      if (q == 0) head_best = head;
    }
  }
  return result;
}

// C = 16 NQ cells a thread (64, 96 or 128), their dp values in the shared
// row, cell c of thread t at row[c * owners + t].
template <int NQ>
__device__ __forceinline__ void rows_shared(const Task& task, int* xmin,
                                            int* xhead, int* row, int tid,
                                            int warps, int row_words) {
  constexpr int C = 16 * NQ;
  const int lane = tid & 31, warp = tid >> 5, threads = warps * 32;
  const int d0 = tid * C;
  const int owners = (task.width + C - 1) / C;
  const bool owns = tid < owners;
  int* cells = row + tid;
  if (owns) {
    for (int k = 0; k < C; ++k) {
      cells[k * owners] = valid_cell(task, task.base + d0 + k, d0 + k) ? 0
                                                                      : kBig;
    }
  }
  int right = valid_cell(task, task.base + d0 + C, d0 + C) ? 0 : kBig;

  for (int i = 1; i <= task.m; ++i) {
    const int pc = __ldg(task.pat + i - 1);
    const int col0 = i + task.base + d0;
    const bool all_valid = __all_sync(
        kFull, col0 >= 1 && col0 + C - 1 <= task.n && d0 + C <= task.width);
    int head_best = 0, run = 0;
    const int local = all_valid
        ? shared_pass<NQ, false, true>(task, cells, owners, owns, right, pc,
                                       col0, d0, run, head_best, nullptr)
        : shared_pass<NQ, false, false>(task, cells, owners, owns, right, pc,
                                        col0, d0, run, head_best, nullptr);
    int next_head;
    run = exchange(local, valid_cell(task, col0, d0), head_best, xmin, xhead,
                   i & 1, warp, warps, lane, threads, next_head);
    uint32_t* out = task.dirs + static_cast<size_t>(i - 1) * row_words +
                    static_cast<size_t>(tid) * NQ;
    const int first = all_valid
        ? shared_pass<NQ, true, true>(task, cells, owners, owns, right, pc,
                                      col0, d0, run, head_best, out)
        : shared_pass<NQ, true, false>(task, cells, owners, owns, right, pc,
                                       col0, d0, run, head_best, out);
    const int shifted_first = __shfl_down_sync(kFull, first, 1);
    right = lane < 31 ? shifted_first
                      : (next_head < 0 ? kBig : min(next_head, run + d0 + C));
  }
}

// One block per task, in the task's own layout (its table row's cells
// and shared-row flag); `walk_codes` 0 stops after the rows (the rows'
// time alone; ops, num_ops and begin_cols are then not written).
__global__ void __launch_bounds__(kMaxThreads) traceback_kernel(
    const uint8_t* __restrict__ windows, const uint8_t* __restrict__ patterns,
    const int64_t* __restrict__ table, int walk_codes,
    uint32_t* __restrict__ dirs, int8_t* __restrict__ ops,
    int32_t* __restrict__ num_ops, int32_t* __restrict__ begin_cols) {
  extern __shared__ int smem[];
  int* xmin = smem;
  int* xhead = smem + 64;
  int* area = smem + kExchangeInts;  // the shared row, then the walk's tile
  const int t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  int warps, row_words;
  {
    const Task task = load_task(table, windows, patterns, dirs, ops, t);
    warps = (task.width + 32 * task.cells - 1) / (32 * task.cells);
    if (warp >= warps) return;
    row_words = warps * 2 * task.cells;
    if (!task.shared_row) {
      if (task.cells == 8) {
        rows_reg8(task, xmin, xhead, tid, warps, row_words);
      } else if (task.cells == 16) {
        rows_packed<16>(task, xmin, xhead, tid, warps, row_words);
      } else {
        rows_packed<32>(task, xmin, xhead, tid, warps, row_words);
      }
    } else if (task.cells == 64) {
      rows_shared<4>(task, xmin, xhead, area, tid, warps, row_words);
    } else if (task.cells == 96) {
      rows_shared<6>(task, xmin, xhead, area, tid, warps, row_words);
    } else {
      rows_shared<8>(task, xmin, xhead, area, tid, warps, row_words);
    }
  }
  if (!walk_codes) return;
  __threadfence_block();
  block_barrier(warps * 32);
  if (warp == 0) {
    // the task again (its pointers were not kept live through the rows)
    const Task task = load_task(table, windows, patterns, dirs, ops, t);
    walk(task, row_words, tid & 31, reinterpret_cast<uint32_t*>(area),
         num_ops, begin_cols, t);
  }
}

}  // namespace

// threads: the block (32 x the most warps a task of the batch takes);
// stored: the most shared-row cells a task of the batch keeps; walk: 0 to
// stop after the rows. The host (ops/traceback_device.py::pack_batch)
// gives every task a layout the kernel has: 8, 16 or 32 register cells a
// lane, or 64, 96 or 128 shared-row cells.
extern "C" int floxer_traceback_banded(
    const void* windows, const void* patterns, const void* table, int T,
    int threads, int stored, int walk, void* dirs, void* ops, void* num_ops,
    void* begin_cols, void* stream) {
  if (T == 0) return 0;
  if (threads <= 0 || threads % 32 != 0 || threads > kMaxThreads ||
      stored < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int area = max(stored, kTileRows * kTileWords);
  const size_t shared = static_cast<size_t>(kExchangeInts + area) * sizeof(int);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traceback_kernel<<<T, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(windows),
      static_cast<const uint8_t*>(patterns),
      static_cast<const int64_t*>(table), walk, static_cast<uint32_t*>(dirs),
      static_cast<int8_t*>(ops), static_cast<int32_t*>(num_ops),
      static_cast<int32_t*>(begin_cols));
  return static_cast<int>(cudaGetLastError());
}
