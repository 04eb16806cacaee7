// Banded CIGAR traceback for accepted PEX roots (K4).
//
// Replaces the XLA program
// floxer_tpu/ops/traceback_device.py::_banded_directions_and_walk: per
// task, the semi-global DP restricted to the band of w_pad cells around
// the optimal path's diagonal (cell d of row i is column
// i + end_col - m - half + d, half = max(distance, 0)), a 2-bit direction
// code per cell (the move the host walk takes there, ties I, then
// diagonal, then D), and the walk back from (m, half) over those codes.
// The arithmetic is the reference's int32 arithmetic bit for bit: BIG in
// invalid cells, BIG + 1 for the vertical predecessor past the band's
// right edge, diagonal only for columns >= 1, the valid mask
// 0 <= col <= n && d < 2*half + 1.
//
// What bounds it on an H100: the rows are a serial chain (m ~ 20.6k at the
// 20 kb root shape), each row a min-plus prefix scan over the band, so one
// row costs a block-wide scan and two barriers; the direction codes leave
// as 2 bits per cell (m * w_pad / 4 bytes per task, ~17 MB at the root
// shape). The walk is one dependent load per step.
//
// Design: one thread block per task. The dp row (w_pad int32) lives in
// shared memory and is updated in place: each thread owns a run of C
// cells (C a multiple of 4, so it writes whole bytes of direction codes)
// and, per row, (1) computes the diagonal and vertical candidates of its
// cells and the minimum of (best - d) over them, (2) joins a block scan of
// those minima (warp shuffles, then the 32 warp totals through shared
// memory) and (3) recomputes the candidates, applies the horizontal
// min-plus prefix cummin(best - d) + d, writes dp back and packs the
// direction codes. Reading the candidates in ascending cell order lets
// the row be overwritten in place; the one value a thread reads from its
// right neighbour's run is taken before the scan's barrier. After the
// last row one thread walks the codes back to row 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 20;
constexpr int kInf = 0x3fffffff;  // above every (best - d) a cell can hold
constexpr int kMaxThreads = 1024;
constexpr int kDirI = 0, kDirEq = 1, kDirX = 2, kDirD = 3;

__device__ __forceinline__ int warp_inclusive_min(int v, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int up = __shfl_up_sync(kFull, v, offset);
    if (lane >= offset) v = min(v, up);
  }
  return v;
}

__global__ void traceback_banded_kernel(
    const int32_t* __restrict__ windows,    // [T, n_pad]
    const int32_t* __restrict__ patterns,   // [T, m_pad]
    const int32_t* __restrict__ n_lens,     // [T]
    const int32_t* __restrict__ m_lens,     // [T]
    const int32_t* __restrict__ end_cols,   // [T]
    const int32_t* __restrict__ distances,  // [T]
    int T, int m_pad, int w_pad, int n_pad, int cells_per_thread,
    uint8_t* __restrict__ dirs,             // [T, m_pad, ceil(w_pad / 4)]
    int8_t* __restrict__ ops,               // [m_pad + w_pad, T], -1 filled
    int32_t* __restrict__ num_ops,          // [T]
    int32_t* __restrict__ begin_cols) {     // [T]
  extern __shared__ int smem[];
  int* row = smem;               // [w_pad] the dp row, updated in place
  int* warp_min = smem + w_pad;  // [32] per-warp scan totals

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d0 = tid * cells_per_thread;
  const int d1 = min(d0 + cells_per_thread, w_pad);  // empty when d0 >= w_pad

  const int m = m_lens[t];
  const int n = n_lens[t];
  const int half = max(distances[t], 0);
  const int width = 2 * half + 1;
  const int base = end_cols[t] - m - half;  // column of cell 0 in row 0
  const int32_t* win = windows + static_cast<size_t>(t) * n_pad;
  const int32_t* pat = patterns + static_cast<size_t>(t) * m_pad;
  const int row_bytes = (w_pad + 3) >> 2;
  uint8_t* task_dirs = dirs + static_cast<size_t>(t) * m_pad * row_bytes;

  // row 0: free leading reference gaps
  for (int d = d0; d < d1; ++d) {
    const int col = base + d;
    row[d] = (col >= 0 && col <= n && d < width) ? 0 : kBig;
  }
  __syncthreads();

  for (int i = 1; i <= m; ++i) {
    const int pc = pat[i - 1];
    const int col0 = i + base;
    // the previous row's value right of this thread's run (the vertical
    // predecessor of its last cell), read before anyone overwrites it
    const int right = d1 < w_pad ? row[d1] : kBig;

    int local = kInf;
    for (int d = d0; d < d1; ++d) {
      const int col = col0 + d;
      const bool valid = col >= 0 && col <= n && d < width;
      const int sub = win[min(max(col - 1, 0), n_pad - 1)] != pc;
      const int diag = col >= 1 ? row[d] + sub : kBig;
      const int up = (d + 1 < d1 ? row[d + 1] : right) + 1;
      local = min(local, (valid ? min(diag, up) : kBig) - d);
    }
    const int inclusive = warp_inclusive_min(local, lane);
    int exclusive = __shfl_up_sync(kFull, inclusive, 1);
    if (lane == 0) exclusive = kInf;
    if (lane == 31) warp_min[warp] = inclusive;
    __syncthreads();

    int earlier = lane < warp ? warp_min[lane] : kInf;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      earlier = min(earlier, __shfl_xor_sync(kFull, earlier, offset));
    }
    int run = min(earlier, exclusive);  // cummin(best - e) over e < d0

    uint8_t* out = task_dirs + static_cast<size_t>(i - 1) * row_bytes;
    unsigned byte = 0;
    for (int d = d0; d < d1; ++d) {
      const int col = col0 + d;
      const bool valid = col >= 0 && col <= n && d < width;
      const int sub = win[min(max(col - 1, 0), n_pad - 1)] != pc;
      const int diag = col >= 1 ? row[d] + sub : kBig;
      const int up = (d + 1 < d1 ? row[d + 1] : right) + 1;
      const int best = min(diag, up);
      run = min(run, (valid ? best : kBig) - d);
      const int dp = valid ? min(best, run + d) : kBig;
      const int code = dp == up ? kDirI
                       : dp == diag ? (sub ? kDirX : kDirEq)
                                    : kDirD;
      row[d] = dp;  // row[d + 1] still holds the previous row
      byte |= static_cast<unsigned>(code) << (2 * (d & 3));
      if ((d & 3) == 3 || d + 1 == d1) {
        out[d >> 2] = static_cast<uint8_t>(byte);
        byte = 0;
      }
    }
    __syncthreads();
  }

  if (tid != 0) return;
  // walk back from (m, half); ops leave in walk order (reversed)
  const int steps = m_pad + w_pad;
  const long long last = static_cast<long long>(m_pad) * w_pad - 1;
  int i = m;
  int d = half;
  int count = 0;
  for (int s = 0; s < steps && i > 0; ++s) {
    long long flat = static_cast<long long>(i - 1) * w_pad + d;
    flat = flat < 0 ? 0 : (flat > last ? last : flat);
    const long long r = flat / w_pad;
    const int c = static_cast<int>(flat - r * w_pad);
    const int code =
        (task_dirs[static_cast<size_t>(r) * row_bytes + (c >> 2)] >> (2 * (c & 3))) & 3;
    ops[static_cast<size_t>(s) * T + t] = static_cast<int8_t>(code);
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
  num_ops[t] = count;
  begin_cols[t] = base + d;
}

}  // namespace

extern "C" int floxer_traceback_banded(
    const void* windows, const void* patterns, const void* n_lens,
    const void* m_lens, const void* end_cols, const void* distances,
    int T, int m_pad, int w_pad, int n_pad,
    void* dirs, void* ops, void* num_ops, void* begin_cols, void* stream) {
  if (T == 0) return 0;
  if (w_pad <= 0 || m_pad <= 0 || n_pad <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_bytes = (w_pad + 3) / 4;
  int threads = ((row_bytes + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int cells_per_thread = 4 * ((row_bytes + threads - 1) / threads);
  const size_t shared = static_cast<size_t>(w_pad + 32) * sizeof(int);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traceback_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traceback_banded_kernel<<<T, threads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(windows), static_cast<const int32_t*>(patterns),
      static_cast<const int32_t*>(n_lens), static_cast<const int32_t*>(m_lens),
      static_cast<const int32_t*>(end_cols), static_cast<const int32_t*>(distances),
      T, m_pad, w_pad, n_pad, cells_per_thread, static_cast<uint8_t*>(dirs),
      static_cast<int8_t*>(ops), static_cast<int32_t*>(num_ops),
      static_cast<int32_t*>(begin_cols));
  return static_cast<int>(cudaGetLastError());
}
