// Column-loop floor microbenchmark (K6).
//
// Replaces scripts/tpu_microbench_column_loop.py::make_kernel, the Pallas
// kernel that measures what one text column of a Myers-style loop costs
// with (almost) nothing in its body. Per row of 32 rows: three carried
// arrays of BW = 256 words (acc = 0, v1 = 1, v2 = 3); per column j, with
// ch = texts[row, j]:
//   empty        acc += ch
//   elementwise  x = v1; 20 x { x = (x ^ v2) + (x | v1); v1 += 1 };
//                acc += x + ch
//   rolls        x = v1; 12 x { x = (x shifted one word up, 0 into word
//                0) | v2 }; acc += x + ch
// and the result is acc [rows, 256].
//
// What bounds it on an H100: nothing but the column chain itself. A few
// bytes enter per column, so the time per column is the latency of the
// column's dependent integer ops, shared-memory round trips and shuffles.
//
// Design: the layout K1 (csrc/myers_banded.cu) and the other research
// kernels share, so their numbers decompose K1's column. One warp per row;
// lane l owns the words [8l, 8l+8). Carried arrays live in shared memory,
// interleaved so that word i of lane l sits at [i*32 + l], as K1 holds its
// state; the per-column temporary x lives in registers. A one-word roll is
// a register move inside the lane's run plus one __shfl_up_sync for the
// word that crosses from lane l-1. Each column's char is read from
// texts[row, j]; the TPU kernel's 128-column block roll, which only brought
// a column's char to lane 0, has no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBandWords = 256;
constexpr int kRun = kBandWords / 32;  // words per lane

enum Variant { kEmpty = 0, kElementwise = 1, kRolls = 2 };

template <int V>
__global__ void column_loop_kernel(const int32_t* __restrict__ texts,
                                   int rows, int num_text,
                                   uint32_t* __restrict__ out) {
  __shared__ uint32_t acc_s[kBandWords];
  __shared__ uint32_t v1_s[kBandWords];
  __shared__ uint32_t v2_s[kBandWords];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int at = i * 32 + lane;
    acc_s[at] = 0u;
    v1_s[at] = 1u;
    v2_s[at] = 3u;
  }
  const int32_t* trow = texts + static_cast<size_t>(row) * num_text;

  for (int j = 0; j < num_text; ++j) {
    const uint32_t ch = static_cast<uint32_t>(trow[j]);
    if constexpr (V == kEmpty) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc_s[i * 32 + lane] += ch;
    } else if constexpr (V == kElementwise) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int at = i * 32 + lane;
        uint32_t v1 = v1_s[at];
        const uint32_t v2 = v2_s[at];
        uint32_t x = v1;
#pragma unroll
        for (int r = 0; r < 20; ++r) {
          x = (x ^ v2) + (x | v1);
          v1 += 1u;
        }
        v1_s[at] = v1;
        acc_s[at] += x + ch;
      }
    } else {
      uint32_t x[kRun];
      uint32_t v2[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        x[i] = v1_s[i * 32 + lane];
        v2[i] = v2_s[i * 32 + lane];
      }
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        const uint32_t below = __shfl_up_sync(kFull, x[kRun - 1], 1);
#pragma unroll
        for (int i = kRun - 1; i > 0; --i) x[i] = x[i - 1] | v2[i];
        x[0] = (lane == 0 ? 0u : below) | v2[0];
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc_s[i * 32 + lane] += x[i] + ch;
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    out[static_cast<size_t>(row) * kBandWords + lane * kRun + i] =
        acc_s[i * 32 + lane];
  }
}

template <int V>
int launch(const void* texts, int rows, int num_text, void* out,
           cudaStream_t stream) {
  column_loop_kernel<V><<<rows, 32, 0, stream>>>(
      static_cast<const int32_t*>(texts), rows, num_text,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// texts int32 [rows, num_text] (chars 0..4), out uint32 [rows, 256];
// variant 0 empty, 1 elementwise, 2 rolls
extern "C" int floxer_column_loop(const void* texts, int rows, int num_text,
                                  int variant, void* out, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kEmpty: return launch<kEmpty>(texts, rows, num_text, out, s);
    case kElementwise:
      return launch<kElementwise>(texts, rows, num_text, out, s);
    case kRolls: return launch<kRolls>(texts, rows, num_text, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
