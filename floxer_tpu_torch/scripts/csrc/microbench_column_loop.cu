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
// Design: K1's register column at 256 band words, the layout of its
// myers_banded_reg_kernel<8> (csrc/myers_banded.cu), so that what K6 times
// is the column K1 runs. One warp a row; lane l owns the words [8l, 8l+8)
// of each carried array as registers, indexed only by constants in
// unrolled loops; nothing is read or written in shared memory. `rolls`
// shifts as K1 shifts its horizontal deltas: each word takes the one below
// it inside the lane, and the lane's bottom word takes the top word of
// lane l-1 by one __shfl_up_sync, 0 in lane 0. The chars arrive a block of
// 32 columns a warp load, a block ahead, each shuffled from its lane a
// column ahead (column_chars.cuh).
//
// The start values come from an operand (a [3, 256] table, one row per
// array, that the wrapper keeps per device). Every word of a row holds the
// same value in `empty` and `elementwise`: from constants the compiler
// could prove that and compute one word a lane where the function names
// eight. In `rolls` v1 and v2 never change, so x is the same every column;
// an empty asm statement hides v1's value from the compiler at each column,
// so the twelve rolls stay in the column loop, as the TPU kernel runs them.
//
// What bounds it on an H100: one warp's column on its SM sub-partition (32
// rows, 32 warps, one on each of 32 of the card's 528 sub-partitions).
// `elementwise` issues about 20 x 4 instructions a word (the xor, the or,
// the add and v1's add), 8 words a lane; its xors and ors are LOP3s, which
// the sub-partition's integer pipe takes from a warp only every other
// cycle, so their 320 a column set ~640 of its ~730 cycles (the adds go to
// the IMAD pipe). `empty` is the loop's floor: ~16 instructions and two
// taken branches a column, ~68 cycles.

#include <cstdint>
#include <cuda_runtime.h>

#include "column_chars.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBandWords = 256;
constexpr int kRun = kBandWords / 32;  // words per lane

enum Variant { kEmpty = 0, kElementwise = 1, kRolls = 2 };

template <int V>
__global__ void __launch_bounds__(32) column_loop_kernel(
    const int32_t* __restrict__ texts, const uint32_t* __restrict__ starts,
    int rows, int num_text, uint32_t* __restrict__ out) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
  // starts is [3, 256]: acc, v1, v2
  uint32_t acc[kRun], v1[kRun], v2[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int at = lane * kRun + i;
    acc[i] = __ldg(starts + at);
    v1[i] = __ldg(starts + kBandWords + at);
    v2[i] = __ldg(starts + 2 * kBandWords + at);
  }
  floxer_scripts::ColumnChars chars(
      texts + static_cast<size_t>(row) * num_text, num_text, lane);

#pragma unroll 1
  for (int j = 0; j < num_text; ++j) {
    const uint32_t ch = chars.take(j);
    if constexpr (V == kEmpty) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc[i] += ch;
    } else if constexpr (V == kElementwise) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        uint32_t x = v1[i];
#pragma unroll
        for (int r = 0; r < 20; ++r) {
          x = (x ^ v2[i]) + (x | v1[i]);
          v1[i] += 1u;
        }
        acc[i] += x + ch;
      }
    } else {
      uint32_t x[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        asm("" : "+r"(v1[i]));
        x[i] = v1[i];
      }
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        const uint32_t below = __shfl_up_sync(kFull, x[kRun - 1], 1);
#pragma unroll
        for (int i = kRun - 1; i > 0; --i) x[i] = x[i - 1] | v2[i];
        x[0] = (lane == 0 ? 0u : below) | v2[0];
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc[i] += x[i] + ch;
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    out[static_cast<size_t>(row) * kBandWords + lane * kRun + i] = acc[i];
  }
}

template <int V>
int launch(const void* texts, const void* starts, int rows, int num_text,
           void* out, cudaStream_t stream) {
  column_loop_kernel<V><<<rows, 32, 0, stream>>>(
      static_cast<const int32_t*>(texts),
      static_cast<const uint32_t*>(starts), rows, num_text,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// texts int32 [rows, num_text] (chars 0..4), starts uint32 [3, 256] (acc,
// v1, v2: 0, 1, 3 in every word), out uint32 [rows, 256]; variant 0 empty,
// 1 elementwise, 2 rolls
extern "C" int floxer_column_loop(const void* texts, const void* starts,
                                  int rows, int num_text, int variant,
                                  void* out, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kEmpty: return launch<kEmpty>(texts, starts, rows, num_text, out, s);
    case kElementwise:
      return launch<kElementwise>(texts, starts, rows, num_text, out, s);
    case kRolls: return launch<kRolls>(texts, starts, rows, num_text, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
