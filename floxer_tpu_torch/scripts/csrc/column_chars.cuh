// A row's text chars as the research kernels K6 and K8 take them, one per
// column (microbench_column_loop.cu, microbench_carry_scaling.cu).
//
// The chars are int32, one per column, as the TPU scripts give them. They
// reach the column loop 32 at a time: lane l of the row's warp holds
// column 32 b + l of block b, loaded by one coalesced 128-byte load a warp
// a whole block ahead of the columns that take it, and each column's char
// is shuffled from its lane one column ahead. A column of these kernels can
// take a few dozen cycles, far less than a load's latency, so a load has
// to be in flight for many columns before its chars are taken. Past the
// row's end the chars are 0 and never taken.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace floxer_scripts {

struct ColumnChars {
  const int32_t* __restrict__ row;
  int num_text;
  int lane;
  uint32_t now;    // this lane's char of the current block
  uint32_t ahead;  // this lane's char of the next block
  uint32_t next;   // the next column's char

  __device__ __forceinline__ ColumnChars(const int32_t* __restrict__ row_,
                                         int num_text_, int lane_)
      : row(row_), num_text(num_text_), lane(lane_) {
    now = block(0);
    ahead = block(1);
    next = __shfl_sync(0xffffffffu, now, 0);
  }

  // this lane's char of block b (0 past the row's end)
  __device__ __forceinline__ uint32_t block(int b) const {
    const int column = 32 * b + lane;
    return column < num_text ? static_cast<uint32_t>(__ldg(row + column))
                             : 0u;
  }

  // column j's char, for j = 0, 1, 2, ... in turn; the whole warp calls it
  __device__ __forceinline__ uint32_t take(int j) {
    const uint32_t ch = next;
    const int k = j + 1;
    if ((k & 31) == 0) {
      now = ahead;
      ahead = block((k >> 5) + 1);
    }
    next = __shfl_sync(0xffffffffu, now, k & 31);
    return ch;
  }
};

}  // namespace floxer_scripts
