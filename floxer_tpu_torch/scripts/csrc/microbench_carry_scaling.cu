// Carry-scaling and per-row broadcast microbenchmarks (K7, K8).
//
// K7 replaces scripts/tpu_microbench_carry_scaling.py::make_kernel: what a
// column loop's cost scales with. Per row, n_carry carried arrays of
// BW = 256 words (array a starts at a + 1); per column j, with
// ch = texts[row, j]:
//   x = arr0 ^ ch; x += arr_a & 7 for every other array a (each then += 1);
//   n_ops x { x = (x ^ arr0) | (x >> 1) };
//   n_rolls x { x = (x shifted one word up, 0 into word 0) ^ arr0 };
//   arr0 = x
// and the result is arr0 [rows, 256].
//
// K8 replaces make_bcast_kernel of the same script: the per-row scalar
// conditions of K1's column (sliding, pessimism, char selects). Per row,
// x = 1 and y = 3; per column j: n_bcast x { if (j + t <= jstar[row])
// x ^= y } for t = 0..n_bcast-1; x += ch; y += 1. The result is x.
//
// The configurations are static on the TPU (trace-time Python loops) and
// template parameters here, instantiated for exactly the script's lists;
// the entry points refuse any other configuration.
//
// Layout, both kernels: K1's register column at 256 band words (its
// myers_banded_reg_kernel<8>, csrc/myers_banded.cu). One warp per row,
// lane l owns the words [8l, 8l+8) of each carried array as registers,
// indexed only by constants in unrolled loops, as K1 holds its six band
// arrays; nothing is read or written in shared memory. K7: kCarry x 8
// words a lane (24, 80, 112 registers at 3, 10, 14 arrays), so what it
// times is what K1 pays for each carried array and each word of a lane's
// run; a one-word roll is register moves plus one __shfl_up_sync, the way
// K1 shifts its horizontal deltas. The arrays' start values are loaded from
// an operand (K7: a + 1 in every word of row a; K8: x = 1, y = 3): from
// constants the compiler could prove the words of an array, or K7's arrays
// 1.., equal induction variables and fold them, and the kernel would time
// fewer words or arrays than it names.
//
// K8's conditions: each j + t <= jstar[row] is the same for the whole warp
// (one row). It is compared once per column and t, with jstar in a
// register, and applied to each of a lane's 8 words of x as a predicated
// xor, as K1 applies its one per-column condition (col >= topshift) to its
// words. The n_bcast predicated xors of a column are inline PTX: written as
// selects, the compiler may merge them into one xor of y under the parity
// of the column's true conditions, which gives the same x but no longer
// prices a condition on each word. The chars arrive a block of 32 columns a
// warp load, a block ahead (column_chars.cuh); K7 loads each one column
// ahead.
//
// What bounds them on an H100: the issue of one warp's column (32 rows,
// 32 warps, one on each of 32 of the card's 528 SM sub-partitions). For K7
// that is a dependent chain of SHF/LOP3 pairs (2 n_ops deep) over 8
// independent words, then n_rolls shuffles; for K8, n_bcast compares and
// 8 n_bcast predicated xors a column, then 16 adds. The compares and xors
// go to the sub-partition's integer pipe, which takes a warp's instruction
// only every other cycle: at n_bcast = 18 they set ~330 of a column's ~380
// cycles.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "column_chars.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBandWords = 256;
constexpr int kRun = kBandWords / 32;  // words per lane

template <int kCarry, int kOps, int kRolls>
__global__ void __launch_bounds__(32) carry_scaling_kernel(
    const int32_t* __restrict__ texts, const uint32_t* __restrict__ starts,
    int rows, int num_text, uint32_t* __restrict__ out) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
  // arr[0] is arr0; starts is [>= kCarry, 256], row a holding a + 1
  uint32_t arr[kCarry][kRun];
#pragma unroll
  for (int a = 0; a < kCarry; ++a) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      arr[a][i] = __ldg(starts + a * kBandWords + lane * kRun + i);
    }
  }
  const int32_t* trow = texts + static_cast<size_t>(row) * num_text;
  // each column's char is loaded one column ahead
  uint32_t next = num_text >= 1 ? static_cast<uint32_t>(__ldg(trow)) : 0u;

#pragma unroll 1
  for (int j = 0; j < num_text; ++j) {
    const uint32_t ch = next;
    if (j + 1 < num_text) next = static_cast<uint32_t>(__ldg(trow + j + 1));
    uint32_t x[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) x[i] = arr[0][i] ^ ch;
#pragma unroll
    for (int a = 1; a < kCarry; ++a) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        x[i] += arr[a][i] & 7u;
        arr[a][i] += 1u;
      }
    }
#pragma unroll
    for (int r = 0; r < kOps; ++r) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) x[i] = (x[i] ^ arr[0][i]) | (x[i] >> 1);
    }
#pragma unroll
    for (int r = 0; r < kRolls; ++r) {
      const uint32_t below = __shfl_up_sync(kFull, x[kRun - 1], 1);
#pragma unroll
      for (int i = kRun - 1; i > 0; --i) x[i] = x[i - 1] ^ arr[0][i];
      x[0] = (lane == 0 ? 0u : below) ^ arr[0][0];
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) arr[0][i] = x[i];
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    out[static_cast<size_t>(row) * kBandWords + lane * kRun + i] = arr[0][i];
  }
}

// x[i] ^= y[i] on each of the 8 words when d <= -kT, i.e. j + kT <=
// jstar: one compare, then eight predicated xors
template <int kT>
__device__ __forceinline__ void xor_if(uint32_t (&x)[kRun],
                                       const uint32_t (&y)[kRun], int d) {
  static_assert(kRun == 8, "one predicated xor for each of 8 words");
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.le.s32 p, %8, %9;\n\t"
      "@p xor.b32 %0, %0, %10;\n\t"
      "@p xor.b32 %1, %1, %11;\n\t"
      "@p xor.b32 %2, %2, %12;\n\t"
      "@p xor.b32 %3, %3, %13;\n\t"
      "@p xor.b32 %4, %4, %14;\n\t"
      "@p xor.b32 %5, %5, %15;\n\t"
      "@p xor.b32 %6, %6, %16;\n\t"
      "@p xor.b32 %7, %7, %17;\n\t"
      "}"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7])
      : "r"(d), "n"(-kT), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]),
        "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]));
}

// the column's conditions t = 0, 1, ... in order
template <int... kT>
__device__ __forceinline__ void conditions(uint32_t (&x)[kRun],
                                           const uint32_t (&y)[kRun], int d,
                                           std::integer_sequence<int, kT...>) {
  (xor_if<kT>(x, y, d), ...);
}

template <int kBcast>
__global__ void __launch_bounds__(32) bcast_kernel(
    const int32_t* __restrict__ texts, const int32_t* __restrict__ jstar,
    const uint32_t* __restrict__ starts, int rows, int num_text,
    uint32_t* __restrict__ out) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
  // starts is [2, 256]: x, y
  uint32_t x[kRun], y[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    x[i] = __ldg(starts + lane * kRun + i);
    y[i] = __ldg(starts + kBandWords + lane * kRun + i);
  }
  // j + t <= jstar as d = j - js <= -t; js clamped to [-1, num_text +
  // kBcast], which leaves every condition as it was and d without overflow
  const int js = min(max(__ldg(jstar + row), -1), num_text + kBcast);
  floxer_scripts::ColumnChars chars(
      texts + static_cast<size_t>(row) * num_text, num_text, lane);

#pragma unroll 1
  for (int j = 0; j < num_text; ++j) {
    const uint32_t ch = chars.take(j);
    conditions(x, y, j - js, std::make_integer_sequence<int, kBcast>{});
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      x[i] += ch;
      y[i] += 1u;
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    out[static_cast<size_t>(row) * kBandWords + lane * kRun + i] = x[i];
  }
}

}  // namespace

#define FLOXER_CARRY_CONFIG(C, O, R)                                      \
  if (n_carry == C && n_ops == O && n_rolls == R) {                       \
    carry_scaling_kernel<C, O, R><<<rows, 32, 0, s>>>(                    \
        static_cast<const int32_t*>(texts),                               \
        static_cast<const uint32_t*>(starts), rows, num_text,             \
        static_cast<uint32_t*>(out));                                     \
    return static_cast<int>(cudaGetLastError());                          \
  }

// texts int32 [rows, num_text] (chars 0..4), starts uint32 [n_carry or
// more, 256] (row a: a + 1 in every word), out uint32 [rows, 256]; the
// script's eight (n_carry, n_ops, n_rolls) configurations
extern "C" int floxer_carry_scaling(const void* texts, const void* starts,
                                    int rows, int num_text, int n_carry,
                                    int n_ops, int n_rolls, void* out,
                                    void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOXER_CARRY_CONFIG(3, 0, 0)
  FLOXER_CARRY_CONFIG(10, 0, 0)
  FLOXER_CARRY_CONFIG(14, 0, 0)
  FLOXER_CARRY_CONFIG(10, 40, 0)
  FLOXER_CARRY_CONFIG(10, 80, 0)
  FLOXER_CARRY_CONFIG(10, 40, 12)
  FLOXER_CARRY_CONFIG(3, 80, 12)
  FLOXER_CARRY_CONFIG(10, 80, 12)
  return static_cast<int>(cudaErrorInvalidValue);
}

#define FLOXER_BCAST_CONFIG(B)                                            \
  if (n_bcast == B) {                                                     \
    bcast_kernel<B><<<rows, 32, 0, s>>>(                                  \
        static_cast<const int32_t*>(texts),                               \
        static_cast<const int32_t*>(jstar),                               \
        static_cast<const uint32_t*>(starts), rows, num_text,             \
        static_cast<uint32_t*>(out));                                     \
    return static_cast<int>(cudaGetLastError());                          \
  }

// texts int32 [rows, num_text], jstar int32 [rows], starts uint32 [2, 256]
// (x, y: 1, 3 in every word), out uint32 [rows, 256]; n_bcast one of the
// script's 0, 4, 10, 18
extern "C" int floxer_bcast(const void* texts, const void* jstar,
                            const void* starts, int rows, int num_text,
                            int n_bcast, void* out, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOXER_BCAST_CONFIG(0)
  FLOXER_BCAST_CONFIG(4)
  FLOXER_BCAST_CONFIG(10)
  FLOXER_BCAST_CONFIG(18)
  return static_cast<int>(cudaErrorInvalidValue);
}
