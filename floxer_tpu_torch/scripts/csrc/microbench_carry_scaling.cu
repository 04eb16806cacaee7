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
// Layout: one warp per row, lane l owns the words [8l, 8l+8). K7 holds its
// carried arrays in registers, as K1's register kernel holds its six band
// arrays: kCarry x 8 words a lane (24, 80, 112 registers at 3, 10, 14
// arrays), so what it times is what K1 pays for each carried array and
// each word of a lane's run; a one-word roll is register moves plus one
// __shfl_up_sync, the way K1 shifts its horizontal deltas. The arrays'
// start values are loaded from an operand (a + 1 in every word of row a):
// from constants the compiler could prove the words of an array, or the
// arrays 1.., equal induction variables and fold them, and K7 would time
// fewer arrays than it names. K8 keeps its two arrays in shared memory at
// [i*32 + l], as K6 (microbench_column_loop.cu) does; jstar is one int per
// row, held in a register.
//
// What bounds them on an H100: the latency of the column chain. For K7
// that is the issue of a dependent chain of SHF/LOP3 pairs (2 n_ops deep)
// over 8 independent words, then n_rolls shuffles, one warp per row.

#include <cstdint>
#include <cuda_runtime.h>

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

template <int kBcast>
__global__ void bcast_kernel(const int32_t* __restrict__ texts,
                             const int32_t* __restrict__ jstar, int rows,
                             int num_text, uint32_t* __restrict__ out) {
  __shared__ uint32_t xs[kBandWords];
  __shared__ uint32_t ys[kBandWords];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    xs[i * 32 + lane] = 1u;
    ys[i * 32 + lane] = 3u;
  }
  const int js = jstar[row];
  const int32_t* trow = texts + static_cast<size_t>(row) * num_text;

  for (int j = 0; j < num_text; ++j) {
    const uint32_t ch = static_cast<uint32_t>(trow[j]);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int at = i * 32 + lane;
      uint32_t x = xs[at];
      const uint32_t y = ys[at];
#pragma unroll
      for (int t = 0; t < kBcast; ++t) x = (j + t <= js) ? (x ^ y) : x;
      xs[at] = x + ch;
      ys[at] = y + 1u;
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    out[static_cast<size_t>(row) * kBandWords + lane * kRun + i] =
        xs[i * 32 + lane];
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
        static_cast<const int32_t*>(jstar), rows, num_text,               \
        static_cast<uint32_t*>(out));                                     \
    return static_cast<int>(cudaGetLastError());                          \
  }

// texts int32 [rows, num_text], jstar int32 [rows], out uint32 [rows, 256];
// n_bcast one of the script's 0, 4, 10, 18
extern "C" int floxer_bcast(const void* texts, const void* jstar, int rows,
                            int num_text, int n_bcast, void* out,
                            void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOXER_BCAST_CONFIG(0)
  FLOXER_BCAST_CONFIG(4)
  FLOXER_BCAST_CONFIG(10)
  FLOXER_BCAST_CONFIG(18)
  return static_cast<int>(cudaErrorInvalidValue);
}
