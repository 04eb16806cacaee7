// Section ablation of K1's register column (K5).
//
// Replaces scripts/tpu_ablate_banded_kernel.py::make_kernel, which times
// the banded kernel's column body with one section removed at a time. It
// ablates the column the port's main path runs: column_reg<R, kSliding, F>
// of csrc/myers_banded_column.cuh, which K1's one-warp register kernel
// (myers_banded_reg_kernel<R> in csrc/myers_banded.cu) runs with F = 0.
// Each variant of the script is one compile-time mask F of that header's
// ColumnSection bits:
//   slide    kNoSlide    the head shuffle and the six slide_reg calls, and
//                        s_bot += 1 while sliding
//   Eq       kNoEq       Eq's LOP3 of the char planes; off: P0^P1^P2^AM^ch
//   carry    kNoKs       or_tree of the words' generate and propagate
//                        bits, the two ballots and the look-ahead adds;
//                        off: sum = t
//   score    kNoScore    d_bot, s_bot, s_m and the best update; off: best
//                        += 1, best_end += 1 every column
//   hshift   kNoHshift   the funnel shifts and the __shfl_up_sync of Ph,
//                        Mh; off: Ph, Mh as they are
//   stream2  kNoStream2  the entering pattern char: not loaded, 0
//   radix-4  kRadix4     the lanes' carries by the TPU's radix-4 scan
//                        (shuffles at d, 2d, 3d) in place of the ballot
//                        look-ahead; its output equals the full column's
// The layout is K1's: one warp a row, lane l holds the band words [lR,
// (l+1)R) of each array in registers. R = 4, 8, 12 (128, 256, 384 words:
// the script's 256, and K1's register widths of its end-column checks and
// of pass A's root level); nine variants at each, 27 instances.
//
// The function is the TPU script's, which differs from K1's: chars arrive
// as int32 per column (not nibbles); every row runs all num_text columns
// (no stop at tlen: time per column divides by it), so only columns with
// col < tlen are scored; s_bot starts at binit, s_m and best at minit; the
// output consumes every carried array (dist = s_bot + s_m + best +
// best_end + word BW-1 of VP^VN^P0^P1^P2^AM, int32 wraparound; end =
// best_end), so no ablated variant loses a section to dead-code removal.
// As in K1, the sliding and the frozen columns run in two loops, and lane
// 31 keeps the scores and writes the result.
//
// What bounds it on an H100: as K1's register kernel, the latency of one
// warp's column chain (dependent integer ops between the slide's, the
// carries' and the shift's warp exchanges); the script's 32 rows are 32
// warps, one on each of 32 of the card's 528 SM sub-partitions.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_banded_column.cuh"

namespace {

using floxer_banded::column_reg;
using floxer_banded::kNoEq;
using floxer_banded::kNoHshift;
using floxer_banded::kNoKs;
using floxer_banded::kNoScore;
using floxer_banded::kNoSlide;
using floxer_banded::kNoStream2;
using floxer_banded::kRadix4;

template <int R, int F>
__global__ void __launch_bounds__(32) ablate_banded_kernel(
    const uint32_t* __restrict__ vp0,      // [rows, BW]
    const uint32_t* __restrict__ planes0,  // [rows, 4, BW]
    const int32_t* __restrict__ texts,     // [rows, N] chars 0..4
    const int32_t* __restrict__ pstream,   // [rows, N] chars 0..4
    const int32_t* __restrict__ scalars,   // [rows, 6]
    int rows, int N,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  constexpr int BW = 32 * R;
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;

  uint32_t vp[R], vn[R], p0[R], p1[R], p2[R], am[R];
  const size_t base = static_cast<size_t>(row) * BW + lane * R;
  const size_t pbase = static_cast<size_t>(row) * 4 * BW + lane * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    vp[i] = vp0[base + i];
    vn[i] = 0u;
    p0[i] = planes0[pbase + i];
    p1[i] = planes0[pbase + BW + i];
    p2[i] = planes0[pbase + 2 * BW + i];
    am[i] = planes0[pbase + 3 * BW + i];
  }

  const int32_t* sc = scalars + static_cast<size_t>(row) * 6;
  const int tlen = sc[0];
  const int jstar = sc[1];
  const int topshift = sc[2];
  const uint32_t mfrozen = sc[3] != 0 ? 1u : 0u;
  int s_bot = sc[5];
  int s_m = sc[4];
  int best = sc[4];
  int best_end = 0;

  const int32_t* trow = texts + static_cast<size_t>(row) * N;
  const int32_t* srow = pstream + static_cast<size_t>(row) * N;
  // the band slides on columns 1..slide_end, is frozen after
  const int slide_end = min(jstar, N);
  constexpr bool kStream2 = !(F & kNoStream2);
  // each column's chars are loaded one column ahead
  uint32_t tnext = N >= 1 ? static_cast<uint32_t>(__ldg(trow)) : 0u;
  uint32_t snext =
      kStream2 && slide_end >= 1 ? static_cast<uint32_t>(__ldg(srow)) : 0u;

  int col = 1;
#pragma unroll 1
  for (; col <= slide_end; ++col) {
    const uint32_t tch = tnext;
    const uint32_t pch = snext;
    if (col < N) {
      tnext = static_cast<uint32_t>(__ldg(trow + col));
      if constexpr (kStream2) snext = static_cast<uint32_t>(__ldg(srow + col));
    }
    const int d = column_reg<R, true, F>(vp, vn, p0, p1, p2, am, tch, pch,
                                         col >= topshift ? 1u : 0u, lane);
    if constexpr (!(F & kNoSlide)) s_bot += 1;
    if constexpr (F & kNoScore) {
      best += 1;
      best_end += 1;
    } else {
      s_bot += d;
    }
  }
  if constexpr (!(F & kNoScore)) {
    if (slide_end >= 1 && slide_end == jstar) {
      // column j* was the last sliding one: row m sits at the band bottom
      s_m = s_bot;
      if (jstar < tlen && s_m <= best) {
        best = s_m;
        best_end = jstar;
      }
    }
  }
#pragma unroll 1
  for (; col <= N; ++col) {
    const uint32_t tch = tnext;
    if (col < N) tnext = static_cast<uint32_t>(__ldg(trow + col));
    const int d = column_reg<R, false, F>(vp, vn, p0, p1, p2, am, tch, 0u,
                                          mfrozen, lane);
    if constexpr (F & kNoScore) {
      best += 1;
      best_end += 1;
    } else {
      s_bot += d;
      s_m += d;
      if (col < tlen && s_m <= best) {
        best = s_m;
        best_end = col;
      }
    }
  }

  if (lane == 31) {
    // band word BW - 1 is lane 31's last
    const uint32_t acc = vp[R - 1] ^ vn[R - 1] ^ p0[R - 1] ^ p1[R - 1] ^
                         p2[R - 1] ^ am[R - 1];
    const uint32_t mix = static_cast<uint32_t>(s_bot) +
                         static_cast<uint32_t>(s_m) +
                         static_cast<uint32_t>(best) +
                         static_cast<uint32_t>(best_end) + acc;
    dist[row] = static_cast<int32_t>(mix);
    end_col[row] = best_end;
  }
}

constexpr int kMinimal =
    kNoSlide | kNoEq | kNoKs | kNoScore | kNoHshift | kNoStream2;

template <int R>
int launch(int flags, const void* vp0, const void* planes0, const void* texts,
           const void* pstream, const void* scalars, int rows, int N,
           void* dist, void* end_col, cudaStream_t stream) {
#define FLOXER_ABLATE_VARIANT(F)                                             \
  case F:                                                                    \
    ablate_banded_kernel<R, F><<<rows, 32, 0, stream>>>(                     \
        static_cast<const uint32_t*>(vp0),                                   \
        static_cast<const uint32_t*>(planes0),                               \
        static_cast<const int32_t*>(texts),                                  \
        static_cast<const int32_t*>(pstream),                                \
        static_cast<const int32_t*>(scalars), rows, N,                       \
        static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));        \
    return static_cast<int>(cudaGetLastError());
  switch (flags) {
    FLOXER_ABLATE_VARIANT(0)
    FLOXER_ABLATE_VARIANT(kRadix4)
    FLOXER_ABLATE_VARIANT(kNoKs)
    FLOXER_ABLATE_VARIANT(kNoSlide)
    FLOXER_ABLATE_VARIANT(kNoEq)
    FLOXER_ABLATE_VARIANT(kNoScore)
    FLOXER_ABLATE_VARIANT(kNoHshift)
    FLOXER_ABLATE_VARIANT(kNoStream2)
    FLOXER_ABLATE_VARIANT(kMinimal)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLOXER_ABLATE_VARIANT
}

}  // namespace

// vp0 uint32 [rows, BW], planes0 uint32 [rows, 4, BW], texts and
// pattern_stream int32 [rows, num_text], scalars int32 [rows, 6] (tlen,
// jstar, topshift, mfrozen, minit, binit) -> dist, end_col int32 [rows];
// band_words one of 128, 256, 384; flags one of the script's nine
// variants. Any other width or flags: cudaErrorInvalidValue.
extern "C" int floxer_ablate_banded(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int rows,
    int band_words, int num_text, int flags, void* dist, void* end_col,
    void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (band_words) {
    case 128:
      return launch<4>(flags, vp0, planes0, texts, pattern_stream, scalars,
                       rows, num_text, dist, end_col, s);
    case 256:
      return launch<8>(flags, vp0, planes0, texts, pattern_stream, scalars,
                       rows, num_text, dist, end_col, s);
    case 384:
      return launch<12>(flags, vp0, planes0, texts, pattern_stream, scalars,
                        rows, num_text, dist, end_col, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
