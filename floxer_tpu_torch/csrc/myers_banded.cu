// Banded sliding-window Myers/Hyyro semi-global edit distance (K1).
//
// Replaces floxer_tpu/ops/pallas_myers_banded.py::_kernel, the production
// verification kernel of PEX roots and large inner nodes. Per task: the
// minimum semi-global distance at pattern row m over end columns
// j* = m - k <= col < tlen, ties to the rightmost column, computed on a
// band of BW 32-bit words that slides one row per column until row m
// enters the band bottom (col == j*) and is frozen afterwards. The band
// algorithm and its exactness proof are in floxer_tpu/ops/myers_banded.py.
//
// What bounds it on an H100: each text column is a serial chain of 32-bit
// integer ops over the band (a multi-word add whose carry crosses every
// word, two one-bit shifts across words) fed by one 4-bit text char and
// one 4-bit pattern char. A few bytes enter per column, so memory is idle:
// the kernel is bound by int32 issue and, with one warp per task and under
// two tasks per SM at the root shape, by the latency of the per-column
// dependency chain.
//
// Two kernels here and a third in myers_banded_wide.cu compute the same
// function; the wrapper picks one by band width. The two here run one warp
// per task, so a column is one warp step with no block barrier, and lane
// l owns the contiguous band words [l*R, (l+1)*R), R = BW/32.
//
// myers_banded_reg_kernel<R> (R = 1, 2, 4, 8, 12, 16; BW up to 512 words):
// the band state (VP VN and the four char planes) lives in registers,
// x[R] per lane, indexed only by compile-time constants in unrolled loops,
// and nothing is read or written in shared memory inside the column loop.
// Per column:
//   - the slide is one funnel shift per word and array; the six boundary
//     bits of word 0 cross lanes in one packed __shfl_down_sync, and lane
//     31 takes the entering row's bits from the pattern char;
//   - the multi-word add has no serial carry chain: the carry between
//     lanes is a 32-lane carry-lookahead in one 32-bit add: with Gm and Pm
//     the ballots of the runs' generate and propagate bits (exclusive per
//     run), the carry into lane l is bit l of (A + Gm) ^ A ^ Gm,
//     A = Gm | Pm (two ballots against the eleven shuffles of a 5-round
//     scan); inside the run the same identity on R-bit masks of the
//     words' generate and propagate bits, with the lane's carry added at
//     bit 0, gives every word's carry (it replaced an in-lane ripple of
//     two to three dependent ops per word: the same function, a shorter
//     chain);
//   - the horizontal shift is one funnel shift per word plus one
//     __shfl_up_sync of the lane's top bits;
//   - the band bottom is the top bit of lane 31's last word, so lane 31
//     keeps the scores and writes the result, without a broadcast;
//   - the sliding and the frozen columns run in two loops, and the next
//     packed text and pattern words are loaded one 8-column step ahead.
//
// myers_banded_kernel (any width the register kernels do not take: past
// 2048 words, or not a 128-word tile past 512; myers_banded_wide.cu's
// multi-warp register kernel takes the 128-word tiles of 640-2048 words):
// state in shared memory, interleaved so that word i of lane l sits at
// [i*32 + l] (no bank conflicts, no lane reads another lane's words),
// which takes any band width without a template per width; the carry is a
// warp (generate, propagate) scan with __shfl_up_sync.
//
// Each task stops at its own tlen, which is what the TPU kernel's
// per-group bound computes, because only columns with col < tlen can
// improve the result.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_banded_column.cuh"

namespace {

using floxer_banded::column_reg;
using floxer_banded::kFull;
constexpr int kArrays = 9;  // VP VN P0 P1 P2 AM EQ PH MH

// Slide one band array one bit toward word 0; `entering` is the bit that
// enters at the top of the last word of this lane's run.
__device__ __forceinline__ void slide(uint32_t* x, int R, int lane,
                                      uint32_t entering) {
  uint32_t cur = x[lane];
  for (int i = 0; i < R; ++i) {
    const uint32_t next_word = (i + 1 < R) ? x[(i + 1) * 32 + lane] : 0u;
    const uint32_t next_bit = (i + 1 < R) ? (next_word & 1u) : entering;
    x[i * 32 + lane] = (cur >> 1) | (next_bit << 31);
    cur = next_word;
  }
}

__global__ void myers_banded_kernel(
    const uint32_t* __restrict__ vp0,      // [T, BW]
    const uint32_t* __restrict__ planes0,  // [T, 4, BW]
    const uint32_t* __restrict__ texts,    // [T, NW] 8 nibbles per word
    const uint32_t* __restrict__ pstream,  // [T, NW] 8 nibbles per word
    const int32_t* __restrict__ scalars,   // [T, 6]
    int T, int BW, int NW,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  extern __shared__ uint32_t smem[];
  const int task = blockIdx.x;
  const int lane = threadIdx.x;
  if (task >= T) return;
  const int R = BW / 32;
  uint32_t* VP = smem;
  uint32_t* VN = VP + BW;
  uint32_t* P0 = VN + BW;
  uint32_t* P1 = P0 + BW;
  uint32_t* P2 = P1 + BW;
  uint32_t* AM = P2 + BW;
  uint32_t* EQ = AM + BW;
  uint32_t* PH = EQ + BW;
  uint32_t* MH = PH + BW;

  const size_t row = static_cast<size_t>(task) * BW;
  const size_t prow = static_cast<size_t>(task) * 4 * BW;
  for (int i = 0; i < R; ++i) {
    const int w = lane * R + i;
    const int at = i * 32 + lane;
    VP[at] = vp0[row + w];
    VN[at] = 0u;
    P0[at] = planes0[prow + w];
    P1[at] = planes0[prow + BW + w];
    P2[at] = planes0[prow + 2 * BW + w];
    AM[at] = planes0[prow + 3 * BW + w];
  }

  const int32_t* sc = scalars + static_cast<size_t>(task) * 6;
  const int tlen = sc[0];
  const int jstar = sc[1];
  const int topshift = sc[2];
  const int mfrozen = sc[3];
  const int m = sc[4];
  const int k = sc[5];
  int s_bot = k;
  int s_m = m;
  int best = m;
  int best_end = 0;

  const uint32_t* trow = texts + static_cast<size_t>(task) * NW;
  const uint32_t* srow = pstream + static_cast<size_t>(task) * NW;
  const int last_col = min(tlen - 1, NW * 8);
  uint32_t tword = 0u, sword = 0u;

  for (int col = 1; col <= last_col; ++col) {
    const int j = col - 1;
    if ((j & 7) == 0) {
      tword = trow[j >> 3];
      sword = srow[j >> 3];
    }
    const int shift = 4 * (j & 7);
    const uint32_t tch = (tword >> shift) & 0xfu;
    const uint32_t pch = (sword >> shift) & 0xfu;
    const bool sliding = col <= jstar;

    // 1) band slide: every array moves one bit toward word 0; the row
    // entering at the bottom gets a pessimistic VP bit and the plane bits
    // of its pattern char
    if (sliding) {
      const uint32_t head = (VP[lane] & 1u) | ((VN[lane] & 1u) << 1) |
                            ((P0[lane] & 1u) << 2) | ((P1[lane] & 1u) << 3) |
                            ((P2[lane] & 1u) << 4) | ((AM[lane] & 1u) << 5);
      uint32_t nxt = __shfl_down_sync(kFull, head, 1);
      if (lane == 31) {
        nxt = 1u | ((pch & 1u) << 2) | (((pch >> 1) & 1u) << 3) |
              (((pch >> 2) & 1u) << 4);
      }
      slide(VP, R, lane, nxt & 1u);
      slide(VN, R, lane, (nxt >> 1) & 1u);
      slide(P0, R, lane, (nxt >> 2) & 1u);
      slide(P1, R, lane, (nxt >> 3) & 1u);
      slide(P2, R, lane, (nxt >> 4) & 1u);
      slide(AM, R, lane, (nxt >> 5) & 1u);
    }

    // 2) Eq from the char bit-planes, and the run's carry (G, P)
    uint32_t G = 0u, P = 1u;
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      const uint32_t m0 = (tch & 1u) ? P0[at] : ~P0[at];
      const uint32_t m1 = (tch & 2u) ? P1[at] : ~P1[at];
      const uint32_t m2 = (tch & 4u) ? P2[at] : ~P2[at];
      const uint32_t eq = (m0 & m1 & m2) | AM[at];
      EQ[at] = eq;
      const uint32_t vp = VP[at];
      const uint32_t a = eq & vp;
      const uint32_t t = a + vp;
      const uint32_t g = t < a ? 1u : 0u;
      const uint32_t p = t == kFull ? 1u : 0u;
      G = g | (p & G);
      P = P & p;
    }
    // inclusive warp scan of the runs' (G, P), then exclusive carry-in
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t g_up = __shfl_up_sync(kFull, G, d);
      const uint32_t p_up = __shfl_up_sync(kFull, P, d);
      if (lane >= d) {
        G = G | (P & g_up);
        P = P & p_up;
      }
    }
    uint32_t carry = __shfl_up_sync(kFull, G, 1);
    if (lane == 0) carry = 0u;

    // 3) the add with carries and the horizontal deltas; Xv parks in VN
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      const uint32_t vp = VP[at];
      const uint32_t vn = VN[at];
      const uint32_t eq = EQ[at];
      const uint32_t a = eq & vp;
      const uint32_t t = a + vp;
      const uint32_t g = t < a ? 1u : 0u;
      const uint32_t p = t == kFull ? 1u : 0u;
      const uint32_t sum = t + carry;
      carry = g | (p & carry);
      const uint32_t xh = (sum ^ vp) | eq;
      PH[at] = vn | ~(xh | vp);
      MH[at] = vp & xh;
      VN[at] = eq | vn;
    }

    // 4) scores: the band bottom is the top bit of the last band word
    const int last = (R - 1) * 32 + lane;
    const uint32_t top_bits = (PH[last] >> 31) | ((MH[last] >> 31) << 1);
    const uint32_t bottom = __shfl_sync(kFull, top_bits, 31);
    const int d_bot = static_cast<int>(bottom & 1u) -
                      static_cast<int>((bottom >> 1) & 1u);
    if (sliding) s_bot += 1;
    s_bot += d_bot;
    if (col == jstar) {
      s_m = s_bot;
    } else if (!sliding) {
      s_m += d_bot;
    }

    // 5) horizontal deltas shift down one row; the delta entering at word
    // 0 is +1 (pessimistic) once the top stored row is a real row
    const bool pessim = sliding ? (col >= topshift) : (mfrozen != 0);
    uint32_t hcarry = __shfl_up_sync(kFull, top_bits, 1);
    if (lane == 0) hcarry = pessim ? 1u : 0u;
    uint32_t cph = hcarry & 1u;
    uint32_t cmh = (hcarry >> 1) & 1u;
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      const uint32_t ph = PH[at];
      const uint32_t mh = MH[at];
      const uint32_t xv = VN[at];
      const uint32_t ph_sh = (ph << 1) | cph;
      const uint32_t mh_sh = (mh << 1) | cmh;
      cph = ph >> 31;
      cmh = mh >> 31;
      VP[at] = mh_sh | ~(xv | ph_sh);
      VN[at] = ph_sh & xv;
    }

    if (col >= jstar && s_m <= best) {
      best = s_m;
      best_end = col;
    }
  }
  if (lane == 0) {
    dist[task] = best;
    end_col[task] = best_end;
  }
}

// ---- register kernel -----------------------------------------------------

// Its column body is column_reg<R, kSliding> of myers_banded_column.cuh,
// which the section ablation (K5) runs too.
template <int R>
__global__ void __launch_bounds__(32) myers_banded_reg_kernel(
    const uint32_t* __restrict__ vp0,      // [T, BW]
    const uint32_t* __restrict__ planes0,  // [T, 4, BW]
    const uint32_t* __restrict__ texts,    // [T, NW] 8 nibbles per word
    const uint32_t* __restrict__ pstream,  // [T, NW] 8 nibbles per word
    const int32_t* __restrict__ scalars,   // [T, 6]
    int T, int NW,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  constexpr int BW = 32 * R;
  const int task = blockIdx.x;
  const int lane = threadIdx.x;
  if (task >= T) return;

  uint32_t vp[R], vn[R], p0[R], p1[R], p2[R], am[R];
  const size_t row = static_cast<size_t>(task) * BW + lane * R;
  const size_t prow = static_cast<size_t>(task) * 4 * BW + lane * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    vp[i] = vp0[row + i];
    vn[i] = 0u;
    p0[i] = planes0[prow + i];
    p1[i] = planes0[prow + BW + i];
    p2[i] = planes0[prow + 2 * BW + i];
    am[i] = planes0[prow + 3 * BW + i];
  }

  const int32_t* sc = scalars + static_cast<size_t>(task) * 6;
  const int tlen = sc[0];
  const int jstar = sc[1];
  const int topshift = sc[2];
  const uint32_t mfrozen = sc[3] != 0 ? 1u : 0u;
  const int m = sc[4];
  const int k = sc[5];
  int s_bot = k;
  int s_m = m;
  int best = m;
  int best_end = 0;

  const uint32_t* trow = texts + static_cast<size_t>(task) * NW;
  const uint32_t* srow = pstream + static_cast<size_t>(task) * NW;
  const int last_col = min(tlen - 1, NW * 8);
  // the band slides on columns 1..slide_end, is frozen after
  const int slide_end = min(jstar, last_col);
  uint32_t tword = 0u, sword = 0u;
  uint32_t tnext = last_col >= 1 ? __ldg(trow) : 0u;
  uint32_t snext = last_col >= 1 ? __ldg(srow) : 0u;

  int col = 1;
  for (; col <= slide_end; ++col) {
    const int j = col - 1;
    if ((j & 7) == 0) {
      tword = tnext;
      sword = snext;
      const int w = (j >> 3) + 1;
      if (w < NW) {
        tnext = __ldg(trow + w);
        snext = __ldg(srow + w);
      }
    }
    const uint32_t tch = tword & 0xfu;
    const uint32_t pch = sword & 0xfu;
    tword >>= 4;
    sword >>= 4;
    s_bot += 1 + column_reg<R, true>(vp, vn, p0, p1, p2, am, tch, pch,
                                     col >= topshift ? 1u : 0u, lane);
  }
  if (slide_end >= 1 && slide_end == jstar) {
    // column j* was the last sliding one: row m sits at the band bottom
    s_m = s_bot;
    if (s_m <= best) {
      best = s_m;
      best_end = jstar;
    }
  }
  for (; col <= last_col; ++col) {
    const int j = col - 1;
    if ((j & 7) == 0) {
      tword = tnext;
      const int w = (j >> 3) + 1;
      if (w < NW) tnext = __ldg(trow + w);
    }
    const uint32_t tch = tword & 0xfu;
    tword >>= 4;
    s_m += column_reg<R, false>(vp, vn, p0, p1, p2, am, tch, 0u, mfrozen,
                                lane);
    if (s_m <= best) {
      best = s_m;
      best_end = col;
    }
  }
  if (lane == 31) {
    dist[task] = best;
    end_col[task] = best_end;
  }
}

template <int R>
int launch_reg(const void* vp0, const void* planes0, const void* texts,
               const void* pattern_stream, const void* scalars, int T,
               int text_words, void* dist, void* end_col, void* stream) {
  myers_banded_reg_kernel<R>
      <<<T, 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(vp0),
          static_cast<const uint32_t*>(planes0),
          static_cast<const uint32_t*>(texts),
          static_cast<const uint32_t*>(pattern_stream),
          static_cast<const int32_t*>(scalars), T, text_words,
          static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int floxer_myers_banded(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
  if (band_words <= 0 || band_words % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kArrays) * band_words *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        myers_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      // refused (past the card's shared memory a block): reset the
      // runtime's last error, so the next launch does not report it
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  myers_banded_kernel<<<T, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vp0),
      static_cast<const uint32_t*>(planes0),
      static_cast<const uint32_t*>(texts),
      static_cast<const uint32_t*>(pattern_stream),
      static_cast<const int32_t*>(scalars), T, band_words, text_words,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}

// The register kernel at the instantiated widths (the cases below; the
// wrapper's REGISTER_BAND_WORDS); other widths are refused, and the
// wrapper sends them to floxer_myers_banded.
extern "C" int floxer_myers_banded_reg(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
#define FLOXER_REG_CASE(R)                                                  \
  case 32 * R:                                                              \
    return launch_reg<R>(vp0, planes0, texts, pattern_stream, scalars, T,   \
                         text_words, dist, end_col, stream);
  switch (band_words) {
    FLOXER_REG_CASE(1)
    FLOXER_REG_CASE(2)
    FLOXER_REG_CASE(4)
    FLOXER_REG_CASE(8)
    FLOXER_REG_CASE(12)
    FLOXER_REG_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLOXER_REG_CASE
}
