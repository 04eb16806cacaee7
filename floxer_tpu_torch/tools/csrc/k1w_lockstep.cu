// The lockstep multi-warp K1 column (two block barriers a column), kept
// for tools/k1_bench.py --price alone: it prices the parts of that column
// by dropping each one, and runs the whole column as the yardstick of
// csrc/myers_banded_wide.cu's barrier-free exchange in the same build.
// Nothing of the aligner launches it; it builds into its own library
// (ops/_build.BENCH), only when the bench asks for it.
//
// myers_banded_wide_lockstep<F>: one block of BW / 128 warps a task, 4
// band words a lane in registers, the warps meeting twice a column:
//   - each warp publishes its (G, P) and the slide bits of its word 0 in
//     shared memory, a block barrier (barrier 1), every warp reads the
//     warps' words for the carry lookahead and the head of the warp above;
//   - each warp publishes the top Ph and Mh bits of its last word, a
//     block barrier (barrier 2), lane 0 reads those of the warp below for
//     the horizontal shift.
// The published words are double-buffered by column parity. F = 0 is that
// column whole (the same function as the aligner's kernel); each other bit
// of F drops one part of it, and the results are then wrong by design:
// only the time a column takes matters.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_banded_column.cuh"

namespace {

using floxer_banded::head_bits;
using floxer_banded::kFull;
using floxer_banded::or_tree;
using floxer_banded::slide_reg;

constexpr int kWordsPerLane = 4;
constexpr int kMaxBandWords = 2048;
constexpr int kMaxWarps = kMaxBandWords / (32 * kWordsPerLane);

// The parts of the column a variant drops, one bit each of F.
enum Dropped : int {
  kNoBarrier1 = 1,  // the block barrier after the (G, P) words
  kNoBarrier2 = 2,  // the block barrier after the top bits
  kNoStores = 4,    // both shared-memory stores of the exchange
};

struct Exchange {
  uint32_t low[2][kMaxWarps];
  uint32_t top[2][kMaxWarps];
};

template <int R, bool kSliding, int F>
__device__ __forceinline__ int column_lockstep(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t tch,
    uint32_t& head, uint32_t pessim, int lane, int warp, int warps,
    uint32_t* low, uint32_t* top_words) {
  if (kSliding) {
    uint32_t nxt = __shfl_down_sync(
        kFull, head_bits(vp[0], vn[0], p0[0], p1[0], p2[0], am[0]), 1);
    if (lane == 31) nxt = head;
    slide_reg<R>(vp, nxt);
    slide_reg<R>(vn, nxt >> 1);
    slide_reg<R>(p0, nxt >> 2);
    slide_reg<R>(p1, nxt >> 3);
    slide_reg<R>(p2, nxt >> 4);
    slide_reg<R>(am, nxt >> 5);
  }
  const uint32_t x0 = (tch & 1u) ? 0u : kFull;
  const uint32_t x1 = (tch & 2u) ? 0u : kFull;
  const uint32_t x2 = (tch & 4u) ? 0u : kFull;
  uint32_t eq[R], t[R], gen[R], prop[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    eq[i] = ((p0[i] ^ x0) & (p1[i] ^ x1) & (p2[i] ^ x2)) | am[i];
    const uint32_t a = eq[i] & vp[i];
    t[i] = a + vp[i];
    gen[i] = (t[i] < a ? 1u : 0u) << i;
    prop[i] = (t[i] == kFull ? 1u : 0u) << i;
  }
  const uint32_t gen_run = or_tree<R>(gen);
  const uint32_t prop_run = or_tree<R>(prop);
  const uint32_t any_run = gen_run | prop_run;
  const uint32_t gm = __ballot_sync(kFull, ((any_run + gen_run) >> R) != 0u);
  const uint32_t pm = __ballot_sync(kFull, prop_run == (1u << R) - 1u);
  const uint32_t any = gm | pm;
  const uint32_t in0 = (((any + gm) ^ any ^ gm) >> lane) & 1u;
  const uint32_t in1 = (((any + gm + 1u) ^ any ^ gm) >> lane) & 1u;
  const uint32_t runs0 = (any_run + gen_run + in0) ^ any_run ^ gen_run;
  const uint32_t runs1 = (any_run + gen_run + in1) ^ any_run ^ gen_run;
  if (!(F & kNoStores) && lane == 0) {
    const uint32_t g = static_cast<uint32_t>(
        (static_cast<uint64_t>(any) + gm) >> 32);
    low[warp] = g | ((pm == kFull ? 1u : 0u) << 1) |
                (((eq[0] | vn[0]) & 1u) << 2) |
                (head_bits(0u, 0u, p0[0], p1[0], p2[0], am[0]) << 1);
  }
  if constexpr (!(F & kNoBarrier1)) __syncthreads();

  const uint32_t word = lane < warps ? low[lane] : 0u;
  const uint32_t above = low[warp + 1 < warps ? warp + 1 : warp];
  const uint32_t gw = __ballot_sync(kFull, word & 1u);
  const uint32_t aw = gw | __ballot_sync(kFull, (word >> 1) & 1u);
  const uint32_t warp_carries = (aw + gw) ^ aw ^ gw;
  const uint32_t runs = ((warp_carries >> warp) & 1u) ? runs1 : runs0;

  uint32_t ph[R], mh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t xh = ((t[i] + ((runs >> i) & 1u)) ^ vp[i]) | eq[i];
    ph[i] = vn[i] | ~(xh | vp[i]);
    mh[i] = vp[i] & xh;
    vn[i] = eq[i] | vn[i];
  }
  const uint32_t top = (ph[R - 1] >> 31) | ((mh[R - 1] >> 31) << 1);

  if (!(F & kNoStores) && lane == 31) top_words[warp] = top;
  if constexpr (!(F & kNoBarrier2)) __syncthreads();
  const uint32_t below = warp > 0 ? top_words[warp - 1] : pessim;
  uint32_t hcarry = __shfl_up_sync(kFull, top, 1);
  if (lane == 0) hcarry = below;
  const uint32_t ph_sh0 = (ph[0] << 1) | (hcarry & 1u);
  const uint32_t mh_sh0 = (mh[0] << 1) | ((hcarry >> 1) & 1u);
  vp[0] = mh_sh0 | ~(vn[0] | ph_sh0);
  vn[0] = ph_sh0 & vn[0];
#pragma unroll
  for (int i = 1; i < R; ++i) {
    const uint32_t ph_sh = __funnelshift_l(ph[i - 1], ph[i], 1);
    const uint32_t mh_sh = __funnelshift_l(mh[i - 1], mh[i], 1);
    vp[i] = mh_sh | ~(vn[i] | ph_sh);
    vn[i] = ph_sh & vn[i];
  }
  if (kSliding) {
    const uint32_t ph_top = top & 1u;
    const uint32_t mh_top = top >> 1;
    const uint32_t xv = (above >> 2) & 1u;
    head = ((mh_top | ~(xv | ph_top)) & 1u) | ((ph_top & xv) << 1) |
           (((above >> 3) & 15u) << 2);
  }
  return static_cast<int>(top & 1u) - static_cast<int>(top >> 1);
}

template <int F>
__global__ void __launch_bounds__(32 * kMaxWarps) myers_banded_wide_lockstep(
    const uint32_t* __restrict__ vp0, const uint32_t* __restrict__ planes0,
    const uint32_t* __restrict__ texts, const uint32_t* __restrict__ pstream,
    const int32_t* __restrict__ scalars, int NW, int32_t* __restrict__ dist,
    int32_t* __restrict__ end_col) {
  constexpr int R = kWordsPerLane;
  __shared__ Exchange ex;
  const int task = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int BW = 32 * R * warps;
  const bool top_warp = warp == warps - 1;

  uint32_t vp[R], vn[R], p0[R], p1[R], p2[R], am[R];
  const size_t row = static_cast<size_t>(task) * BW + (32 * warp + lane) * R;
  const size_t prow =
      static_cast<size_t>(task) * 4 * BW + (32 * warp + lane) * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    vp[i] = vp0[row + i];
    vn[i] = 0u;
    p0[i] = planes0[prow + i];
    p1[i] = planes0[prow + BW + i];
    p2[i] = planes0[prow + 2 * BW + i];
    am[i] = planes0[prow + 3 * BW + i];
  }
  uint32_t head = 0u;
  if (!top_warp) {
    const size_t up = static_cast<size_t>(task) * BW + 32 * (warp + 1) * R;
    const size_t pup =
        static_cast<size_t>(task) * 4 * BW + 32 * (warp + 1) * R;
    head = head_bits(vp0[up], 0u, planes0[pup], planes0[pup + BW],
                     planes0[pup + 2 * BW], planes0[pup + 3 * BW]);
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
    if (top_warp) head = 1u | ((sword & 7u) << 2);
    tword >>= 4;
    sword >>= 4;
    s_bot += 1 + column_lockstep<R, true, F>(
                     vp, vn, p0, p1, p2, am, tch, head,
                     col >= topshift ? 1u : 0u, lane, warp, warps,
                     ex.low[col & 1], ex.top[col & 1]);
  }
  if (slide_end >= 1 && slide_end == jstar) {
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
    s_m += column_lockstep<R, false, F>(
        vp, vn, p0, p1, p2, am, tch, head, mfrozen, lane, warp, warps,
        ex.low[col & 1], ex.top[col & 1]);
    if (s_m <= best) {
      best = s_m;
      best_end = col;
    }
  }
  if (top_warp && lane == 31) {
    dist[task] = best;
    end_col[task] = best_end;
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*,
                        const uint32_t*, const int32_t*, int, int32_t*,
                        int32_t*);

Kernel kernel_for(int dropped) {
  switch (dropped) {
    case 0: return myers_banded_wide_lockstep<0>;
    case kNoBarrier1: return myers_banded_wide_lockstep<kNoBarrier1>;
    case kNoBarrier2: return myers_banded_wide_lockstep<kNoBarrier2>;
    case kNoBarrier1 | kNoBarrier2:
      return myers_banded_wide_lockstep<kNoBarrier1 | kNoBarrier2>;
    case kNoStores: return myers_banded_wide_lockstep<kNoStores>;
    default: return nullptr;
  }
}

}  // namespace

// The lockstep column on a band of a multiple of 128 words up to 2048,
// with the parts in `dropped` (Dropped bits: 0, 1, 2, 3 or 4) left out;
// any other width or variant is refused.
extern "C" int floxer_wide_lockstep(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, int dropped, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
  const Kernel kernel = kernel_for(dropped);
  if (kernel == nullptr || band_words <= 0 || band_words > kMaxBandWords ||
      band_words % (32 * kWordsPerLane) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<T, band_words / kWordsPerLane, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vp0),
      static_cast<const uint32_t*>(planes0),
      static_cast<const uint32_t*>(texts),
      static_cast<const uint32_t*>(pattern_stream),
      static_cast<const int32_t*>(scalars), text_words,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}
