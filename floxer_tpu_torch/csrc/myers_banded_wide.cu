// Banded sliding-window Myers (K1) on bands wider than one warp holds in
// registers: myers_banded_wide_kernel.
//
// Replaces, beside myers_banded.cu, floxer_tpu/ops/pallas_myers_banded.py::
// _kernel: the same function on the same operands ((dist, end) per task,
// ties to the rightmost column, each task stopping at its own tlen).
//
// What bounds it on an H100: as in myers_banded.cu, the per-column chain
// of int32 ops over the band. One warp's chain grows with its R words per
// lane, and at R = 16 (512 words) the one-warp register kernel already
// holds 155 registers, so long reads' bands (640-2048 words: 20-64 kb
// windows at 15% error) went to the shared-memory kernel, which walks each
// lane's words through shared memory three times per column.
//
// Layout: one block of W = BW / (32 R) warps per task, R = kWordsPerLane;
// lane l of warp w owns the band words [(32w + l) R, (32w + l + 1) R) in
// registers (x[R] per array, compile-time indices). Inside a warp a column
// is the register kernel's (funnel-shift slide, Eq from the char planes,
// the carry from two ballots in one add, funnel-shift horizontal shift).
// The warps meet where that column uses lane 0 or lane 31 as the end of
// the band:
//   - carry: each warp publishes its (G, P), the carry out of its words
//     with carry-in 0 and whether every word propagates; lane l of every
//     warp reads warp l's pair and two ballots give W-bit masks, so the
//     carry into warp w is bit w of (A + Gw) ^ A ^ Gw, A = Gw | Pw, the
//     same lookahead as across lanes;
//   - horizontal shift: lane 0 of warp w takes the top Ph and Mh bits of
//     lane 31 of warp w - 1 (warp 0: the pessimistic +1 as before);
//   - slide: lane 31 of warp w takes the bit-0 head of lane 0 of warp
//     w + 1 as that word holds it after the previous column; its VP and VN
//     bits follow from warp w's own top bits and warp w + 1's published Xv
//     bit of word 0 (Vp = Mh' | ~(Xv | Ph'), Vn = Ph' & Xv at bit 0), its
//     char-plane bits are published as they are. The top warp's lane 31
//     takes the pattern char;
//   - score: the top warp's lane 31 holds the band bottom, keeps the
//     scores and writes the result.
// The published words are double-buffered by column parity in shared
// memory. A column exchanges in lockstep: the (G, P) words (each lane has
// its run's carries for carry-in 0 and 1 into its warp ready), a barrier,
// the carries and the deltas, the top bits, a second barrier. On an H100
// this measured faster than publishing both carry-ins' top bits for one
// barrier (carry-select), and R = 4 faster than R = 2 or 8, at 640 and
// 1024 words.
//
// W comes from blockDim: the kernel takes every band of a multiple of
// 32 R words up to 2048 (the C entry point checks).

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

// What each warp publishes for one column, at the column's parity.
struct Exchange {
  // lane 0 of warp w: bit 0 G, bit 1 P, bit 2 bit 0 of Xv = Eq | Vn of
  // the warp's word 0, bits 3-6 bit 0 of that word's P0, P1, P2, AM
  uint32_t low[2][kMaxWarps];
  // lane 31 of warp w: the top bits (bit 0 Ph, bit 1 Mh) of the warp's
  // last word
  uint32_t top[2][kMaxWarps];
};

// One text column of one warp's words. `head` holds lane 31's entering
// bits for this column's slide and returns those of the next (in every
// warp but the top one, whose caller sets the pattern char's). Returns
// the score delta at the band bottom (meaningful in lane 31 of the top
// warp only).
template <int R, bool kSliding>
__device__ __forceinline__ int column_wide(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t tch,
    uint32_t& head, uint32_t pessim, int lane, int warp, int warps,
    uint32_t* low, uint32_t* top_words) {
  // 1) band slide; lane 31 takes the head of the warp above
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

  // 2) Eq, each word's add without its carry-in, and the run's generate
  // and propagate masks (the register kernel's)
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
  // the lanes' carries if 0 or 1 enters the warp's word 0, and bit i of
  // runs0 / runs1 the carry into this lane's word i in either case
  const uint32_t in0 = (((any + gm) ^ any ^ gm) >> lane) & 1u;
  const uint32_t in1 = (((any + gm + 1u) ^ any ^ gm) >> lane) & 1u;
  const uint32_t runs0 = (any_run + gen_run + in0) ^ any_run ^ gen_run;
  const uint32_t runs1 = (any_run + gen_run + in1) ^ any_run ^ gen_run;
  if (lane == 0) {
    const uint32_t g = static_cast<uint32_t>(
        (static_cast<uint64_t>(any) + gm) >> 32);
    low[warp] = g | ((pm == kFull ? 1u : 0u) << 1) |
                (((eq[0] | vn[0]) & 1u) << 2) |
                (head_bits(0u, 0u, p0[0], p1[0], p2[0], am[0]) << 1);
  }
  __syncthreads();

  // 3) the carry into each warp from the warps' (G, P) in one add
  const uint32_t word = lane < warps ? low[lane] : 0u;
  const uint32_t above = low[warp + 1 < warps ? warp + 1 : warp];
  const uint32_t gw = __ballot_sync(kFull, word & 1u);
  const uint32_t aw = gw | __ballot_sync(kFull, (word >> 1) & 1u);
  const uint32_t warp_carries = (aw + gw) ^ aw ^ gw;
  const uint32_t runs = ((warp_carries >> warp) & 1u) ? runs1 : runs0;

  // 4) the add with carries and the horizontal deltas; Xv parks in vn
  uint32_t ph[R], mh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t xh = ((t[i] + ((runs >> i) & 1u)) ^ vp[i]) | eq[i];
    ph[i] = vn[i] | ~(xh | vp[i]);
    mh[i] = vp[i] & xh;
    vn[i] = eq[i] | vn[i];
  }
  const uint32_t top = (ph[R - 1] >> 31) | ((mh[R - 1] >> 31) << 1);

  // 5) horizontal deltas shift up one row; lane 0 takes the top bits of
  // the warp below (warp 0 the pessimistic delta)
  if (lane == 31) top_words[warp] = top;
  __syncthreads();
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

  // 6) lane 31's head for the next slide: bit 0 of the word 0 of the warp
  // above after this column, whose Ph' and Mh' bit 0 are this lane's top
  if (kSliding) {
    const uint32_t ph_top = top & 1u;
    const uint32_t mh_top = top >> 1;
    const uint32_t xv = (above >> 2) & 1u;
    head = ((mh_top | ~(xv | ph_top)) & 1u) | ((ph_top & xv) << 1) |
           (((above >> 3) & 15u) << 2);
  }
  // 7) the score delta at the band bottom: the top bit of the last word
  return static_cast<int>(top & 1u) - static_cast<int>(top >> 1);
}

__global__ void __launch_bounds__(32 * kMaxWarps) myers_banded_wide_kernel(
    const uint32_t* __restrict__ vp0,      // [T, BW]
    const uint32_t* __restrict__ planes0,  // [T, 4, BW]
    const uint32_t* __restrict__ texts,    // [T, NW] 8 nibbles a word
    const uint32_t* __restrict__ pstream,  // [T, NW] 8 nibbles a word
    const int32_t* __restrict__ scalars,   // [T, 6]
    int NW, int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
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
  // lane 31's head for the first slide: the initial word 0 of the warp
  // above (VN starts at 0)
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
    if (top_warp) head = 1u | ((sword & 7u) << 2);
    tword >>= 4;
    sword >>= 4;
    s_bot += 1 + column_wide<R, true>(
                     vp, vn, p0, p1, p2, am, tch, head,
                     col >= topshift ? 1u : 0u, lane, warp, warps,
                     ex.low[col & 1], ex.top[col & 1]);
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
    s_m += column_wide<R, false>(
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

}  // namespace

// The multi-warp kernel on a band of a multiple of 32 kWordsPerLane words
// up to 2048, in band_words / (32 kWordsPerLane) warps; any other width is
// refused.
extern "C" int floxer_myers_banded_wide(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
  if (band_words <= 0 || band_words > kMaxBandWords ||
      band_words % (32 * kWordsPerLane) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  myers_banded_wide_kernel<<<T, band_words / kWordsPerLane, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vp0),
      static_cast<const uint32_t*>(planes0),
      static_cast<const uint32_t*>(texts),
      static_cast<const uint32_t*>(pattern_stream),
      static_cast<const int32_t*>(scalars), text_words,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}
