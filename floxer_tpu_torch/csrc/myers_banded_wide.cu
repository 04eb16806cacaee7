// Banded sliding-window Myers (K1) on bands wider than one warp holds in
// registers: myers_banded_wide_kernel<R>.
//
// Replaces, beside myers_banded.cu, floxer_tpu/ops/pallas_myers_banded.py::
// _kernel: the same function on the same operands ((dist, end) per task,
// ties to the rightmost column, each task stopping at its own tlen).
//
// What bounds it on an H100: as in myers_banded.cu, the per-column chain
// of int32 ops over the band; long reads' bands (640-2048 words: 20-64 kb
// windows at 15% error) take several warps a task, and one task a block
// leaves a warp's column issue-bound on its SM sub-partition: a column
// costs its warps' instructions on one sub-partition, most of them the
// lane's fixed work (ballots, shuffles, the run's carries, the exchange)
// beside R words of the function's.
//
// Layout: one block of W warps a task, R words a lane (BW = 32 R W): lane
// l of warp w owns the band words [(32w + l) R, (32w + l + 1) R) in
// registers (x[R] per array, compile-time indices). Inside a warp a column
// is the register kernel's (Eq from the char planes, the carry from two
// ballots in one add). The warps meet where that column uses lane 0 or
// lane 31 as the end of the band, and each warp publishes one word a
// column for the others: bit 0 G, bit 1 P (the carry out of its words
// with carry-in 0 and whether every word propagates), bit 2 bit 0 of Xv =
// Eq | Vn of its word 0, bits 3-6 bit 0 of that word's P0, P1, P2, AM,
// bits 7-8 the top Ph and Mh bits of its last word if 0 enters the warp,
// bits 9-10 if 1 does (carry-select: each lane has its run's carries for
// either carry-in). Warp w reads:
//   - carry: the (G, P) bits of the warps below it, lane l those of warp
//     l; two ballots give W-bit masks, and the carry into warp w is bit w
//     of (A + Gw) ^ A ^ Gw, A = Gw | Pw, the same lookahead as across
//     lanes;
//   - slide: lane 31 takes warp w + 1's Xv and plane bits of its word 0
//     (the top warp's lane 31 takes the pattern char);
//   - horizontal shift (frozen columns and the last sliding one): lane 0
//     takes the top bits of warp w - 1 for the carry into it, bit w - 1 of
//     the same add (warp 0: the pessimistic +1);
//   - score: the top warp's lane 31 holds the band bottom, keeps the
//     scores and writes the result.
//
// The merged slide: a sliding column is followed by a slide, and the
// slide undoes the horizontal shift: the next column's Vp at row p is
// Mh[p] | ~(Xv[p + 1] | Ph[p]) and its Vn is Ph[p] & Xv[p + 1], the
// pessimistic delta shifted into row 0 being slid out. So every sliding
// column but the last writes the next column's state already slid, and
// what crosses lanes or warps for it, Xv and the char planes, is known
// before the column's carry: no shuffle or funnel shift of Ph, Mh, Vp or
// Vn stays on the column's chain (the first slide runs alone before the
// loop, the last sliding column and the frozen ones shift as before).
//
// The exchange has no block-wide barrier: lane 31 stores the warp's word
// into the column's slot of a ring in shared memory and arrives on the
// slot's mbarrier (W arrivals a phase), the warp then does the slide's
// part that needs no other warp, and only then waits on the slot
// (mbarrier.try_wait.parity) and reads the words. Every warp waits for
// every word of a column before it publishes the next, so a ring of two
// slots is never overwritten before its readers are done, and no
// barrier runs a phase ahead of its waiters.
//
// W = 4 warps, one on each of an SM's sub-partitions, of R = band_words /
// 128 words a lane (1-16, an instance each): on an H100 one warp a
// sub-partition with 2-4 times the words ran a column faster than 8-16
// warps of 4 words, whose issue the sub-partitions share (and faster than
// 2 warps of 8-16 words, whose chain has no other warp to hide behind).

#include <cstdint>
#include <cuda_runtime.h>

#include <utility>

#include "myers_banded_column.cuh"

namespace {

using floxer_banded::head_bits;
using floxer_banded::kFull;
using floxer_banded::or_tree;
using floxer_banded::slide_reg;

constexpr int kMaxBandWords = 2048;
// the warps of a task, and the band words they hold at one word a lane
constexpr int kWarps = 4;
constexpr int kTileWords = 32 * kWarps;
constexpr int kMaxWords = kMaxBandWords / kTileWords;
constexpr int kRing = 2;

// The ring: a slot per column parity, each warp's word, and the slot's
// barrier (one arrival a warp).
struct Ring {
  uint64_t bars[kRing];
  uint32_t words[kRing][kWarps];
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival (release: the stores before it are seen by the waiters).
__device__ __forceinline__ void barrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Until the barrier's phase of `parity` has completed (acquire).
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The top bits (bit 0 Ph, bit 1 Mh) of a lane's last word, whose add
// takes carry `carry`.
template <int R>
__device__ __forceinline__ uint32_t top_bits(const uint32_t (&eq)[R],
                                             const uint32_t (&vp)[R],
                                             const uint32_t (&vn)[R],
                                             const uint32_t (&t)[R],
                                             uint32_t carry) {
  const uint32_t xh = ((t[R - 1] + carry) ^ vp[R - 1]) | eq[R - 1];
  const uint32_t ph = vn[R - 1] | ~(xh | vp[R - 1]);
  const uint32_t mh = vp[R - 1] & xh;
  return (ph >> 31) | ((mh >> 31) << 1);
}

// The band slide at the start of a column: every array moves one bit
// toward word 0; lane 31 takes `head` (the warp above's word-0 bits, or
// the pattern char's in the top warp).
template <int R>
__device__ __forceinline__ void slide_band(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t head,
    int lane) {
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

// One text column (column j + 1 of the task) of one warp's words, on the
// state as it is (slid already where the column slides). kMerged: a
// sliding column followed by another; it writes the next column's state
// slid, `pch` is the pattern char entering there and `force` bit 31 in
// the top warp's lane 31 (its entering row's Vp is 1, its Vn 0).
// Otherwise it writes Vp, Vn shifted, `pessim` entering warp 0's row 0.
// Returns the score delta at the band bottom (meaningful in lane 31 of the
// top warp only).
template <int R, bool kMerged>
__device__ __forceinline__ int column_wide(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t tch,
    uint32_t pch, uint32_t force, uint32_t pessim, int lane, int warp,
    int j, Ring& ring) {
  const int slot = j & (kRing - 1);
  const uint32_t parity = static_cast<uint32_t>(j / kRing) & 1u;

  // 1) Eq, Xv, each word's add without its carry-in, and the run's
  // generate and propagate masks (the register kernel's)
  const uint32_t x0 = (tch & 1u) ? 0u : kFull;
  const uint32_t x1 = (tch & 2u) ? 0u : kFull;
  const uint32_t x2 = (tch & 4u) ? 0u : kFull;
  uint32_t eq[R], xv[R], t[R], gen[R], prop[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    eq[i] = ((p0[i] ^ x0) & (p1[i] ^ x1) & (p2[i] ^ x2)) | am[i];
    xv[i] = eq[i] | vn[i];
    const uint32_t a = eq[i] & vp[i];
    t[i] = a + vp[i];
    gen[i] = (t[i] < a ? 1u : 0u) << i;
    prop[i] = (t[i] == kFull ? 1u : 0u) << i;
  }
  // each lane's Xv and plane bits of its word 0 (lane 0's go into the
  // warp's word, the others to the lane below in the merged slide)
  const uint32_t bits0 = ((xv[0] & 1u) << 2) |
                         (head_bits(0u, 0u, p0[0], p1[0], p2[0], am[0]) << 1);
  const uint32_t low = __shfl_sync(kFull, bits0, 0);
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

  // 2) publish: lane 31 stores the warp's word and arrives (the top bits
  // for either carry only where the warp above shifts them in)
  if (lane == 31) {
    uint32_t tops = 0u;
    if constexpr (!kMerged) {
      tops = top_bits<R>(eq, vp, vn, t, (runs0 >> (R - 1)) & 1u) << 7 |
             top_bits<R>(eq, vp, vn, t, (runs1 >> (R - 1)) & 1u) << 9;
    }
    const uint32_t g = static_cast<uint32_t>(
        (static_cast<uint64_t>(any) + gm) >> 32);
    ring.words[slot][warp] = g | ((pm == kFull ? 1u : 0u) << 1) | low | tops;
    barrier_arrive(shared_address(&ring.bars[slot]));
  }

  // 3) the merged slide's part that needs no other warp: Xv and the
  // planes one bit toward word 0, lane l taking lane l + 1's word-0 bits
  // (lane 31's last word waits for the warp above's)
  uint32_t enter = 0u;
  if constexpr (kMerged) {
    enter = __shfl_down_sync(kFull, bits0, 1);
#pragma unroll
    for (int i = 0; i < R - 1; ++i) {
      xv[i] = __funnelshift_r(xv[i], xv[i + 1], 1);
      p0[i] = __funnelshift_r(p0[i], p0[i + 1], 1);
      p1[i] = __funnelshift_r(p1[i], p1[i + 1], 1);
      p2[i] = __funnelshift_r(p2[i], p2[i + 1], 1);
      am[i] = __funnelshift_r(am[i], am[i + 1], 1);
    }
  }

  // 4) wait for the column's words; lane l reads warp l's (the warps
  // below this one and the one above), then the carries into this warp
  // and the one below in one add
  barrier_wait(shared_address(&ring.bars[slot]), parity);
  const bool reads = lane < warp || (lane == warp + 1 && lane < kWarps);
  const uint32_t word = reads ? ring.words[slot][lane] : 0u;
  const uint32_t gw = __ballot_sync(kFull, lane < warp && (word & 1u));
  const uint32_t aw =
      gw | __ballot_sync(kFull, lane < warp && ((word >> 1) & 1u));
  const uint32_t carries = (aw + gw) ^ aw ^ gw;
  const bool carry_in = ((carries >> warp) & 1u) != 0u;

  // 5) the add with its carries and the horizontal deltas
  const uint32_t runs = carry_in ? runs1 : runs0;
  uint32_t ph[R], mh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t xh = ((t[i] + ((runs >> i) & 1u)) ^ vp[i]) | eq[i];
    ph[i] = vn[i] | ~(xh | vp[i]);
    mh[i] = vp[i] & xh;
  }
  const uint32_t top = (ph[R - 1] >> 31) | ((mh[R - 1] >> 31) << 1);

  if constexpr (kMerged) {
    // 6) the next column's state, slid: Vp' = Mh | ~(Xv' | Ph), Vn' = Ph
    // & Xv', the planes slid; lane 31 takes the warp above's word-0 bits,
    // the top warp's the pattern char's (Vp 1 and Vn 0 by `force`)
    if (lane == 31) {
      enter = warp + 1 < kWarps ? ring.words[slot][warp + 1]
                                : (pch & 7u) << 3;
    }
    xv[R - 1] = __funnelshift_r(xv[R - 1], enter >> 2, 1);
    p0[R - 1] = __funnelshift_r(p0[R - 1], enter >> 3, 1);
    p1[R - 1] = __funnelshift_r(p1[R - 1], enter >> 4, 1);
    p2[R - 1] = __funnelshift_r(p2[R - 1], enter >> 5, 1);
    am[R - 1] = __funnelshift_r(am[R - 1], enter >> 6, 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      vp[i] = mh[i] | ~(xv[i] | ph[i]);
      vn[i] = ph[i] & xv[i];
    }
    vp[R - 1] |= force;
    vn[R - 1] &= ~force;
  } else {
    // 6) horizontal deltas shift up one row; lane 0 takes the top bits of
    // the warp below for the carry into it (warp 0 the pessimistic delta)
    const uint32_t below =
        warp > 0 ? (ring.words[slot][warp > 0 ? warp - 1 : 0] >>
                    (((carries >> (warp - 1)) & 1u) ? 9 : 7)) & 3u
                 : pessim;
    uint32_t hcarry = __shfl_up_sync(kFull, top, 1);
    if (lane == 0) hcarry = below;
    const uint32_t ph_sh0 = (ph[0] << 1) | (hcarry & 1u);
    const uint32_t mh_sh0 = (mh[0] << 1) | ((hcarry >> 1) & 1u);
    vp[0] = mh_sh0 | ~(xv[0] | ph_sh0);
    vn[0] = ph_sh0 & xv[0];
#pragma unroll
    for (int i = 1; i < R; ++i) {
      const uint32_t ph_sh = __funnelshift_l(ph[i - 1], ph[i], 1);
      const uint32_t mh_sh = __funnelshift_l(mh[i - 1], mh[i], 1);
      vp[i] = mh_sh | ~(xv[i] | ph_sh);
      vn[i] = ph_sh & xv[i];
    }
  }
  // 7) the score delta at the band bottom: the top bit of the last word
  return static_cast<int>(top & 1u) - static_cast<int>(top >> 1);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps, 1) myers_banded_wide_kernel(
    const uint32_t* __restrict__ vp0,      // [T, BW]
    const uint32_t* __restrict__ planes0,  // [T, 4, BW]
    const uint32_t* __restrict__ texts,    // [T, NW] 8 nibbles a word
    const uint32_t* __restrict__ pstream,  // [T, NW] 8 nibbles a word
    const int32_t* __restrict__ scalars,   // [T, 6]
    int NW, int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  __shared__ Ring ring;
  const int task = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int BW = 32 * R * kWarps;
  const bool top_warp = warp == kWarps - 1;
  const uint32_t force = top_warp && lane == 31 ? 1u << 31 : 0u;

  // the ring's barriers: a phase is a column's W arrivals
  if (threadIdx.x < kRing) {
    barrier_init(shared_address(&ring.bars[threadIdx.x]), kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

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
  if (slide_end >= 1) {
    // the first column's slide, alone: lane 31 takes the initial word 0 of
    // the warp above (VN starts at 0), the top warp's the pattern char
    uint32_t head = 1u | ((snext & 7u) << 2);
    if (!top_warp) {
      const size_t up = static_cast<size_t>(task) * BW + 32 * (warp + 1) * R;
      const size_t pup =
          static_cast<size_t>(task) * 4 * BW + 32 * (warp + 1) * R;
      head = head_bits(vp0[up], 0u, planes0[pup], planes0[pup + BW],
                       planes0[pup + 2 * BW], planes0[pup + 3 * BW]);
    }
    slide_band<R>(vp, vn, p0, p1, p2, am, head, lane);
  }
  // every sliding column but the last writes the next one's state slid
  for (; col < slide_end; ++col) {
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
    tword >>= 4;
    sword >>= 4;
    // the pattern char entering at column col + 1
    const uint32_t pch = ((j + 1) & 7) != 0 ? sword : snext;
    s_bot += 1 + column_wide<R, true>(vp, vn, p0, p1, p2, am, tch, pch,
                                      force, 0u, lane, warp, j, ring);
  }
  if (col == slide_end) {
    // the last sliding column (already slid), shifted as a frozen one
    const int j = col - 1;
    if ((j & 7) == 0) {
      tword = tnext;
      const int w = (j >> 3) + 1;
      if (w < NW) tnext = __ldg(trow + w);
    }
    const uint32_t tch = tword & 0xfu;
    tword >>= 4;
    s_bot += 1 + column_wide<R, false>(vp, vn, p0, p1, p2, am, tch, 0u, 0u,
                                       col >= topshift ? 1u : 0u, lane,
                                       warp, j, ring);
    ++col;
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
    s_m += column_wide<R, false>(vp, vn, p0, p1, p2, am, tch, 0u, 0u,
                                 mfrozen, lane, warp, j, ring);
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

// The instance of `words_per_lane` (1..kMaxWords) words a lane.
template <int... Rs>
Kernel kernel_of(int words_per_lane, std::integer_sequence<int, Rs...>) {
  Kernel kernel = nullptr;
  ((kernel = words_per_lane == Rs + 1 ? myers_banded_wide_kernel<Rs + 1>
                                      : kernel),
   ...);
  return kernel;
}

}  // namespace

// The multi-warp kernel on a band of a multiple of kTileWords words up to
// kMaxBandWords: kWarps warps of band_words / kTileWords words a lane; any
// other width is refused.
extern "C" int floxer_myers_banded_wide(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
  if (band_words <= 0 || band_words > kMaxBandWords ||
      band_words % kTileWords != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = kernel_of(band_words / kTileWords,
                                  std::make_integer_sequence<int, kMaxWords>{});
  kernel<<<T, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vp0),
      static_cast<const uint32_t*>(planes0),
      static_cast<const uint32_t*>(texts),
      static_cast<const uint32_t*>(pattern_stream),
      static_cast<const int32_t*>(scalars), text_words,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}
