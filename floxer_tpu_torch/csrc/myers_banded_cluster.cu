// Banded sliding-window Myers (K1) on bands past the one-block multi-warp
// kernel's widest: myers_banded_cluster_kernel<Q>, a thread-block cluster
// a task.
//
// Replaces, beside myers_banded.cu and myers_banded_wide.cu,
// floxer_tpu/ops/pallas_myers_banded.py::_kernel: the same function on the
// same operands ((dist, end) per task, ties to the rightmost column, each
// task stopping at its own tlen).
//
// What bounds it on an H100: as in myers_banded.cu, the per-column chain
// of int32 ops over the band. Bands past 2048 words (root windows of
// reads near the aligner's 100 kb limit at 15% error that merge, or a
// larger error rate or verification margin) went to the shared-memory
// kernel, one warp a task walking each lane's BW / 32 words through
// shared memory three times a column (5-16 us a column at 1024-3200
// words), and past 6456 words its nine arrays no longer fit a block's
// 232,448 bytes of shared memory, so it could not launch at all.
//
// Layout: myers_banded_wide.cu's column on a cluster of C blocks of Wb
// warps a task (C <= 8, a portable cluster; Wb <= 16). Warp g = Wb r + w
// (block rank r, warp w of the block) of the cluster holds the band words
// [128 g, 128 g + 128), 4 a lane in registers, as warp g of the one-block
// kernel; the W = BW / 128 warps fill the blocks in order and the last
// block's warps past W only meet the barriers. On an H100 a column of
// that kernel is dispatch-bound on its SM (16 warps on one SM run a column
// 1.8x slower than 8), so spreading a band over more SMs shortens the
// column; what a cluster adds is a barrier across SMs, which costs a
// column far more than a block barrier. So a column meets the cluster
// once: each warp computes the top Ph and Mh bits of its last word for
// either carry into it (carry-select), and publishes them with its
// (G, P) and the slide's bits of its word 0 in one word, which lane c
// pushes into block c's copy of the cluster's words through distributed
// shared memory (cluster.map_shared_rank). After one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) every read is local:
//   - the carry into warp g and into warp g - 1 from the lookahead add
//     over the W warps' (G, P) masks, Q = ceil(W / 32) 32-bit words
//     chained by their carries (a 32-bit add up to 32 warps, 64 up to 64);
//   - the horizontal shift's bits from the warp below: its top bits for
//     the carry into it;
//   - the slide's head bits from the warp above: its published word, as
//     in the one-block kernel.
// The words are double-buffered by column parity, so one barrier a
// column orders every push before its reads and every read before the
// next push to the same slot. The top warp's lane 31 holds the band
// bottom, keeps the scores and writes the result.
//
// The C entry point takes every band of a multiple of 128 words up to
// kMaxBandWords and a cluster of 1 to kMaxBlocks blocks of at most
// kBlockWarps warps (the wrapper picks it: blocks of about 4 warps, one
// for each of an SM's sub-partitions, measured fastest), and refuses a
// cluster the card cannot place (cudaOccupancyMaxActiveClusters, asked
// once a shape).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "myers_banded_column.cuh"

namespace cg = cooperative_groups;

namespace {

using floxer_banded::head_bits;
using floxer_banded::kFull;
using floxer_banded::or_tree;
using floxer_banded::slide_reg;

constexpr int kWordsPerLane = 4;
constexpr int kBlockWarps = 16;
constexpr int kMaxBlocks = 8;
constexpr int kMaxBandWords = 16384;
constexpr int kMaxWarps = kMaxBandWords / (32 * kWordsPerLane);
static_assert(kMaxWarps == kBlockWarps * kMaxBlocks, "the widest cluster");

// One block's copy of the cluster's words, at the column's parity: warp
// g's, pushed by it: bit 0 G, bit 1 P, bit 2 bit 0 of Xv = Eq | Vn of the
// warp's word 0, bits 3-6 bit 0 of that word's P0, P1, P2, AM, bits 7-8
// the top bits (Ph, Mh) of its last word if 0 enters the warp, bits 9-10
// if 1 does
struct Exchange {
  uint32_t words[2][kMaxWarps];
};

// Every thread of the cluster arrives, then waits for all: the pushes
// before it are visible to the reads after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The carries into warp `warp` (bit 0) and into warp `warp` - 1 (bit 1)
// from the W warps' published (G, P) bits: one lookahead add over Q
// 32-bit words, each word's carry into the next.
template <int Q>
__device__ __forceinline__ uint32_t warp_carries(const uint32_t* words,
                                                 int lane, int warp,
                                                 int warps) {
  uint32_t carries_in = 0u;
  uint32_t into = 0u;
  const int below = warp > 0 ? warp - 1 : 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int source = 32 * q + lane;
    const uint32_t word = source < warps ? words[source] : 0u;
    const uint32_t g = __ballot_sync(kFull, word & 1u);
    const uint32_t a = g | __ballot_sync(kFull, (word >> 1) & 1u);
    const uint64_t sum = static_cast<uint64_t>(a) + g + into;
    const uint32_t carries = static_cast<uint32_t>(sum) ^ a ^ g;
    if ((warp >> 5) == q) carries_in |= (carries >> (warp & 31)) & 1u;
    if ((below >> 5) == q) carries_in |= ((carries >> (below & 31)) & 1u) << 1;
    into = static_cast<uint32_t>(sum >> 32);
  }
  return carries_in;
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

// One text column of one warp's words (myers_banded_wide.cu's
// column_wide with one cluster barrier). `words` is this block's copy of
// the cluster's words at the column's parity; lanes below the cluster's
// block count push this warp's word to `push` (block `lane`'s copy, at
// offset 0 for parity 0).
template <int R, int Q, bool kSliding>
__device__ __forceinline__ int column_cluster(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t tch,
    uint32_t& head, uint32_t pessim, int lane, int warp, int warps,
    int blocks, const uint32_t* words, uint32_t* push, int parity) {
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
  // 3) the warp's word: lane 0's (G, P) and slide bits, lane 31's top
  // bits for either carry into the warp; pushed to every block
  const uint32_t g = static_cast<uint32_t>(
      (static_cast<uint64_t>(any) + gm) >> 32);
  const uint32_t low = __shfl_sync(
      kFull,
      g | ((pm == kFull ? 1u : 0u) << 1) | (((eq[0] | vn[0]) & 1u) << 2) |
          (head_bits(0u, 0u, p0[0], p1[0], p2[0], am[0]) << 1),
      0);
  const uint32_t tops = __shfl_sync(
      kFull,
      (top_bits<R>(eq, vp, vn, t, (runs0 >> (R - 1)) & 1u) << 7) |
          (top_bits<R>(eq, vp, vn, t, (runs1 >> (R - 1)) & 1u) << 9),
      31);
  if (lane < blocks) push[parity * kMaxWarps + warp] = low | tops;
  cluster_barrier();

  // 4) the carries into this warp and the one below from the warps'
  // (G, P) in one add; the warp below's top bits for its carry
  const uint32_t carried = warp_carries<Q>(words, lane, warp, warps);
  const uint32_t runs = (carried & 1u) ? runs1 : runs0;
  const uint32_t below =
      warp > 0 ? (words[warp - 1] >> ((carried & 2u) ? 9 : 7)) & 3u : pessim;
  const uint32_t above = words[warp + 1 < warps ? warp + 1 : warp];

  // 5) the add with carries and the horizontal deltas; Xv parks in vn
  uint32_t ph[R], mh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t xh = ((t[i] + ((runs >> i) & 1u)) ^ vp[i]) | eq[i];
    ph[i] = vn[i] | ~(xh | vp[i]);
    mh[i] = vp[i] & xh;
    vn[i] = eq[i] | vn[i];
  }
  const uint32_t top = (ph[R - 1] >> 31) | ((mh[R - 1] >> 31) << 1);

  // 6) horizontal deltas shift up one row; lane 0 takes the top bits of
  // the warp below (warp 0 the pessimistic delta)
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

  // 7) lane 31's head for the next slide: bit 0 of the word 0 of the warp
  // above after this column, whose Ph' and Mh' bit 0 are this lane's top
  if (kSliding) {
    const uint32_t ph_top = top & 1u;
    const uint32_t mh_top = top >> 1;
    const uint32_t xv = (above >> 2) & 1u;
    head = ((mh_top | ~(xv | ph_top)) & 1u) | ((ph_top & xv) << 1) |
           (((above >> 3) & 15u) << 2);
  }
  // 8) the score delta at the band bottom: the top bit of the last word
  return static_cast<int>(top & 1u) - static_cast<int>(top >> 1);
}

// A task on a cluster of gridDim.x / T blocks of blockDim.x / 32 warps,
// its band on the first `warps` warps (Q = ceil(warps / 32)).
template <int Q>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    myers_banded_cluster_kernel(
        const uint32_t* __restrict__ vp0,      // [T, BW]
        const uint32_t* __restrict__ planes0,  // [T, 4, BW]
        const uint32_t* __restrict__ texts,    // [T, NW] 8 nibbles a word
        const uint32_t* __restrict__ pstream,  // [T, NW] 8 nibbles a word
        const int32_t* __restrict__ scalars,   // [T, 6]
        int NW, int warps, int32_t* __restrict__ dist,
        int32_t* __restrict__ end_col) {
  constexpr int R = kWordsPerLane;
  __shared__ Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int task = blockIdx.x / blocks;
  const int lane = threadIdx.x & 31;
  const int local = threadIdx.x >> 5;
  const int block_warps = blockDim.x >> 5;
  const int warp = rank * block_warps + local;
  const int BW = 32 * R * warps;

  const int32_t* sc = scalars + static_cast<size_t>(task) * 6;
  const int tlen = sc[0];
  const int last_col = min(tlen - 1, NW * 8);
  // every block of the cluster runs before any warp pushes into it
  cluster.sync();
  if (warp >= warps) {
    // a warp past the band meets the columns' barriers, no more
    for (int col = 1; col <= last_col; ++col) cluster_barrier();
    return;
  }
  // where this warp pushes: lane c < blocks block c's copy
  uint32_t* push =
      lane < blocks ? cluster.map_shared_rank(&ex.words[0][0], lane) : nullptr;
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
    s_bot += 1 + column_cluster<R, Q, true>(
                     vp, vn, p0, p1, p2, am, tch, head,
                     col >= topshift ? 1u : 0u, lane, warp, warps, blocks,
                     ex.words[col & 1], push, col & 1);
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
    s_m += column_cluster<R, Q, false>(
        vp, vn, p0, p1, p2, am, tch, head, mfrozen, lane, warp, warps,
        blocks, ex.words[col & 1], push, col & 1);
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
                        const uint32_t*, const int32_t*, int, int, int32_t*,
                        int32_t*);

// The instance for `warps` warps: the lookahead's 32-bit words.
Kernel kernel_for(int warps) {
  if (warps <= 32) return myers_banded_cluster_kernel<1>;
  if (warps <= 64) return myers_banded_cluster_kernel<2>;
  return myers_banded_cluster_kernel<4>;
}

// The launch shape of a band: (blocks, warps a block); false when the
// band or the cluster size is refused.
bool cluster_shape(int band_words, int blocks, int* out_blocks,
                   int* out_block_warps) {
  if (band_words <= 0 || band_words > kMaxBandWords ||
      band_words % (32 * kWordsPerLane) != 0) {
    return false;
  }
  const int warps = band_words / (32 * kWordsPerLane);
  if (blocks < 1 || blocks > kMaxBlocks) return false;
  const int block_warps = (warps + blocks - 1) / blocks;
  if (block_warps > kBlockWarps) return false;
  *out_blocks = blocks;
  *out_block_warps = block_warps;
  return true;
}

cudaLaunchConfig_t launch_config(int clusters, int blocks, int block_warps,
                                 cudaLaunchAttribute* attribute,
                                 cudaStream_t stream) {
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = blocks;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * blocks);
  config.blockDim = dim3(32 * block_warps);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// Clusters of this shape the card holds at once (0: none fits).
cudaError_t max_clusters(int band_words, int blocks, int* out) {
  *out = 0;
  int block_warps = 0;
  if (!cluster_shape(band_words, blocks, &blocks, &block_warps)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config =
      launch_config(1, blocks, block_warps, attribute, nullptr);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(
               kernel_for(band_words / (32 * kWordsPerLane))),
      &config);
}

// An error the caller raises on, with the runtime's last error reset so
// that the next launch does not report it again.
cudaError_t refused(cudaError_t error) {
  if (error != cudaSuccess) cudaGetLastError();
  return error;
}

}  // namespace

extern "C" {

// Clusters of the launch shape of (band_words, blocks) the card holds at
// once, written to an int on the host; 0 when none fits.
int floxer_myers_banded_cluster_max_clusters(int band_words, int blocks,
                                             void* out) {
  return static_cast<int>(
      max_clusters(band_words, blocks, static_cast<int*>(out)));
}

// The cluster kernel on T tasks of a band of a multiple of 128 words up
// to kMaxBandWords, a cluster of `blocks` blocks a task. Any other width
// or cluster size, and a cluster the card cannot place, is refused.
int floxer_myers_banded_cluster(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int T, int band_words,
    int text_words, int blocks, void* dist, void* end_col, void* stream) {
  if (T == 0) return 0;
  int block_warps = 0;
  if (!cluster_shape(band_words, blocks, &blocks, &block_warps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whether a cluster of this shape fits, asked once a shape
  static int fits[kMaxBlocks + 1][kBlockWarps + 1][3] = {};
  const int warps = band_words / (32 * kWordsPerLane);
  const int instance = warps <= 32 ? 0 : warps <= 64 ? 1 : 2;
  int& fit = fits[blocks][block_warps][instance];
  if (fit == 0) {
    int count = 0;
    const cudaError_t error =
        refused(max_clusters(band_words, blocks, &count));
    if (error != cudaSuccess) return static_cast<int>(error);
    fit = count > 0 ? 1 : -1;
  }
  if (fit < 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config =
      launch_config(T, blocks, block_warps, attribute,
                    static_cast<cudaStream_t>(stream));
  const cudaError_t error = cudaLaunchKernelEx(
      &config, kernel_for(warps), static_cast<const uint32_t*>(vp0),
      static_cast<const uint32_t*>(planes0),
      static_cast<const uint32_t*>(texts),
      static_cast<const uint32_t*>(pattern_stream),
      static_cast<const int32_t*>(scalars), text_words, warps,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  if (error != cudaSuccess) return static_cast<int>(refused(error));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
