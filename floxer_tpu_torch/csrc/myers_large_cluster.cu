// Full Myers (K3) on patterns past the register kernel's widest (544 to
// 16384 words): myers_large_cluster_kernel, a thread-block cluster a task.
//
// Replaces, beside myers_large.cu,
// floxer_tpu/ops/pallas_myers_large.py::_kernel: the same function on the
// same operands (per task the minimum semi-global distance at row m over
// end columns 0 <= col < tlen, ties to the rightmost column, starting
// from score m).
//
// What bounds it on an H100: the per-column chain of int32 ops over the
// pattern's words, as in myers_large.cu. The shared-memory kernel walks
// each lane's words through shared memory on every column, one warp a
// task (4.2 us a column at 1280 words, growing with the width); a
// wavefront of warps on one block puts all of a task's warps on one SM.
//
// Layout: a wavefront of warps on a cluster of C blocks of Wb warps a
// task (C <= 8, a portable cluster; Wb <= 16). Warp g = Wb r + w (block
// rank r, warp w of the block) holds the four 32-word groups
// [4 g, 4 g + 4), and runs chunk s - g
// of 32 columns at step s. Full Myers has no slide, so a warp only reads
// what the warp below published a step before: its carry out and the top
// Ph and Mh bits of its lane 31, per column of the chunk. Each warp's
// lane 31 pushes them into the ring of the block that holds the warp
// above (through distributed shared memory, cluster.map_shared_rank,
// when that is the next block), so every read is a local one, and the
// cluster meets once a step, at a cluster barrier
// (barrier.cluster.arrive.release / wait.acquire, which orders the
// pushes before the reads): one barrier per 32 columns, not per column.
// Each block keeps only its own words' Peq rows in shared memory, with
// the all-zero row 6 that chars >= 6 select. A task runs only its
// ceil(m / 1024) groups; the warps above its last group meet the
// barriers and do nothing else, and the top warp runs a column loop
// compiled for exactly its own group count. The top warp owns row m,
// keeps the score and writes the result.
//
// The C entry point takes any Wp of a multiple of 32 words up to
// kMaxWords and a cluster of 1 to kMaxBlocks blocks of at most
// kBlockWarps warps (the wrapper picks it: blocks of about 4 warps, one
// for each of an SM's sub-partitions, measured fastest), and refuses a
// cluster the card cannot place (cudaOccupancyMaxActiveClusters, asked
// once a shape).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "myers_full_column.cuh"

namespace cg = cooperative_groups;

namespace {

using floxer_full::kFull;
constexpr int kSigma = 6;
constexpr int kGroupsPerWarp = 4;
constexpr int kBlockWarps = 16;
constexpr int kMaxBlocks = 8;
constexpr int kMaxWords = 16384;
constexpr int kChunk = 32;
static_assert(kMaxWords == 32 * kGroupsPerWarp * kBlockWarps * kMaxBlocks,
              "the widest cluster");

// What the warp below each warp of this block published for it: per
// column of a chunk, bit 0 its carry out, bits 1-2 the top bits of its
// lane 31; two slots by step parity.
struct Ring {
  uint32_t slot[2][kBlockWarps][kChunk];
};

// Every thread of the cluster arrives, then waits for all: the pushes
// before it are visible to the reads after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The Peq row offset of a text char (chars >= 6, and columns past the
// text, take the all-zero row 6).
__device__ __forceinline__ uint32_t eq_row(const int32_t* trow, int col,
                                           int N, uint32_t stride) {
  const uint32_t c = col < N ? static_cast<uint32_t>(__ldg(trow + col))
                             : static_cast<uint32_t>(kSigma);
  return min(c, static_cast<uint32_t>(kSigma)) * stride;
}

// Every column of one task on one warp's G groups (eq_rows from its first
// word on); `from_below` is this warp's ring slots (parity 0), `to_above`
// the warp above's (null for the top warp), `steps` the chunks plus the
// start-up of the warps that have work.
template <int G>
__device__ __forceinline__ void columns_cluster(
    const uint32_t* eq_rows, uint32_t stride, const int32_t* trow, int N,
    int ncols, int steps, int m, int lane, int warp, bool top_warp,
    int first_word, const uint32_t* from_ring, uint32_t* to_above,
    int32_t* dist, int32_t* end_col) {
  const int msb_word = (m - 1) >> 5;
  const int msb_bit = (m - 1) & 31;
  const int chunks = (ncols + kChunk - 1) / kChunk;
  uint32_t vp[G], vn[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    vp[i] = first_word + 32 * i + lane <= msb_word ? kFull : 0u;
    vn[i] = 0u;
  }
  int score = m;
  int best = m;
  int best_end = 0;
  constexpr int kParity = kBlockWarps * kChunk;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const int chunk = step - warp;
    if (chunk >= 0 && chunk < chunks) {
      const int base = chunk * kChunk;
      const int count = min(kChunk, ncols - base);
      // lane l: what the warp below published for column base + l
      const uint32_t from_below =
          warp > 0 ? from_ring[((step - 1) & 1) * kParity + lane] : 0u;
      uint32_t* push = top_warp ? nullptr : to_above + (step & 1) * kParity;
      // lane l: the Peq row offset of column base + l
      const uint32_t rows = eq_row(trow, base + lane, N, stride);
      uint32_t eq[G];
      {
        const uint32_t* row = eq_rows + __shfl_sync(kFull, rows, 0) + lane;
#pragma unroll
        for (int i = 0; i < G; ++i) eq[i] = row[32 * i];
      }
#pragma unroll 1
      for (int q = 0; q < count; ++q) {
        // the next column's Eq words, loaded while this column runs
        const uint32_t* row =
            eq_rows + __shfl_sync(kFull, rows, (q + 1) & 31) + lane;
        uint32_t eq_next[G];
#pragma unroll
        for (int i = 0; i < G; ++i) eq_next[i] = row[32 * i];
        const uint32_t in = __shfl_sync(kFull, from_below, q);

        // 1) each word's add without its carry-in; per group the ballots
        uint32_t t[G], gm[G], pm[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const uint32_t a = eq[i] & vp[i];
          t[i] = a + vp[i];
          gm[i] = __ballot_sync(kFull, t[i] < a);
          pm[i] = __ballot_sync(kFull, t[i] == kFull);
        }
        // 2) the carries: into group 0 the warp below's carry out, then
        // within a group in one add and from group to group
        uint32_t carry[G];
        uint32_t cin = in & 1u;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const uint32_t carries =
              floxer_full::lookahead_carries(gm[i], pm[i], cin, cin);
          carry[i] = (carries >> lane) & 1u;
        }
        // 3) the horizontal deltas shifted up one bit: lane 0 of group 0
        // takes the warp below's top bits
        uint32_t below_group = in >> 1;
        uint32_t ph_m = 0u, mh_m = 0u;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          uint32_t ph, mh;
          floxer_full::horizontal_deltas(eq[i], vp[i], vn[i], t[i], carry[i],
                                         ph, mh);
          const uint32_t rotated = __shfl_sync(
              kFull, floxer_full::top_bits(ph, mh), (lane + 31) & 31);
          floxer_full::vertical_deltas(
              ph, mh, lane == 0 ? below_group : rotated, vp[i], vn[i]);
          below_group = rotated;
          if (i == G - 1) {
            ph_m = ph;
            mh_m = mh;
          }
        }
        // 4) push the carry out and lane 31's top bits to the warp above
        if (lane == 31 && push != nullptr) {
          push[q] = cin | (floxer_full::top_bits(ph_m, mh_m) << 1);
        }
        // 5) the score at row m (meaningful in the top warp's lane that
        // owns it)
        score += static_cast<int>((ph_m >> msb_bit) & 1u) -
                 static_cast<int>((mh_m >> msb_bit) & 1u);
        if (score <= best) {
          best = score;
          best_end = base + q + 1;
        }
#pragma unroll
        for (int i = 0; i < G; ++i) eq[i] = eq_next[i];
      }
    }
    cluster_barrier();
  }
  if (top_warp && lane == (msb_word & 31)) {
    *dist = best;
    *end_col = best_end;
  }
}

// columns_cluster at the warp's group count G (1..kGroupsPerWarp), picked
// once per task.
template <int G>
__device__ __forceinline__ void columns_for_groups(
    int groups, const uint32_t* eq_rows, uint32_t stride,
    const int32_t* trow, int N, int ncols, int steps, int m, int lane,
    int warp, bool top_warp, int first_word, const uint32_t* from_ring,
    uint32_t* to_above, int32_t* dist, int32_t* end_col) {
  if constexpr (G <= kGroupsPerWarp) {
    if (groups == G) {
      columns_cluster<G>(eq_rows, stride, trow, N, ncols, steps, m, lane,
                         warp, top_warp, first_word, from_ring, to_above,
                         dist, end_col);
    } else {
      columns_for_groups<G + 1>(groups, eq_rows, stride, trow, N, ncols,
                                steps, m, lane, warp, top_warp, first_word,
                                from_ring, to_above, dist, end_col);
    }
  }
}

__global__ void __launch_bounds__(32 * kBlockWarps) myers_large_cluster_kernel(
    const uint32_t* __restrict__ peq,    // [B, 6, Wp], Wp <= kMaxWords
    const int32_t* __restrict__ plen,    // [B]
    const int32_t* __restrict__ texts,   // [B, N]
    const int32_t* __restrict__ tlen,    // [B]
    int Wp, int N, int32_t* __restrict__ dist,
    int32_t* __restrict__ end_col) {
  constexpr int R = kGroupsPerWarp;
  // Peq rows 0..5 of the block's words, then row 6 all zero
  extern __shared__ uint32_t eq_rows[];
  __shared__ Ring ring;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int task = blockIdx.x / blocks;
  const int lane = threadIdx.x & 31;
  const int local = threadIdx.x >> 5;
  const int block_warps = blockDim.x >> 5;
  const int warp = rank * block_warps + local;
  const uint32_t stride = blockDim.x * R;  // words the block holds
  const int block_first_word = static_cast<int>(stride) * rank;
  const int m = plen[task];
  const int ncols = min(tlen[task] - 1, N);
  const int msb_word = (m - 1) >> 5;  // floor division, -1 for m == 0
  if (msb_word < 0 || msb_word >= Wp) {
    // no pattern word holds row m: the score stays m and every column
    // ties, so the rightmost one wins (the whole cluster leaves here)
    if (rank == 0 && threadIdx.x == 0) {
      dist[task] = m;
      end_col[task] = max(ncols, 0);
    }
    return;
  }
  const int groups = (msb_word >> 5) + 1;  // <= Wp / 32
  const int active = (groups + R - 1) / R;
  const int chunks = ncols > 0 ? (ncols + kChunk - 1) / kChunk : 0;
  const int steps = chunks + active - 1;
  const int my_groups = min(R, groups - R * warp);
  const int first_word = 32 * R * warp;
  if (warp < active) {
    const uint32_t* pq = peq + static_cast<size_t>(task) * kSigma * Wp;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < my_groups) {
        const int w = first_word + 32 * i + lane;
        const int at = w - block_first_word;
#pragma unroll
        for (int c = 0; c < kSigma; ++c) {
          eq_rows[c * stride + at] = __ldg(pq + c * Wp + w);
        }
        eq_rows[kSigma * stride + at] = 0u;
      }
    }
  }
  // every block of the cluster runs (and its Peq rows are loaded) before
  // any warp pushes into it
  cluster.sync();
  if (warp >= active) {
    // a warp above the task's groups meets the steps' barriers, no more
    for (int step = 0; step < steps; ++step) cluster_barrier();
    return;
  }
  uint32_t* to_above =
      warp + 1 < active
          ? cluster.map_shared_rank(
                &ring.slot[0][(warp + 1) % block_warps][0],
                (warp + 1) / block_warps)
          : nullptr;
  columns_for_groups<1>(
      my_groups, eq_rows + (first_word - block_first_word), stride,
      texts + static_cast<size_t>(task) * N, N, max(ncols, 0), steps, m,
      lane, warp, warp == active - 1, first_word, &ring.slot[0][local][0],
      to_above, dist + task, end_col + task);
}

// The launch shape of Wp words: (blocks, warps a block); false when the
// width or the cluster size is refused.
bool cluster_shape(int words_padded, int blocks, int* out_blocks,
                   int* out_block_warps) {
  if (words_padded <= 0 || words_padded % 32 != 0 ||
      words_padded > kMaxWords) {
    return false;
  }
  const int warps = (words_padded / 32 + kGroupsPerWarp - 1) / kGroupsPerWarp;
  if (blocks < 1 || blocks > kMaxBlocks) return false;
  const int block_warps = (warps + blocks - 1) / blocks;
  if (block_warps > kBlockWarps) return false;
  *out_blocks = blocks;
  *out_block_warps = block_warps;
  return true;
}

size_t shared_bytes(int block_warps) {
  return static_cast<size_t>(kSigma + 1) * 32 * kGroupsPerWarp *
         block_warps * sizeof(uint32_t);
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
  config.dynamicSmemBytes = shared_bytes(block_warps);
  config.stream = stream;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// The dynamic shared memory of the widest block, asked for once.
cudaError_t allow_shared() {
  static cudaError_t allowed = cudaErrorNotReady;
  if (allowed == cudaErrorNotReady) {
    allowed = cudaFuncSetAttribute(
        myers_large_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes(kBlockWarps)));
  }
  return allowed;
}

// Clusters of this shape the card holds at once (0: none fits).
cudaError_t max_clusters(int words_padded, int blocks, int* out) {
  *out = 0;
  int block_warps = 0;
  if (!cluster_shape(words_padded, blocks, &blocks, &block_warps)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t error = allow_shared();
  if (error != cudaSuccess) return error;
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config =
      launch_config(1, blocks, block_warps, attribute, nullptr);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(myers_large_cluster_kernel),
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

// Clusters of the launch shape of (words_padded, blocks) the card holds
// at once, written to an int on the host; 0 when none fits.
int floxer_myers_large_cluster_max_clusters(int words_padded, int blocks,
                                            void* out) {
  return static_cast<int>(
      max_clusters(words_padded, blocks, static_cast<int*>(out)));
}

// The cluster kernel on B tasks of any Wp of a multiple of 32 words up to
// kMaxWords, a cluster of `blocks` blocks a task. Any other width or
// cluster size, and a cluster the card cannot place, is refused.
int floxer_myers_large_cluster(const void* peq, const void* plen,
                               const void* texts, const void* tlen, int B,
                               int words_padded, int num_text, int blocks,
                               void* dist, void* end_col, void* stream) {
  if (B == 0) return 0;
  int block_warps = 0;
  if (!cluster_shape(words_padded, blocks, &blocks, &block_warps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whether a cluster of this shape fits, asked once a shape
  static int fits[kMaxBlocks + 1][kBlockWarps + 1] = {};
  int& fit = fits[blocks][block_warps];
  if (fit == 0) {
    int count = 0;
    const cudaError_t error =
        refused(max_clusters(words_padded, blocks, &count));
    if (error != cudaSuccess) return static_cast<int>(error);
    fit = count > 0 ? 1 : -1;
  }
  if (fit < 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config =
      launch_config(B, blocks, block_warps, attribute,
                    static_cast<cudaStream_t>(stream));
  const cudaError_t error = cudaLaunchKernelEx(
      &config, myers_large_cluster_kernel, static_cast<const uint32_t*>(peq),
      static_cast<const int32_t*>(plen), static_cast<const int32_t*>(texts),
      static_cast<const int32_t*>(tlen), words_padded, num_text,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  if (error != cudaSuccess) return static_cast<int>(refused(error));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
