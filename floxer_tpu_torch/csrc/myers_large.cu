// Full Myers bit-parallel semi-global edit distance for patterns of more
// than 256 chars (K3).
//
// Replaces floxer_tpu/ops/pallas_myers_large.py::_kernel: the full-state
// kernel for long patterns whose band is not narrower than the full state
// (and for windows too short for the band, e.g. at a reference end). Per
// task, the minimum semi-global distance at row m over end columns
// 0 <= col < tlen, ties to the rightmost column, starting from score m.
//
// What bounds it on an H100: as in K1, each text column is a serial chain
// of 32-bit integer ops across the pattern's words with a carry that
// crosses every word; one 4-byte char and the char's Peq row enter per
// column, so the per-column latency chain bounds it, not memory.
//
// Two kernels here and a third in myers_large_cluster.cu compute the
// same function; the wrapper picks one by the padded word count Wp alone.
// The two here run one warp per task; all three stop each task at its own
// tlen.
//
// myers_large_reg_kernel<R> (Wp <= 32 * R words; R = 1, 2, 4, 8, 12, 16,
// so Wp up to 512): one pattern word per lane. Group i holds words
// [32i, 32i + 32), lane l keeps word 32i + l of Vp and Vn in registers
// (x[i], compile-time indices in unrolled loops), and the column is
// myers_full_column.cuh's: the carry within a group from two ballots in
// one add, from group to group through the add's carry out, the shift by
// one shuffle per group. Work on padding words is skipped: a task runs
// only its ceil(m / 1024) groups. The branch that skips the others is
// taken once per task, not per column: a switch on the group count picks
// a column loop compiled for exactly that many groups, so no column pays
// a per-group branch and the groups' independent work interleaves. The
// host needs no pattern length for this, so the fused wave's launch stays
// asynchronous. The task's Peq rows sit in shared memory as [c][word] with
// an all-zero row 6 that chars >= 6 select (read-only, conflict-free, one
// warp per block); lane l loads the char of column base + l of the next
// 32 columns one chunk ahead, a shuffle hands each column's char to every
// lane, and each column's Eq words are loaded during the column before,
// so no Eq waits on a load. The lane that owns row m keeps the score and
// writes the result.
//
// myers_large_kernel (any Wp its shared memory holds; no width routes to
// it, myers_large_cluster.cu takes every Wp past 512): VP/VN and
// per-column scratch in shared memory, interleaved [i*32 + lane]
// (conflict-free, lane-private), lane l owning words [l*R, (l+1)*R) with
// R = Wp/32, the carry of the
// multi-word add scanned across lanes with __shfl_up_sync (generate,
// propagate), the one-bit left shift carried by __shfl_up_sync. The Peq
// rows are read from global memory. Chars >= 6 (garbage nibbles past a
// fused window) give Eq = 0 and never index the table.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_full_column.cuh"

namespace {

using floxer_full::kFull;
constexpr int kSigma = 6;
constexpr int kArrays = 5;  // VP VN EQ PH MH

__global__ void myers_large_kernel(
    const uint32_t* __restrict__ peq,    // [B, 6, Wp]
    const int32_t* __restrict__ plen,    // [B]
    const int32_t* __restrict__ texts,   // [B, N]
    const int32_t* __restrict__ tlen,    // [B]
    int B, int Wp, int N,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  extern __shared__ uint32_t smem[];
  const int task = blockIdx.x;
  const int lane = threadIdx.x;
  if (task >= B) return;
  const int R = Wp / 32;
  uint32_t* VP = smem;
  uint32_t* VN = VP + Wp;
  uint32_t* EQ = VN + Wp;
  uint32_t* PH = EQ + Wp;
  uint32_t* MH = PH + Wp;

  const int m = plen[task];
  const int msb_word = (m - 1) >> 5;  // floor division, -1 for m == 0
  const uint32_t msb_mask = 1u << ((m - 1) & 31);
  const int owner = (msb_word >= 0 && msb_word < Wp) ? msb_word / R : -1;
  const int owner_at = owner >= 0 ? (msb_word - owner * R) * 32 + owner : 0;

  for (int i = 0; i < R; ++i) {
    const int w = lane * R + i;
    VP[i * 32 + lane] = (w <= msb_word) ? kFull : 0u;
    VN[i * 32 + lane] = 0u;
  }

  const uint32_t* pq = peq + static_cast<size_t>(task) * kSigma * Wp;
  const int32_t* trow = texts + static_cast<size_t>(task) * N;
  int score = m;
  int best = m;
  int best_end = 0;
  const int ncols = min(tlen[task] - 1, N);

  for (int j = 0; j < ncols; ++j) {
    const uint32_t c = static_cast<uint32_t>(trow[j]);
    const uint32_t* eq_row = (c < kSigma) ? pq + c * Wp : nullptr;

    // 1) Eq and the run's carry (G, P)
    uint32_t G = 0u, P = 1u;
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      const uint32_t eq = eq_row ? eq_row[lane * R + i] : 0u;
      EQ[at] = eq;
      const uint32_t vp = VP[at];
      const uint32_t a = eq & vp;
      const uint32_t t = a + vp;
      const uint32_t g = t < a ? 1u : 0u;
      const uint32_t p = t == kFull ? 1u : 0u;
      G = g | (p & G);
      P = P & p;
    }
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

    // 2) the add with carries and the horizontal deltas; Xv parks in VN
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

    // 3) score deltas at the pattern's last row (one lane owns that word)
    uint32_t bits = 0u;
    if (lane == owner) {
      bits = ((PH[owner_at] & msb_mask) ? 1u : 0u) |
             ((MH[owner_at] & msb_mask) ? 2u : 0u);
    }
    bits = __shfl_sync(kFull, bits, owner >= 0 ? owner : 0);
    score += static_cast<int>(bits & 1u) - static_cast<int>((bits >> 1) & 1u);

    // 4) one-bit left shift across words, masked to the pattern's words
    const int last = (R - 1) * 32 + lane;
    const uint32_t top_bits = (PH[last] >> 31) | ((MH[last] >> 31) << 1);
    uint32_t hcarry = __shfl_up_sync(kFull, top_bits, 1);
    if (lane == 0) hcarry = 0u;
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
      const bool active = lane * R + i <= msb_word;
      VP[at] = active ? (mh_sh | ~(xv | ph_sh)) : 0u;
      VN[at] = active ? (ph_sh & xv) : 0u;
    }

    if (score <= best) {
      best = score;
      best_end = j + 1;
    }
  }
  if (lane == 0) {
    dist[task] = best;
    end_col[task] = best_end;
  }
}

// ---- register kernel -----------------------------------------------------

// The Peq row offset of a text char in the shared table (chars >= 6, and
// columns past the text, take the all-zero row 6).
template <int R>
__device__ __forceinline__ uint32_t eq_row(const int32_t* trow, int col,
                                           int N) {
  const uint32_t c = col < N ? static_cast<uint32_t>(__ldg(trow + col))
                             : static_cast<uint32_t>(kSigma);
  return min(c, static_cast<uint32_t>(kSigma)) * (32u * R);
}

// Every column of one task on G groups of pattern words; the lane that
// owns row m writes (dist, end).
template <int G, int R>
__device__ __forceinline__ void columns_reg(
    const uint32_t* eq_rows, const int32_t* trow, int N, int ncols, int m,
    int lane, int32_t* dist, int32_t* end_col) {
  const int msb_word = (m - 1) >> 5;
  const int msb_bit = (m - 1) & 31;
  uint32_t vp[G], vn[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    vp[i] = 32 * i + lane <= msb_word ? kFull : 0u;
    vn[i] = 0u;
  }
  // lane l: the Peq row offsets of column base + l of this chunk of 32
  // columns and of the next
  uint32_t chunk = eq_row<R>(trow, lane, N);
  uint32_t next_chunk = eq_row<R>(trow, 32 + lane, N);
  uint32_t eq[G];
  {
    const uint32_t* row = eq_rows + __shfl_sync(kFull, chunk, 0) + lane;
#pragma unroll
    for (int i = 0; i < G; ++i) eq[i] = row[32 * i];
  }
  int score = m;
  int best = m;
  int best_end = 0;
#pragma unroll 1
  for (int j = 0; j < ncols; ++j) {
    // the next column's Eq words, loaded while this column runs
    const int jn = j + 1;
    if ((jn & 31) == 0) {
      chunk = next_chunk;
      next_chunk = eq_row<R>(trow, jn + 32 + lane, N);
    }
    const uint32_t* row =
        eq_rows + __shfl_sync(kFull, chunk, jn & 31) + lane;
    uint32_t eq_next[G];
#pragma unroll
    for (int i = 0; i < G; ++i) eq_next[i] = row[32 * i];

    // 1) each word's add without its carry-in; per group the ballots of
    // the words' generate and propagate bits
    uint32_t t[G], gm[G], pm[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const uint32_t a = eq[i] & vp[i];
      t[i] = a + vp[i];
      gm[i] = __ballot_sync(kFull, t[i] < a);
      pm[i] = __ballot_sync(kFull, t[i] == kFull);
    }
    // 2) the carries: within a group in one add, from group to group
    // through that add's carry out
    uint32_t carry[G];
    uint32_t cin = 0u;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const uint32_t carries =
          floxer_full::lookahead_carries(gm[i], pm[i], cin, cin);
      carry[i] = (carries >> lane) & 1u;
    }
    // 3) the horizontal deltas, shifted up one bit: one shuffle per group
    // brings each lane the top bits of the lane below; lane 0 takes lane
    // 31's of the group below (0 in group 0)
    uint32_t below_group = 0u;
    uint32_t ph_m = 0u, mh_m = 0u;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      uint32_t ph, mh;
      floxer_full::horizontal_deltas(eq[i], vp[i], vn[i], t[i], carry[i], ph,
                                     mh);
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
    // 4) the score at row m (meaningful in the lane that owns it)
    score += static_cast<int>((ph_m >> msb_bit) & 1u) -
             static_cast<int>((mh_m >> msb_bit) & 1u);
    if (score <= best) {
      best = score;
      best_end = jn;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) eq[i] = eq_next[i];
  }
  if (lane == (msb_word & 31)) {
    *dist = best;
    *end_col = best_end;
  }
}

// columns_reg at the task's group count G (1..R), picked once per task.
template <int G, int R>
__device__ __forceinline__ void columns_for_groups(
    int groups, const uint32_t* eq_rows, const int32_t* trow, int N,
    int ncols, int m, int lane, int32_t* dist, int32_t* end_col) {
  if constexpr (G <= R) {
    if (groups == G) {
      columns_reg<G, R>(eq_rows, trow, N, ncols, m, lane, dist, end_col);
    } else {
      columns_for_groups<G + 1, R>(groups, eq_rows, trow, N, ncols, m, lane,
                                   dist, end_col);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(32) myers_large_reg_kernel(
    const uint32_t* __restrict__ peq,    // [B, 6, Wp], Wp <= 32 * R
    const int32_t* __restrict__ plen,    // [B]
    const int32_t* __restrict__ texts,   // [B, N]
    const int32_t* __restrict__ tlen,    // [B]
    int B, int Wp, int N,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  // Peq rows 0..5 of the task's words, then row 6 all zero
  __shared__ uint32_t eq_rows[(kSigma + 1) * 32 * R];
  const int task = blockIdx.x;
  const int lane = threadIdx.x;
  if (task >= B) return;
  const int m = plen[task];
  const int ncols = min(tlen[task] - 1, N);
  const int msb_word = (m - 1) >> 5;  // floor division, -1 for m == 0
  if (msb_word < 0 || msb_word >= Wp) {
    // no pattern word holds row m: the score stays m and every column
    // ties, so the rightmost one wins
    if (lane == 0) {
      dist[task] = m;
      end_col[task] = max(ncols, 0);
    }
    return;
  }
  const int groups = (msb_word >> 5) + 1;  // <= Wp / 32 <= R
  const uint32_t* pq = peq + static_cast<size_t>(task) * kSigma * Wp;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < groups) {
      const int w = 32 * i + lane;
#pragma unroll
      for (int c = 0; c < kSigma; ++c) {
        eq_rows[c * 32 * R + w] = __ldg(pq + c * Wp + w);
      }
      eq_rows[kSigma * 32 * R + w] = 0u;
    }
  }
  __syncwarp();
  columns_for_groups<1, R>(groups, eq_rows,
                           texts + static_cast<size_t>(task) * N, N, ncols,
                           m, lane, dist + task, end_col + task);
}

template <int R>
int launch_reg(const void* peq, const void* plen, const void* texts,
               const void* tlen, int B, int Wp, int N, void* dist,
               void* end_col, void* stream) {
  myers_large_reg_kernel<R><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const int32_t*>(plen),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlen),
      B, Wp, N, static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int floxer_myers_large(
    const void* peq, const void* plen, const void* texts, const void* tlen,
    int B, int words_padded, int num_text, void* dist, void* end_col,
    void* stream) {
  if (B == 0) return 0;
  if (words_padded <= 0 || words_padded % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kArrays) * words_padded *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        myers_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      // refused (past the card's shared memory a block): reset the
      // runtime's last error, so the next launch does not report it
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  myers_large_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const int32_t*>(plen),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlen),
      B, words_padded, num_text, static_cast<int32_t*>(dist),
      static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}

// The register kernel at the smallest instance that holds Wp words (the
// cases below; the wrapper's REGISTER_WORDS); wider Wp is refused, and the
// wrapper sends it to floxer_myers_large.
extern "C" int floxer_myers_large_reg(
    const void* peq, const void* plen, const void* texts, const void* tlen,
    int B, int words_padded, int num_text, void* dist, void* end_col,
    void* stream) {
  if (B == 0) return 0;
  if (words_padded <= 0 || words_padded % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FLOXER_LARGE_REG_CASE(R)                                           \
  if (words_padded <= 32 * R) {                                            \
    return launch_reg<R>(peq, plen, texts, tlen, B, words_padded, num_text, \
                         dist, end_col, stream);                           \
  }
  FLOXER_LARGE_REG_CASE(1)
  FLOXER_LARGE_REG_CASE(2)
  FLOXER_LARGE_REG_CASE(4)
  FLOXER_LARGE_REG_CASE(8)
  FLOXER_LARGE_REG_CASE(12)
  FLOXER_LARGE_REG_CASE(16)
#undef FLOXER_LARGE_REG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
