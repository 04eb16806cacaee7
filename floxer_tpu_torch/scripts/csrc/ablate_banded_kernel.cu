// Section ablation of the banded Myers kernel (K5).
//
// Replaces scripts/tpu_ablate_banded_kernel.py::make_kernel, which times
// the banded kernel's column body with one section removed at a time. It
// ablates THIS port's K1 as its shared-memory kernel computes it
// (myers_banded_kernel in csrc/myers_banded.cu, which runs every K1 launch
// wider than the register kernel's widths): the body below is that
// kernel's column, section by section, and each section can be switched
// off by a compile-time flag (one template instance per variant of the
// script):
//   slide      K1's band slide (myers_banded.cu:143-158), plus s_bot += 1
//              while sliding                                  kNoSlide
//   Eq         Eq from the bit-planes (:160-176); off: eq = P0^P1^P2^AM^ch
//                                                              kNoEq
//   carry      the in-run ripple and the warp (G, P) scan (:177-187, the
//              carries of :189-205); off: sum = (eq & vp) + vp  kNoKs
//   score      d_bot, s_bot, s_m (:207-219) and the best update (:241-
//              244); off: best += 1, best_end += 1 every column kNoScore
//   hshift     the one-bit horizontal shift (:221-239); off: ph, mh as
//              they are                                        kNoHshift
//   stream2    the entering pattern char; off: it is 0         kNoStream2
//   radix-4    the warp scan in 3 rounds with shuffles at d, 2d, 3d (the
//              round-5 TPU scan); its output equals the full scan's
//                                                              kRadix4
// The function is the TPU script's, which differs from K1: chars arrive
// as int32 per column (not nibbles); every row runs all num_text columns
// (no stop at tlen: time per column divides by it), so only columns with
// col < tlen are scored; s_bot starts at binit, s_m and best at minit; the
// output consumes every carried array (dist = s_bot + s_m + best +
// best_end + word BW-1 of VP^VN^P0^P1^P2^AM, int32 wraparound; end =
// best_end), so no ablated variant loses a section to dead-code removal.
//
// What bounds it on an H100: as K1, the serial chain of 32-bit integer ops
// per column, over state held in shared memory; one warp per row, lane l
// owns the words [l*R, (l+1)*R), word i of lane l at [i*32 + l].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kArrays = 9;  // VP VN P0 P1 P2 AM EQ PH MH

enum Flag : int {
  kNoSlide = 1,
  kNoEq = 2,
  kNoKs = 4,
  kNoScore = 8,
  kNoHshift = 16,
  kNoStream2 = 32,
  kRadix4 = 64,
};

// Slide one band array one bit toward word 0; `entering` is the bit that
// enters at the top of the last word of this lane's run (K1's slide).
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

// (G, P) packed as G | P << 1 from the lane `d` below; (0, 0) below lane 0
__device__ __forceinline__ uint32_t gp_below(uint32_t gp, int d, int lane) {
  const uint32_t up = __shfl_up_sync(kFull, gp, d);
  return lane >= d ? up : 0u;
}

template <int F>
__global__ void ablate_banded_kernel(
    const uint32_t* __restrict__ vp0,      // [rows, BW]
    const uint32_t* __restrict__ planes0,  // [rows, 4, BW]
    const int32_t* __restrict__ texts,     // [rows, N] chars 0..4
    const int32_t* __restrict__ pstream,   // [rows, N] chars 0..4
    const int32_t* __restrict__ scalars,   // [rows, 6]
    int rows, int BW, int N,
    int32_t* __restrict__ dist, int32_t* __restrict__ end_col) {
  extern __shared__ uint32_t smem[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  if (row >= rows) return;
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

  const size_t base = static_cast<size_t>(row) * BW;
  const size_t pbase = static_cast<size_t>(row) * 4 * BW;
  for (int i = 0; i < R; ++i) {
    const int w = lane * R + i;
    const int at = i * 32 + lane;
    VP[at] = vp0[base + w];
    VN[at] = 0u;
    P0[at] = planes0[pbase + w];
    P1[at] = planes0[pbase + BW + w];
    P2[at] = planes0[pbase + 2 * BW + w];
    AM[at] = planes0[pbase + 3 * BW + w];
  }

  const int32_t* sc = scalars + static_cast<size_t>(row) * 6;
  const int tlen = sc[0];
  const int jstar = sc[1];
  const int topshift = sc[2];
  const int mfrozen = sc[3];
  int s_bot = sc[5];
  int s_m = sc[4];
  int best = sc[4];
  int best_end = 0;

  const int32_t* trow = texts + static_cast<size_t>(row) * N;
  const int32_t* srow = pstream + static_cast<size_t>(row) * N;

  for (int j = 0; j < N; ++j) {
    const int col = j + 1;
    const uint32_t tch = static_cast<uint32_t>(trow[j]);
    uint32_t pch = 0u;
    if constexpr (!(F & kNoStream2)) pch = static_cast<uint32_t>(srow[j]);
    const bool sliding = col <= jstar;

    // 1) band slide
    if constexpr (!(F & kNoSlide)) {
      if (sliding) {
        const uint32_t head =
            (VP[lane] & 1u) | ((VN[lane] & 1u) << 1) | ((P0[lane] & 1u) << 2) |
            ((P1[lane] & 1u) << 3) | ((P2[lane] & 1u) << 4) |
            ((AM[lane] & 1u) << 5);
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
        s_bot += 1;
      }
    }

    // 2) Eq, and the run's carry (G, P)
    uint32_t G = 0u, P = 1u;
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      uint32_t eq;
      if constexpr (F & kNoEq) {
        eq = P0[at] ^ P1[at] ^ P2[at] ^ AM[at] ^ tch;
      } else {
        const uint32_t m0 = (tch & 1u) ? P0[at] : ~P0[at];
        const uint32_t m1 = (tch & 2u) ? P1[at] : ~P1[at];
        const uint32_t m2 = (tch & 4u) ? P2[at] : ~P2[at];
        eq = (m0 & m1 & m2) | AM[at];
      }
      EQ[at] = eq;
      if constexpr (!(F & kNoKs)) {
        const uint32_t vp = VP[at];
        const uint32_t a = eq & vp;
        const uint32_t t = a + vp;
        const uint32_t g = t < a ? 1u : 0u;
        const uint32_t p = t == kFull ? 1u : 0u;
        G = g | (p & G);
        P = P & p;
      }
    }
    // inclusive warp scan of the runs' (G, P), then exclusive carry-in
    uint32_t carry = 0u;
    if constexpr (!(F & kNoKs)) {
      if constexpr (F & kRadix4) {
        uint32_t gp = G | (P << 1);
#pragma unroll
        for (int d = 1; d < 32; d *= 4) {
          const uint32_t s1 = gp_below(gp, d, lane);
          uint32_t cg = gp & 1u;
          uint32_t cp = gp >> 1;
          if (2 * d < 32) {
            const uint32_t s2 = gp_below(gp, 2 * d, lane);
            const uint32_t s3 = gp_below(gp, 3 * d, lane);
            const uint32_t q1 = cp & (s1 >> 1);
            const uint32_t q2 = q1 & (s2 >> 1);
            cg = cg | (cp & s1 & 1u) | (q1 & s2 & 1u) | (q2 & s3 & 1u);
            cp = q2 & (s3 >> 1);
          } else {
            cg = cg | (cp & s1 & 1u);
            cp = cp & (s1 >> 1);
          }
          gp = cg | (cp << 1);
        }
        G = gp & 1u;
      } else {
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t g_up = __shfl_up_sync(kFull, G, d);
          const uint32_t p_up = __shfl_up_sync(kFull, P, d);
          if (lane >= d) {
            G = G | (P & g_up);
            P = P & p_up;
          }
        }
      }
      carry = __shfl_up_sync(kFull, G, 1);
      if (lane == 0) carry = 0u;
    }

    // 3) the add with carries and the horizontal deltas; Xv parks in VN
    for (int i = 0; i < R; ++i) {
      const int at = i * 32 + lane;
      const uint32_t vp = VP[at];
      const uint32_t vn = VN[at];
      const uint32_t eq = EQ[at];
      const uint32_t a = eq & vp;
      const uint32_t t = a + vp;
      uint32_t sum = t;
      if constexpr (!(F & kNoKs)) {
        const uint32_t g = t < a ? 1u : 0u;
        const uint32_t p = t == kFull ? 1u : 0u;
        sum = t + carry;
        carry = g | (p & carry);
      }
      const uint32_t xh = (sum ^ vp) | eq;
      PH[at] = vn | ~(xh | vp);
      MH[at] = vp & xh;
      VN[at] = eq | vn;
    }

    // 4) scores: the band bottom is the top bit of the last band word
    const int last = (R - 1) * 32 + lane;
    const uint32_t top_bits = (PH[last] >> 31) | ((MH[last] >> 31) << 1);
    if constexpr (!(F & kNoScore)) {
      const uint32_t bottom = __shfl_sync(kFull, top_bits, 31);
      const int d_bot = static_cast<int>(bottom & 1u) -
                        static_cast<int>((bottom >> 1) & 1u);
      s_bot += d_bot;
      if (col == jstar) {
        s_m = s_bot;
      } else if (!sliding) {
        s_m += d_bot;
      }
    }

    // 5) horizontal deltas shift down one row
    if constexpr (!(F & kNoHshift)) {
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
    } else {
      for (int i = 0; i < R; ++i) {
        const int at = i * 32 + lane;
        const uint32_t ph = PH[at];
        const uint32_t xv = VN[at];
        VP[at] = MH[at] | ~(xv | ph);
        VN[at] = ph & xv;
      }
    }

    // 6) best
    if constexpr (F & kNoScore) {
      best += 1;
      best_end += 1;
    } else {
      if (col < tlen && col >= jstar && s_m <= best) {
        best = s_m;
        best_end = col;
      }
    }
  }

  if (lane == 31) {
    const int at = (R - 1) * 32 + 31;  // band word BW - 1
    const uint32_t acc = VP[at] ^ VN[at] ^ P0[at] ^ P1[at] ^ P2[at] ^ AM[at];
    const uint32_t mix = static_cast<uint32_t>(s_bot) +
                         static_cast<uint32_t>(s_m) +
                         static_cast<uint32_t>(best) +
                         static_cast<uint32_t>(best_end) + acc;
    dist[row] = static_cast<int32_t>(mix);
    end_col[row] = best_end;
  }
}

template <int F>
int launch(const void* vp0, const void* planes0, const void* texts,
           const void* pstream, const void* scalars, int rows, int BW,
           int N, void* dist, void* end_col, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kArrays) * BW * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ablate_banded_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ablate_banded_kernel<F><<<rows, 32, smem, stream>>>(
      static_cast<const uint32_t*>(vp0), static_cast<const uint32_t*>(planes0),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(pstream),
      static_cast<const int32_t*>(scalars), rows, BW, N,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(end_col));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMinimal =
    kNoSlide | kNoEq | kNoKs | kNoScore | kNoHshift | kNoStream2;

}  // namespace

#define FLOXER_ABLATE_VARIANT(F)                                          \
  case F:                                                                 \
    return launch<F>(vp0, planes0, texts, pattern_stream, scalars, rows,  \
                     band_words, num_text, dist, end_col, s);

// vp0 uint32 [rows, BW], planes0 uint32 [rows, 4, BW], texts and
// pattern_stream int32 [rows, num_text], scalars int32 [rows, 6] (tlen,
// jstar, topshift, mfrozen, minit, binit) -> dist, end_col int32 [rows];
// flags: one of the script's nine variants
extern "C" int floxer_ablate_banded(
    const void* vp0, const void* planes0, const void* texts,
    const void* pattern_stream, const void* scalars, int rows,
    int band_words, int num_text, int flags, void* dist, void* end_col,
    void* stream) {
  if (rows == 0) return 0;
  if (band_words <= 0 || band_words % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
}
