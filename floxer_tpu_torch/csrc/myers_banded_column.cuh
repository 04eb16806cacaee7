// In-warp steps of K1's register column, shared by the one-warp register
// kernel (myers_banded.cu) and the multi-warp one (myers_banded_wide.cu):
// the band slide by funnel shifts and the OR tree that packs a lane's
// per-word carry bits into one mask; and the one-warp kernel's whole
// column, `column_reg`, which the section ablation (K5,
// scripts/csrc/ablate_banded_kernel.cu) runs with sections switched off.

#pragma once

#include <cstdint>

namespace floxer_banded {

constexpr unsigned kFull = 0xffffffffu;

// Slide one band array one bit toward word 0; bit 0 of `entering` enters at
// the top of this lane's last word.
template <int R>
__device__ __forceinline__ void slide_reg(uint32_t (&x)[R],
                                          uint32_t entering) {
#pragma unroll
  for (int i = 0; i < R - 1; ++i) x[i] = __funnelshift_r(x[i], x[i + 1], 1);
  x[R - 1] = __funnelshift_r(x[R - 1], entering, 1);
}

// The OR of x[0..R) as a tree of compile-time depth log2(R).
template <int R>
__device__ __forceinline__ uint32_t or_tree(uint32_t (&x)[R]) {
#pragma unroll
  for (int step = 1; step < R; step <<= 1) {
#pragma unroll
    for (int i = 0; i + step < R; i += 2 * step) x[i] |= x[i + step];
  }
  return x[0];
}

// The bit 0 of a lane's word 0 in each of the six band arrays, packed as
// the slide passes them down (bit 0 VP, 1 VN, 2-4 the char planes, 5 AM).
__device__ __forceinline__ uint32_t head_bits(uint32_t vp, uint32_t vn,
                                              uint32_t p0, uint32_t p1,
                                              uint32_t p2, uint32_t am) {
  return (vp & 1u) | ((vn & 1u) << 1) | ((p0 & 1u) << 2) | ((p1 & 1u) << 3) |
         ((p2 & 1u) << 4) | ((am & 1u) << 5);
}

// The sections of column_reg that the ablation (K5) can switch off, one
// bit each of its compile-time mask F; K1 runs F = 0. kRadix4 replaces the
// ballot look-ahead of the lanes' carries by a radix-4 scan (the same
// carries).
enum ColumnSection : int {
  kNoSlide = 1,     // the head shuffle and the six slide_reg calls
  kNoEq = 2,        // Eq's LOP3 of the planes; off: the planes' XOR
  kNoKs = 4,        // every carry of the add; off: sum = t
  kNoScore = 8,     // the kernel's score updates (column_reg returns them)
  kNoHshift = 16,   // the funnel shifts and the __shfl_up_sync of Ph, Mh
  kNoStream2 = 32,  // the entering pattern char (the kernel's to drop)
  kRadix4 = 64,
};

// (G, P) packed as G | P << 1 from the lane `d` below; (0, 0) below lane 0
__device__ __forceinline__ uint32_t gp_below(uint32_t gp, int d, int lane) {
  const uint32_t up = __shfl_up_sync(kFull, gp, d);
  return lane >= d ? up : 0u;
}

// The inclusive scan of the lanes' (G, P) in radix-4 rounds: shuffles at
// d, 2d and 3d for d = 1, 4, then at 16 (the TPU's scan); returns G.
__device__ __forceinline__ uint32_t radix4_scan(uint32_t G, bool P,
                                                int lane) {
  uint32_t gp = G | (P ? 2u : 0u);
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
  return gp & 1u;
}

// One text column on register state: lane l holds the band words
// [lR, (l+1)R) of each array. Returns the score delta at the band bottom
// (meaningful in lane 31 only). F = 0 is K1's column; each bit of F drops
// one section (ColumnSection).
template <int R, bool kSliding, int F = 0>
__device__ __forceinline__ int column_reg(
    uint32_t (&vp)[R], uint32_t (&vn)[R], uint32_t (&p0)[R],
    uint32_t (&p1)[R], uint32_t (&p2)[R], uint32_t (&am)[R], uint32_t tch,
    uint32_t pch, uint32_t pessim, int lane) {
  // 1) band slide: every array moves one bit toward word 0; the row
  // entering at the bottom gets a pessimistic VP bit and the plane bits of
  // its pattern char
  if constexpr (kSliding && !(F & kNoSlide)) {
    const uint32_t head = head_bits(vp[0], vn[0], p0[0], p1[0], p2[0], am[0]);
    uint32_t nxt = __shfl_down_sync(kFull, head, 1);
    if (lane == 31) nxt = 1u | ((pch & 7u) << 2);
    slide_reg<R>(vp, nxt);
    slide_reg<R>(vn, nxt >> 1);
    slide_reg<R>(p0, nxt >> 2);
    slide_reg<R>(p1, nxt >> 3);
    slide_reg<R>(p2, nxt >> 4);
    slide_reg<R>(am, nxt >> 5);
  }

  // 2) Eq from the char bit-planes, and each word's carry generate and
  // propagate bit of the add eq & vp + vp, as R-bit masks of the lane's
  // run; they are exclusive (a word that propagates, t == ~0, cannot
  // overflow)
  const uint32_t x0 = (tch & 1u) ? 0u : kFull;
  const uint32_t x1 = (tch & 2u) ? 0u : kFull;
  const uint32_t x2 = (tch & 4u) ? 0u : kFull;
  uint32_t eq[R], t[R], gen[R], prop[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (F & kNoEq) {
      eq[i] = p0[i] ^ p1[i] ^ p2[i] ^ am[i] ^ tch;
    } else {
      eq[i] = ((p0[i] ^ x0) & (p1[i] ^ x1) & (p2[i] ^ x2)) | am[i];
    }
    const uint32_t a = eq[i] & vp[i];
    t[i] = a + vp[i];
    gen[i] = (t[i] < a ? 1u : 0u) << i;
    prop[i] = (t[i] == kFull ? 1u : 0u) << i;
  }
  // bit i of `carries` is the carry into word i
  uint32_t carries = 0u;
  if constexpr (!(F & kNoKs)) {
    const uint32_t gen_run = or_tree<R>(gen);
    const uint32_t prop_run = or_tree<R>(prop);
    const uint32_t any_run = gen_run | prop_run;
    // the run generates a carry (its add from carry-in 0 overflows) or
    // propagates one (every word propagates)
    const uint32_t G = (any_run + gen_run) >> R;
    const bool P = prop_run == (1u << R) - 1u;
    // carry-lookahead across the 32 lanes in one add, then across the
    // run's words in another
    uint32_t carry_in;
    if constexpr (F & kRadix4) {
      carry_in = __shfl_up_sync(kFull, radix4_scan(G, P, lane), 1);
      if (lane == 0) carry_in = 0u;
    } else {
      const uint32_t gm = __ballot_sync(kFull, G != 0u);
      const uint32_t pm = __ballot_sync(kFull, P);
      const uint32_t any = gm | pm;
      carry_in = (((any + gm) ^ any ^ gm) >> lane) & 1u;
    }
    carries = (any_run + gen_run + carry_in) ^ any_run ^ gen_run;
  }

  // 3) the add with carries and the horizontal deltas; Xv parks in vn
  uint32_t ph[R], mh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t sum = t[i] + ((carries >> i) & 1u);
    const uint32_t xh = (sum ^ vp[i]) | eq[i];
    ph[i] = vn[i] | ~(xh | vp[i]);
    mh[i] = vp[i] & xh;
    vn[i] = eq[i] | vn[i];
  }

  // 4) horizontal deltas shift down one row; the delta entering at word 0
  // is +1 (pessimistic) once the top stored row is a real row
  const uint32_t top = (ph[R - 1] >> 31) | ((mh[R - 1] >> 31) << 1);
  if constexpr (F & kNoHshift) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      vp[i] = mh[i] | ~(vn[i] | ph[i]);
      vn[i] = ph[i] & vn[i];
    }
  } else {
    uint32_t hcarry = __shfl_up_sync(kFull, top, 1);
    if (lane == 0) hcarry = pessim;
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
  }
  // 5) the score delta at the band bottom: the top bit of the last word
  return static_cast<int>(top & 1u) - static_cast<int>(top >> 1);
}

}  // namespace floxer_banded
