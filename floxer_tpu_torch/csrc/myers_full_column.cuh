// One text column of full Myers bit-parallel edit distance with one
// pattern word per lane, shared by the register kernels of K2
// (myers_small.cu) and K3 (myers_large.cu).
//
// A column of the recurrence on pattern words w = 0..W-1 is
//   t      = (Eq & Vp) + Vp          the add without its carry-in
//   sum    = t + carry(w)            carry(w): the carry out of word w-1
//   Xh     = (sum ^ Vp) | Eq,   Ph = Vn | ~(Xh | Vp),   Mh = Vp & Xh
//   Xv     = Eq | Vn
//   Ph', Mh' = Ph, Mh shifted up one bit across words (0 enters word 0)
//   Vp     = Mh' | ~(Xv | Ph'),     Vn = Ph' & Xv
// and the score at pattern row m moves by the Ph and Mh bits of row m.
//
// The carry has no serial chain across lanes: word w generates a carry
// (its add overflows, t < Eq & Vp) or propagates one (t == ~0), never both,
// so with Gm and Pm the ballots of the generate and propagate bits and
// A = Gm | Pm, bit l of (A + Gm + cin) ^ A ^ Gm is the carry into lane l,
// and the add's carry out of bit 31 is the carry out of lane 31 (one
// 32-lane carry-lookahead in one add, as in K1's register kernel,
// myers_banded.cu). The shift brings each lane the top bits of the lane
// below in one shuffle.
//
// Words above the one that holds row m are never masked: carries and
// shifts only move up, so they cannot reach row m or any word below it.

#pragma once

#include <cstdint>

namespace floxer_full {

constexpr unsigned kFull = 0xffffffffu;

// The carries into the 32 lanes of a word group (bit l for lane l) from
// the lanes' exclusive generate and propagate ballots `gm`, `pm` and the
// carry `cin` into lane 0; `cout` takes the carry out of lane 31.
__device__ __forceinline__ uint32_t lookahead_carries(uint32_t gm,
                                                      uint32_t pm,
                                                      uint32_t cin,
                                                      uint32_t& cout) {
  const uint32_t any = gm | pm;
  const uint64_t sum = static_cast<uint64_t>(any) + gm + cin;
  cout = static_cast<uint32_t>(sum >> 32);
  return static_cast<uint32_t>(sum) ^ any ^ gm;
}

// The horizontal deltas of one word from its add and its carry-in bit;
// Xv parks in vn until the shift.
__device__ __forceinline__ void horizontal_deltas(uint32_t eq, uint32_t vp,
                                                  uint32_t& vn, uint32_t t,
                                                  uint32_t carry,
                                                  uint32_t& ph,
                                                  uint32_t& mh) {
  const uint32_t xh = ((t + carry) ^ vp) | eq;
  ph = vn | ~(xh | vp);
  mh = vp & xh;
  vn = eq | vn;
}

// The top bits of a word's deltas, packed for the shuffle: bit 0 Ph, bit 1
// Mh.
__device__ __forceinline__ uint32_t top_bits(uint32_t ph, uint32_t mh) {
  return (ph >> 31) | ((mh >> 31) << 1);
}

// The new vertical deltas of one word from its deltas shifted up one bit,
// `below` the packed top bits of the word below (0 for word 0); `vn`
// holds Xv on entry.
__device__ __forceinline__ void vertical_deltas(uint32_t ph, uint32_t mh,
                                                uint32_t below,
                                                uint32_t& vp,
                                                uint32_t& vn) {
  const uint32_t ph_sh = (ph << 1) | (below & 1u);
  const uint32_t mh_sh = (mh << 1) | (below >> 1);
  vp = mh_sh | ~(vn | ph_sh);
  vn = ph_sh & vn;
}

}  // namespace floxer_full
