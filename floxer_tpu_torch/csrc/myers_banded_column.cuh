// In-warp steps of K1's register column, shared by the one-warp register
// kernel (myers_banded.cu) and the multi-warp one (myers_banded_wide.cu):
// the band slide by funnel shifts and the OR tree that packs a lane's
// per-word carry bits into one mask.

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

}  // namespace floxer_banded
