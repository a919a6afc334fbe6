// The far-field band test shared by K2 (band_detect.cu) and K1's detect
// mode (fused_substep2.cu): does a partner at one band offset lie within
// reach of a particle?  The plain versions: ops/cuda/band_detect.py:
// band_flags_plain, and the band flag of ops/cuda/fused_substep2.py:
// detect_side_plain (the same loop).  Built with -fmad=false and no fast
// math, it rounds as they do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Cell (cpx, cpy) with cb = base + dev_cell against partner (qpx, qpy)
// with deviation qdev: d2 < reach^2, reach = (base + dev_cell) + dev_q
// (the association of the plain loop and of the TPU kernels).  A NaN or
// infinite operand compares false.
__device__ __forceinline__ bool band_pair_hit(float cpx, float cpy, float cb,
                                              float qpx, float qpy,
                                              float qdev) {
  const float ddx = qpx - cpx;
  const float ddy = qpy - cpy;
  const float d2 = ddx * ddx + ddy * ddy;
  const float reach = cb + qdev;
  return d2 < reach * reach;
}

// (dx, dy) is an offset of the half-plane band at stencil radius s and
// chunk 4 (FarFieldSpec.band_half_offsets, fused_substep2.py
// _band_offsets): index Chebyshev distance in [s + 1, 7], dx >= 0, and
// dx > 0 or dy > 0.
__device__ __forceinline__ bool band_offset(int dx, int dy, int s) {
  const int cheb = dx > (dy < 0 ? -dy : dy) ? dx : (dy < 0 ? -dy : dy);
  return (dx > 0 || dy > 0) && cheb > s && cheb <= 7;
}

// The band's offsets at one dy (|dy| <= 7) as a mask, bit dx set where
// band_offset(dx, dy, s): beyond the stencil on the dy axis (|dy| > s)
// every dx in [0, 8) but dx = 0 for dy < 0; within it dx in (s, 8).
__device__ __forceinline__ uint32_t band_dx_mask(int dy, int s) {
  const int ady = dy < 0 ? -dy : dy;
  if (ady > s) return dy > 0 ? 0xffu : 0xfeu;
  return (0xffu << (s + 1)) & 0xffu;
}

}  // namespace
