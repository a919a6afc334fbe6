// K3: the dense collision stencil, hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/collide_stencil.py:_kernel (the
// Pallas TPU kernel launched by stencil_collisions_pallas).  Plain
// version: softbody_tpu_torch/ops/cuda/collide_stencil.py
// (collide_stencil_plain).
//
// Each particle sums the reference pair math (compute.wgsl:150-168) over
// its full offset set (2s+1)^2 - 1, dx-major from -s to s, then dy: no
// reactions, no atomics, each unordered pair evaluated at both ends.
//
// What bounds it on the card: device-memory bytes.  At 1M particles it
// reads px py vx vy (f32) and alive (1 byte) and writes 5 f32 planes:
// ~37 MB, ~11 us at 3.35 TB/s.  The arithmetic (24 pair evaluations per
// particle at s = 2, each with an IEEE sqrt and divide) is not far
// below that.
//
// What the design does about it: one thread per particle on a 32 (H,
// fastest index) x 8 (W) tile, so every plane load and store is a
// coalesced 128-byte row; the tile plus a halo of s of the five input
// planes is staged once in shared memory, and every offset reads it
// there.  Out-of-range cells read as dead particles at the origin (the
// JAX zero pad).
//
// Exactness: terms are masked by multiplying with ovf (1.0 / 0.0) as the
// TPU kernel does (a non-finite term gives NaN, not 0); 1/dt^2 is a
// multiply by inv_dt2 computed on the host; the coincident nudge
// sign(lin_i - lin_j) with lin = x*H + y is -sign(dx*H + dy), from the
// index (exact in float32 below 2^24, and at 1M lin <= 999,999).  Built
// with -fmad=false and without fast math, the deltas equal the plain
// version's bit for bit.

#include "lattice_device.cuh"

namespace {

__global__ void __launch_bounds__(TX * TY)
collide_stencil_kernel(const float* __restrict__ px_g,
                       const float* __restrict__ py_g,
                       const float* __restrict__ vx_g,
                       const float* __restrict__ vy_g,
                       const bool* __restrict__ alive_g,
                       float* __restrict__ out, float two_r, float inv_dt2,
                       float ecoeff, float friction, int w, int h, int s) {
  extern __shared__ float smem[];
  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;
  const SmemTile t =
      stage_tile(smem, px_g, py_g, vx_g, vy_g, alive_g, x0, y0, s, w, h);

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const size_t WH = (size_t)w * h;
  const int lc = (threadIdx.y + s) * t.sy + threadIdx.x + s;
  const float c_px = t.px[lc], c_py = t.py[lc];
  const float c_vx = t.vx[lc], c_vy = t.vy[lc];
  const bool c_al = t.al[lc] > 0.0f;

  float dvx = 0.0f, dvy = 0.0f, dax = 0.0f, day = 0.0f, dyn = 0.0f;
  for (int dx = -s; dx <= s; ++dx) {
    for (int dy = -s; dy <= s; ++dy) {
      if (dx == 0 && dy == 0) continue;
      const int lo = lc + dx * t.sy + dy;
      const bool valid = c_al && t.al[lo] > 0.0f;
      const float ddx = t.px[lo] - c_px;
      const float ddy = t.py[lo] - c_py;
      const float dist = sqrtf(ddx * ddx + ddy * ddy);
      const bool coincident = valid && dist == 0.0f;
      const bool overlap = valid && dist > 0.0f && dist < two_r;
      dyn = dyn + (coincident ? -tsign((float)(dx * h + dy)) : 0.0f);
      const float inv = overlap ? 1.0f / dist : 0.0f;
      const float nx = ddx * inv;
      const float ny = ddy * inv;
      const float rvx = c_vx - t.vx[lo];
      const float rvy = c_vy - t.vy[lo];
      const float imp_n = ecoeff * (rvx * nx + rvy * ny);
      const float max_fric = imp_n * friction;
      const float imp_t = tmin(tmax(rvx * -ny + rvy * nx, -max_fric),
                               max_fric);
      const float ovf = overlap ? 1.0f : 0.0f;
      dvx = dvx - (imp_n * nx + imp_t * -ny) * ovf;
      dvy = dvy - (imp_n * ny + imp_t * nx) * ovf;
      const float clip = (two_r - dist) * 0.5f * inv_dt2;
      dax = dax - nx * clip * ovf;
      day = day - ny * clip * ovf;
    }
  }
  out[g] = dvx;
  out[WH + g] = dvy;
  out[2 * WH + g] = dax;
  out[3 * WH + g] = day;
  out[4 * WH + g] = dyn;
}

}  // namespace

// Device pointers: px py vx vy (f32 [W, H]), alive (bool [W, H]), out
// (f32 [5, W, H]: dvx dvy dax day dyn).  1 <= stencil <= 8.
extern "C" int sb_collide_stencil(const float* px, const float* py,
                                  const float* vx, const float* vy,
                                  const bool* alive, float* out, float two_r,
                                  float inv_dt2, float ecoeff, float friction,
                                  int w, int h, int stencil, void* stream) {
  dim3 block(TY, TX);
  dim3 grid((h + TY - 1) / TY, (w + TX - 1) / TX);
  collide_stencil_kernel<<<grid, block, tile_smem_bytes(stencil),
                           (cudaStream_t)stream>>>(
      px, py, vx, vy, alive, out, two_r, inv_dt2, ecoeff, friction, w, h,
      stencil);
  return (int)cudaGetLastError();
}
