// K2: far-field band detection, hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/band_detect.py:_band_kernel (the
// Pallas TPU kernel launched by band_flag_call).  Plain version: the
// shifted-compare loop of softbody_tpu_torch/ops/cuda/band_detect.py:
// band_flags_plain (the XLA loop of softbody_tpu/ops/farfield.py:403-411).
//
// For each alive particle: does any half-plane offset (dx, dy) of the
// band (index Chebyshev distance in [s+1, 2*chunk-1]; 100 offsets at
// s=2, chunk 4) hold an alive partner with d2 < reach^2, where
// d2 = ddx*ddx + ddy*ddy and reach = (base + dev_i) + dev_j?  The
// caller passes bdev = base + dev_i as a plane, so the association is
// that of the plain version and the flags match it bit for bit (built
// with -fmad=false, no fast math).
//
// What bounds it on the card: device-memory bytes — it reads 4 planes
// and the alive mask once per rebuild (~17 MB at 1M) and writes one
// byte per particle; the ~100 compares per particle come from shared
// memory.  What the design does about it: one thread per particle on a
// 32 (H, fastest index) x 8 (W) tile; the tile plus a halo derived from
// the offsets (not a fixed +-8, so any chunk size works) is staged once
// in shared memory; a thread stops at its first hit.
//
// Two changes from the TPU kernel: liveness is an explicit mask (the TPU
// kernel encodes dead cells as px = 3e8 and so reads alive particles at
// px >= 1e8 as dead), and the halo follows the offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;    // W rows per block
constexpr int TY = 32;   // H lanes per block (threadIdx.x)
constexpr int MAX_OFFSETS = 256;

struct Offsets {
  int n;
  int xlo, xhi, ylo, yhi;  // halo: offsets span [-xlo, xhi] x [-ylo, yhi]
  signed char dx[MAX_OFFSETS];
  signed char dy[MAX_OFFSETS];
};

__global__ void __launch_bounds__(TX * TY)
band_kernel(const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ dev, const float* __restrict__ bdev,
            const uint8_t* __restrict__ alive, uint8_t* __restrict__ out,
            const Offsets offs, int w, int h) {
  extern __shared__ float smem[];
  const int SX = TX + offs.xlo + offs.xhi;
  const int SY = TY + offs.ylo + offs.yhi;
  const int SN = SX * SY;
  float* s_px = smem;
  float* s_py = smem + SN;
  float* s_dev = smem + 2 * SN;
  float* s_al = smem + 3 * SN;
  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;

  for (int i = threadIdx.y * TY + threadIdx.x; i < SN; i += TX * TY) {
    int gx = x0 - offs.xlo + i / SY;
    int gy = y0 - offs.ylo + i % SY;
    float a = 0.0f, p = 0.0f, q = 0.0f, d = 0.0f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      size_t g = (size_t)gx * h + gy;
      a = alive[g] ? 1.0f : 0.0f;
      p = px[g];
      q = py[g];
      d = dev[g];
    }
    s_px[i] = p;
    s_py[i] = q;
    s_dev[i] = d;
    s_al[i] = a;
  }
  __syncthreads();

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const int lc = (threadIdx.y + offs.xlo) * SY + threadIdx.x + offs.ylo;
  bool hit = false;
  if (s_al[lc] > 0.0f) {
    const float cpx = s_px[lc], cpy = s_py[lc], cb = bdev[g];
    for (int k = 0; k < offs.n && !hit; ++k) {
      const int dx = offs.dx[k], dy = offs.dy[k];
      const int qx = x + dx, qy = y + dy;
      if (qx < 0 || qx >= w || qy < 0 || qy >= h) continue;
      const int lp = lc + dx * SY + dy;
      if (!(s_al[lp] > 0.0f)) continue;
      const float ddx = s_px[lp] - cpx;
      const float ddy = s_py[lp] - cpy;
      const float d2 = ddx * ddx + ddy * ddy;
      const float reach = cb + s_dev[lp];
      hit = d2 < reach * reach;
    }
  }
  out[g] = hit ? 1 : 0;
}

}  // namespace

// Device pointers except `offsets_host` ([n, 2] int32 host array).
extern "C" int sb_band_flags(const float* px, const float* py,
                             const float* dev, const float* bdev,
                             const uint8_t* alive, uint8_t* out,
                             const int* offsets_host, int n, int w, int h,
                             void* stream) {
  if (n < 0 || n > MAX_OFFSETS) return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.n = n;
  offs.xlo = offs.xhi = offs.ylo = offs.yhi = 0;
  for (int k = 0; k < n; ++k) {
    const int dx = offsets_host[2 * k], dy = offsets_host[2 * k + 1];
    if (dx < -127 || dx > 127 || dy < -127 || dy > 127)
      return (int)cudaErrorInvalidValue;
    offs.dx[k] = (signed char)dx;
    offs.dy[k] = (signed char)dy;
    offs.xlo = dx < -offs.xlo ? -dx : offs.xlo;
    offs.xhi = dx > offs.xhi ? dx : offs.xhi;
    offs.ylo = dy < -offs.ylo ? -dy : offs.ylo;
    offs.yhi = dy > offs.yhi ? dy : offs.yhi;
  }
  const size_t smem = (size_t)4 * (TX + offs.xlo + offs.xhi) *
                      (TY + offs.ylo + offs.yhi) * sizeof(float);
  dim3 block(TY, TX);
  dim3 grid((h + TY - 1) / TY, (w + TX - 1) / TX);
  band_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      px, py, dev, bdev, alive, out, offs, w, h);
  return (int)cudaGetLastError();
}
