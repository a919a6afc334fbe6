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
// ~37 MB, ~11 us at 3.35 TB/s.  Counted once per unordered pair, the
// arithmetic is below that; evaluated in full at both ends of every
// offset (an IEEE square root and divide each, multi-instruction
// sequences without fast math) it took eight times as long.
//
// What the design does about it:
// - an exact skip for pairs that cannot touch: a pair whose squared
//   distance is finite and above (2r)^2 by more than rounding adds only
//   signed zeros (below), so the thread moves on after six operations on
//   the staged positions, without the square root, the divide, the
//   velocities or the liveness;
// - one thread per particle on an 8 (W) x 32 (H, fastest index) tile of
//   256 threads, every plane store a coalesced 128-byte row; the tile
//   plus a halo of s is staged with cp.async (zero fill outside the grid:
//   the JAX zero pad, dead particles at the origin) without an index
//   division, as (x, y) pairs for positions and velocities, so a partner
//   costs one 8-byte shared load;
// - the planes are read where they lie: px py vx vy take any strides, and
//   the interleaved [W, H, 2] views of a state's pos / vel (element
//   stride 2) are staged with one 8-byte copy per pair, so path A makes
//   no contiguous copies before the kernel;
// - the offset loops are unrolled for stencils 1-3 (the partner's shared
//   address is an immediate).
//
// Exactness: terms are masked by multiplying with ovf (1.0 / 0.0) as the
// TPU kernel does (a non-finite term gives NaN, not 0); 1/dt^2 is a
// multiply by inv_dt2 computed on the host (in the DEVC instances by
// each thread, from dt, with the same float32 division); the coincident
// nudge
// sign(lin_i - lin_j) with lin = x*H + y is -sign(dx*H + dy), from the
// index (exact in float32 below 2^24, and at 1M lin <= 999,999).  Built
// with -fmad=false and without fast math, the deltas equal the plain
// version's bit for bit.
//
// The skip.  A pair with dist > 2r is neither coincident nor overlapping,
// so inv = 0, nx = ddx * 0, ny = ddy * 0 and ovf = 0.  When ddx, ddy, both
// velocities, ecoeff, friction and clip = (2r - dist) * 0.5 * inv_dt2 are
// finite, every term is then a product with a signed zero: dvx dvy dax
// day take -(+-0) and dyn +0.  The accumulators start at +0 and are only
// ever updated by acc - t or acc + t, which in round-to-nearest gives -0
// only from -0 operands, so they never hold -0; acc -+ (+-0) is then acc,
// bit for bit, and the pair may be skipped.  d2 > (2r)^2 * 1.00001 (both
// rounded) makes dist > 2r certain; d2 <= FLT_MAX makes ddx, ddy and dist
// finite; the velocities are checked once per block while staging (a
// block with a non-finite velocity anywhere in its tile takes the full
// path for every pair), the constants once per launch on the host (clip
// at the largest finite dist included).  tests/test_torch_collide.py
// holds these facts on the plain version's terms, and
// tests/test_torch_kernel_emulation.py this source against the plain
// version on tiles with non-finite velocities, dead particles holding
// garbage and constants that overflow clip.

#include <math.h>

#include "lattice_device.cuh"

namespace {

constexpr int K3_TX = 8;    // W rows per block (threadIdx.y)
constexpr int K3_TY = 32;   // H lanes per block (threadIdx.x)
constexpr int K3_THREADS = K3_TX * K3_TY;
constexpr float F32_MAX = 3.402823466e38f;

// px py vx vy: element (x, y) of plane k at base[k] + x * sx[k] + y * sy[k]
struct Planes {
  const float* base[4];
  long long sx[4], sy[4];
};

// Dynamic shared memory at stencil radius s: positions and velocities as
// (x, y) pairs, liveness as bytes, each (K3_TX + 2s) x (K3_TY + 2s).
__host__ __device__ __forceinline__ size_t k3_smem_bytes(int s) {
  return (size_t)(K3_TX + 2 * s) * (K3_TY + 2 * s) * (4 * sizeof(float) + 1);
}

// DEVC's constants: the head of a consts vector (radius 0, dt 1, ecoeff
// 7, friction 8), copied in from device memory before each launch
constexpr int K3_NDEV = 9;
__constant__ float k3_consts_dev[K3_NDEV];

__device__ __forceinline__ void cp_async_f32x2(float* dst, const float* src,
                                               bool in) {
  // src-size 0 copies nothing and zero-fills the 8 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__host__ __device__ __forceinline__ bool finite32(float v) {
  return fabsf(v) <= F32_MAX;  // false for +-inf and NaN
}

// PAIRS: py = px + 1 and vy = vx + 1 with element stride 2 (the
// interleaved [W, H, 2] views), 8-byte aligned.  S > 0: the stencil
// radius at compile time; S == 0 takes it from s.  DEVC: the scalars from
// k3_consts_dev (a consts vector's head, copied from device memory by the
// entry just before the launch, as K1's; 2r and 1/dt^2 formed as the
// host forms them); else the parameters.
template <bool PAIRS, int S, bool DEVC>
__global__ void __launch_bounds__(K3_THREADS)
collide_stencil_kernel(const Planes p, const uint8_t* __restrict__ alive_g,
                       float* __restrict__ out, float two_r_p,
                       float inv_dt2_p, float ecoeff_p, float friction_p,
                       int consts_finite, int w, int h, int s_rt) {
  extern __shared__ float smem[];
  const int s = S > 0 ? S : s_rt;
  const int SX = K3_TX + 2 * s;
  const int SY = K3_TY + 2 * s;
  const int SN = SX * SY;
  float2* s_pos = reinterpret_cast<float2*>(smem);
  float2* s_vel = s_pos + SN;
  uint8_t* s_al = reinterpret_cast<uint8_t*>(s_vel + SN);
  const int x0 = blockIdx.y * K3_TX;
  const int y0 = blockIdx.x * K3_TY;

  // ---- stage the tile plus halo: warp y takes rows y, y + K3_TX, ... --
  for (int row = threadIdx.y; row < SX; row += K3_TX) {
    const int gx = x0 - s + row;
    const bool row_in = gx >= 0 && gx < w;
    for (int col = threadIdx.x; col < SY; col += K3_TY) {
      const int gy = y0 - s + col;
      const bool in = row_in && gy >= 0 && gy < h;
      const long long cx = in ? gx : 0, cy = in ? gy : 0;
      const int i = row * SY + col;
      if (PAIRS) {
        cp_async_f32x2(&s_pos[i].x, p.base[0] + cx * p.sx[0] + 2 * cy, in);
        cp_async_f32x2(&s_vel[i].x, p.base[2] + cx * p.sx[2] + 2 * cy, in);
      } else {
        cp_async_f32(&s_pos[i].x, p.base[0] + cx * p.sx[0] + cy * p.sy[0],
                     in);
        cp_async_f32(&s_pos[i].y, p.base[1] + cx * p.sx[1] + cy * p.sy[1],
                     in);
        cp_async_f32(&s_vel[i].x, p.base[2] + cx * p.sx[2] + cy * p.sy[2],
                     in);
        cp_async_f32(&s_vel[i].y, p.base[3] + cx * p.sx[3] + cy * p.sy[3],
                     in);
      }
      s_al[i] = in ? alive_g[cx * h + cy] : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_wait();

  // ---- the skip holds in this block if every staged velocity is finite
  int vel_finite = 1;
  for (int row = threadIdx.y; row < SX; row += K3_TX) {
    for (int col = threadIdx.x; col < SY; col += K3_TY) {
      const float2 v = s_vel[row * SY + col];
      vel_finite &= finite32(v.x) & finite32(v.y);
    }
  }
  const bool fast = __syncthreads_and(vel_finite) && consts_finite;

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const size_t WH = (size_t)w * h;
  const int lc = (threadIdx.y + s) * SY + threadIdx.x + s;
  const float2 c_pos = s_pos[lc];
  const float2 c_vel = s_vel[lc];
  const bool c_al = s_al[lc] != 0;
  const float two_r = DEVC ? 2.0f * k3_consts_dev[0] : two_r_p;
  const float inv_dt2 =
      DEVC ? 1.0f / (k3_consts_dev[1] * k3_consts_dev[1]) : inv_dt2_p;
  const float ecoeff = DEVC ? k3_consts_dev[7] : ecoeff_p;
  const float friction = DEVC ? k3_consts_dev[8] : friction_p;
  const float skip_d2 = two_r * two_r * 1.00001f;

  float dvx = 0.0f, dvy = 0.0f, dax = 0.0f, day = 0.0f, dyn = 0.0f;
#pragma unroll
  for (int dx = -s; dx <= s; ++dx) {
#pragma unroll
    for (int dy = -s; dy <= s; ++dy) {
      if (dx == 0 && dy == 0) continue;
      const int lo = lc + dx * SY + dy;
      const float2 q = s_pos[lo];
      const float ddx = q.x - c_pos.x;
      const float ddy = q.y - c_pos.y;
      const float d2 = ddx * ddx + ddy * ddy;
      if (fast && d2 > skip_d2 && d2 <= F32_MAX) continue;  // +-0 terms
      const bool valid = c_al && s_al[lo] != 0;
      const float dist = sqrtf(d2);
      const bool coincident = valid && dist == 0.0f;
      const bool overlap = valid && dist > 0.0f && dist < two_r;
      dyn = dyn + (coincident ? -tsign((float)(dx * h + dy)) : 0.0f);
      const float inv = overlap ? 1.0f / dist : 0.0f;
      const float nx = ddx * inv;
      const float ny = ddy * inv;
      const float2 qv = s_vel[lo];
      const float rvx = c_vel.x - qv.x;
      const float rvy = c_vel.y - qv.y;
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

// The skip's conditions on the constants: ecoeff, friction, 2r and
// 1/dt^2 finite, (2r)^2 a normal float, and clip finite at the largest
// finite distance (clip is monotonic in dist, 0 at dist = 2r).
bool consts_allow_skip(float two_r, float inv_dt2, float ecoeff,
                       float friction) {
  const float sq = two_r * two_r * 1.00001f;
  const float clip_far = (two_r - sqrtf(F32_MAX)) * 0.5f * inv_dt2;
  return finite32(ecoeff) && finite32(friction) && finite32(two_r) &&
         finite32(inv_dt2) && finite32(sq) && sq >= 1.17549435e-38f &&
         finite32(clip_far);
}

using K3Kernel = void (*)(const Planes, const uint8_t*, float*, float, float,
                         float, float, int, int, int, int);

// The kernel for a layout and a stencil radius (unrolled for 1-3).
template <bool PAIRS, bool DEVC>
K3Kernel k3_kernel(int stencil) {
  switch (stencil) {
    case 1: return collide_stencil_kernel<PAIRS, 1, DEVC>;
    case 2: return collide_stencil_kernel<PAIRS, 2, DEVC>;
    case 3: return collide_stencil_kernel<PAIRS, 3, DEVC>;
    default: return collide_stencil_kernel<PAIRS, 0, DEVC>;
  }
}

// The interleaved layout of the pair copies: (px, py) and (vx, vy) each
// one [W, H, 2] view, 8-byte aligned, row strides even.
bool interleaved(const Planes& p) {
  for (int k = 0; k < 4; k += 2) {
    if (p.base[k + 1] != p.base[k] + 1 || p.sy[k] != 2 || p.sy[k + 1] != 2 ||
        p.sx[k] != p.sx[k + 1] || p.sx[k] % 2 != 0 ||
        (uintptr_t)p.base[k] % 8 != 0)
      return false;
  }
  return true;
}

// `cdev`: the consts vector in device memory (the scalars then read
// there, `finite` the host's skip decision); null: the scalars given.
int run_k3(const Planes& p, const bool* alive, float* out, float two_r,
           float inv_dt2, float ecoeff, float friction, int w, int h,
           int stencil, void* stream, const float* cdev = nullptr,
           int finite = 0) {
  if (stencil < 1 || stencil > 8) return (int)cudaErrorInvalidValue;
  const bool devc = cdev != nullptr;
  const bool pairs = interleaved(p);
  const K3Kernel kernel =
      devc ? (pairs ? k3_kernel<true, true>(stencil)
                    : k3_kernel<false, true>(stencil))
           : (pairs ? k3_kernel<true, false>(stencil)
                    : k3_kernel<false, false>(stencil));
  if (devc) {
    void* bank = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&bank, k3_consts_dev);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(bank, cdev, sizeof(k3_consts_dev),
                            cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    finite = consts_allow_skip(two_r, inv_dt2, ecoeff, friction);
  }
  dim3 block(K3_TY, K3_TX);
  dim3 grid((h + K3_TY - 1) / K3_TY, (w + K3_TX - 1) / K3_TX);
  kernel<<<grid, block, k3_smem_bytes(stencil), (cudaStream_t)stream>>>(
      p, reinterpret_cast<const uint8_t*>(alive), out, two_r, inv_dt2,
      ecoeff, friction, finite, w, h, stencil);
  return (int)cudaGetLastError();
}

}  // namespace

// Device pointers: px py vx vy (contiguous f32 [W, H]), alive (bool
// [W, H]), out (f32 [5, W, H]: dvx dvy dax day dyn).  1 <= stencil <= 8.
extern "C" int sb_collide_stencil(const float* px, const float* py,
                                  const float* vx, const float* vy,
                                  const bool* alive, float* out, float two_r,
                                  float inv_dt2, float ecoeff, float friction,
                                  int w, int h, int stencil, void* stream) {
  const Planes p = {{px, py, vx, vy}, {h, h, h, h}, {1, 1, 1, 1}};
  return run_k3(p, alive, out, two_r, inv_dt2, ecoeff, friction, w, h,
                stencil, stream);
}

// As sb_collide_stencil, with px py vx vy at any strides: `strides_host`
// (host, 8 values) holds each plane's (row, element) strides in floats.
// The interleaved views of a [W, H, 2] pos / vel pair are staged as
// pairs.  `alive` is contiguous.
extern "C" int sb_collide_stencil_strided(
    const float* px, const float* py, const float* vx, const float* vy,
    const long long* strides_host, const bool* alive, float* out,
    float two_r, float inv_dt2, float ecoeff, float friction, int w, int h,
    int stencil, void* stream) {
  Planes p = {{px, py, vx, vy}, {0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k = 0; k < 4; ++k) {
    p.sx[k] = strides_host[2 * k];
    p.sy[k] = strides_host[2 * k + 1];
  }
  return run_k3(p, alive, out, two_r, inv_dt2, ecoeff, friction, w, h,
                stencil, stream);
}

// As sb_collide_stencil_strided, with the scalars in device memory:
// `consts_dev` is a consts vector (config.consts_vector order; radius,
// dt, ecoeff and friction read at 0, 1, 7 and 8, its first 9 floats
// copied into the kernel's constant bank on `stream` before the launch)
// and `skip` whether they
// allow the skip (consts_allow_skip, decided on the host from the same
// values).  A captured graph replays with whatever the buffer holds.
extern "C" int sb_collide_stencil_dev(
    const float* px, const float* py, const float* vx, const float* vy,
    const long long* strides_host, const bool* alive, float* out,
    const float* consts_dev, int skip, int w, int h, int stencil,
    void* stream) {
  if (consts_dev == nullptr) return (int)cudaErrorInvalidValue;
  Planes p = {{px, py, vx, vy}, {0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k = 0; k < 4; ++k) {
    p.sx[k] = strides_host[2 * k];
    p.sy[k] = strides_host[2 * k + 1];
  }
  return run_k3(p, alive, out, 0.0f, 0.0f, 0.0f, 0.0f, w, h, stencil,
                stream, consts_dev, skip != 0);
}

// Residency of the interleaved (path A) kernel at `stencil & 255`, as
// sb_fused_substep2_occupancy reports K1's (bit 16: the instance with the
// scalars from device memory).
extern "C" int sb_collide_stencil_occupancy(int stencil, int* out) {
  const bool devc = (stencil >> 16) & 1;
  stencil &= 255;
  const size_t smem = k3_smem_bytes(stencil);
  const K3Kernel kernel =
      devc ? k3_kernel<true, true>(stencil) : k3_kernel<true, false>(stencil);
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, kernel);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, K3_THREADS, smem);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  out[4] = K3_THREADS;
  return err;
}
