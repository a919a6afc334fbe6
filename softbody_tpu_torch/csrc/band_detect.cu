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
// What bounds it on the card: float32 operations.  It reads 4 planes and
// the alive mask once per rebuild (~17 MB at 1M, ~5 us) and writes one
// byte per particle, but in the untorn sheet no offset hits (index
// distances of 3 spacings and more, reach ~1.45 spacings), so every
// alive particle compares against all ~100 partners: 7 operations each,
// 0.7 Gop at 1M (~10 us at 67 TFLOP/s), and each compare needs three
// staged values.
//
// What the design does about it:
// - an exact test on one axis first: a pair can hit only if |ddx| and
//   |ddy| are both below rb = max(|max bdev_i + max dev_j|,
//   |min bdev_i + min dev_j|), the thread's own cells' range against the
//   dev range of its partner rows (each staged row's range is reduced
//   once while staging).  Every step is monotone, so |ddx| >= rb gives
//   d2 >= ddx^2 >= rb^2 >= reach^2 (no hit); NaN fails both tests.  Per
//   dy the kernel tests the axis along which the partners lie apart (x
//   where every dx of the dy is at least |dy|, else y): one shared load
//   per partner row and two operations per compare, where the exact
//   compare needs three loads and eight.  Only a dy on which some pair of
//   the thread passes takes the exact compares; in the untorn sheet none
//   does;
// - each thread owns a column of CX = 4 cells along W; for each dy it
//   loads the CX + 7 partner rows it needs once into registers and tests
//   each against every own cell whose offset (dx = partner row - cell
//   row) is in the band: 11 shared loads serve up to 32 compares (8 cells
//   per thread measured slower: 91 registers, 20 warps per SM);
// - the offsets are a per-dy bitmask of dx in [0, 8) (chunk <= 4, as the
//   TPU kernel requires), passed as a __grid_constant__ parameter: the dy
//   loop reads its mask from the parameter space, never a local copy,
//   and the dx and cell loops are unrolled, so a partner's address and
//   each compare's registers are fixed at compile time;
// - dead and out-of-grid partners are staged at px = py = +inf: ddx and
//   ddy are then +-inf or NaN, both tests fail, and d2 < reach^2 is false
//   as the plain version's alive & shifted(alive) mask makes it, with no
//   liveness load or bounds check in the inner loop (an alive partner at
//   +inf compares false in both);
// - the tile (16 W rows x 32 H lanes, 4 warps) plus its halo (7 rows
//   after it, 7 lanes each side) is staged by coalesced row copies, a
//   warp per row with its loads independent of each other, without an
//   index division;
// - a warp stops when each of its live cells has a hit (__all_sync per
//   dy), the first hit ending the search as in the TPU kernel.
//
// One change from the TPU kernel: liveness of the particle itself is an
// explicit mask (the TPU kernel encodes dead cells as px = 3e8 and so
// reads alive particles at px >= 1e8 as dead).
//
// Wider bands (chunk > 4, band radius r = 2 chunk - 1 > 7; the TPU kernel
// takes none) go to a second kernel, band_kernel_wide, whose box is set at
// launch: dx in [0, r + 1), |dy| <= r, the tile's halo staged in dynamic
// shared memory sized from r (above 48 KB after cudaFuncSetAttribute; up
// to chunk 32 within the H100's 227 KB per block), a per-dy mask of 64
// bits.  It keeps the staging, the one-axis pre-test and the exact compare
// of band_kernel, with the partner rows read from shared memory in the
// dx loop (their count is no longer fixed at compile time); chunk <= 4
// keeps band_kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_device.cuh"

namespace {

constexpr int CX = 4;                    // W cells per thread
constexpr int WARPS = 4;                 // per block, stacked along W
constexpr int LANES = 32;                // H lanes per block (threadIdx.x)
constexpr int BX = CX * WARPS;           // W rows per block
constexpr int DXN = 8;                   // band dx in [0, DXN)
constexpr int DYR = 7;                   // band dy in [-DYR, DYR]
constexpr int NDY = 2 * DYR + 1;
constexpr int PR = CX + DXN - 1;         // partner rows per thread and dy
constexpr int SX = BX + DXN - 1;         // staged rows
constexpr int SY = LANES + 2 * DYR;      // staged lanes
constexpr int SN = SX * SY;
// px py dev planes, then each staged row's dev max and min (order keys)
constexpr size_t SMEM_BYTES = (3 * SN + 2 * SX) * sizeof(float);

// float -> unsigned key with the floats' order (NaN excluded by callers)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// bit dx of m[dy + DYR]: the offset (dx, dy) is in the band
struct BandMask {
  uint32_t m[NDY];
};

__global__ void __launch_bounds__(LANES * WARPS)
band_kernel(const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ dev, const float* __restrict__ bdev,
            const uint8_t* __restrict__ alive, uint8_t* __restrict__ out,
            const __grid_constant__ BandMask mask, int w, int h) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = smem + SN;
  float* s_dev = smem + 2 * SN;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + 3 * SN);
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.y * BX;
  const int y0 = blockIdx.x * LANES;

  // ---- stage rows x0 .. x0 + SX - 1, lanes y0 - DYR .. y0 + LANES + DYR
  // (a warp per row, its loads independent of each other), and each
  // row's range of dev (NaN left out: its compares fail)
#pragma unroll
  for (int i = 0; i < (SX + WARPS - 1) / WARPS; ++i) {
    const int row = warp + i * WARPS;
    if (row >= SX) break;
    const int gx = x0 + row;
    uint32_t kmax = 0u, kmin = 0xffffffffu;
#pragma unroll
    for (int c = 0; c < (SY + LANES - 1) / LANES; ++c) {
      const int col = lane + c * LANES;
      const int gy = y0 - DYR + col;
      const bool in = col < SY && gx < w && gy >= 0 && gy < h;
      const size_t g = in ? (size_t)gx * h + gy : 0;
      const bool a = in && alive[g];
      const float p = in ? px[g] : 0.0f;
      const float q = in ? py[g] : 0.0f;
      const float d = in ? dev[g] : 0.0f;
      if (col < SY) {
        s_px[row * SY + col] = a ? p : INFINITY;
        s_py[row * SY + col] = a ? q : INFINITY;
        s_dev[row * SY + col] = d;
        if (d == d) {
          kmax = max(kmax, order_key(d));
          kmin = min(kmin, order_key(d));
        }
      }
    }
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    if (lane == 0) {
      s_key[2 * row] = kmax;
      s_key[2 * row + 1] = kmin;
    }
  }
  __syncthreads();
  // the dev range of this thread's partner rows r0 .. r0 + PR - 1
  const int r0 = warp * CX;
  uint32_t kmax = 0u, kmin = 0xffffffffu;
#pragma unroll
  for (int q = 0; q < PR; ++q) {
    kmax = max(kmax, s_key[2 * (r0 + q)]);
    kmin = min(kmin, s_key[2 * (r0 + q) + 1]);
  }

  // ---- own cells: rows r0 .. r0 + CX - 1 of the tile, lane `lane` ----
  const int y = y0 + lane;
  float cpx[CX], cpy[CX], cb[CX];
  bool live[CX], hit[CX];
  bool done = true;
  float cb_max = -INFINITY, cb_min = INFINITY;
#pragma unroll
  for (int j = 0; j < CX; ++j) {
    const int x = x0 + r0 + j;
    const size_t g = (size_t)x * h + y;
    const bool in = x < w && y < h;
    live[j] = in && alive[g];
    cb[j] = live[j] ? bdev[g] : 0.0f;
    cpx[j] = s_px[(r0 + j) * SY + lane + DYR];
    cpy[j] = s_py[(r0 + j) * SY + lane + DYR];
    hit[j] = false;
    done = done && !live[j];
    cb_max = fmaxf(cb_max, cb[j]);
    cb_min = fminf(cb_min, cb[j]);
  }
  // every reach cb[j] + dev_q of this thread lies in [lo, hi]
  // (kmin > kmax: its partner rows hold no dev but NaN; then no compare
  // can hit)
  const float hi = cb_max + key_value(kmax);
  const float lo = cb_min + key_value(kmin);
  const float rb = kmin <= kmax ? fmaxf(fabsf(hi), fabsf(lo)) : 0.0f;

#pragma unroll 1
  for (int k = 0; k < NDY; ++k) {
    if (__all_sync(0xffffffffu, done)) break;
    const uint32_t m = mask.m[k];
    if (m == 0) continue;
    // partner rows r0 + q, q = j + dx, at lane + dy (staged lane + k)
    const int base = r0 * SY + lane + k;
    // the box test on one axis: x where every dx of the dy is at least
    // |dy| (the partners lie apart along W), else y
    const bool by_x = __ffs(m) - 1 >= abs(k - DYR);
    const float* s_axis = by_x ? s_px : s_py;
    float qa[PR], ca[CX];
#pragma unroll
    for (int q = 0; q < PR; ++q) qa[q] = s_axis[base + q * SY];
    // per cell, the least |partner - cell| on that axis (fminf drops NaN:
    // the test may pass more often, never less)
    float box[CX];
#pragma unroll
    for (int j = 0; j < CX; ++j) {
      ca[j] = by_x ? cpx[j] : cpy[j];
      box[j] = INFINITY;
    }
#pragma unroll
    for (int dx = 0; dx < DXN; ++dx) {
      if (!((m >> dx) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < CX; ++j)
        box[j] = fminf(box[j], fabsf(qa[j + dx] - ca[j]));
    }
    float nearest = box[0];
#pragma unroll
    for (int j = 1; j < CX; ++j) nearest = fminf(nearest, box[j]);
    if (nearest < rb) {  // the exact compares of this dy
      float qpx[PR], qpy[PR], qdv[PR];
#pragma unroll
      for (int q = 0; q < PR; ++q) {
        qpx[q] = s_px[base + q * SY];
        qpy[q] = s_py[base + q * SY];
        qdv[q] = s_dev[base + q * SY];
      }
#pragma unroll
      for (int dx = 0; dx < DXN; ++dx) {
        if (!((m >> dx) & 1u)) continue;
#pragma unroll
        for (int j = 0; j < CX; ++j) {
          hit[j] = hit[j] | band_pair_hit(cpx[j], cpy[j], cb[j], qpx[j + dx],
                                          qpy[j + dx], qdv[j + dx]);
        }
      }
    }
    done = true;
#pragma unroll
    for (int j = 0; j < CX; ++j) done = done && (hit[j] || !live[j]);
  }

#pragma unroll
  for (int j = 0; j < CX; ++j) {
    const int x = x0 + r0 + j;
    if (x < w && y < h) out[(size_t)x * h + y] = (live[j] && hit[j]) ? 1 : 0;
  }
}

// ---- the wide band (radius r > DYR, set at launch) ------------------------

// dx < 64: one 64-bit mask per dy.  The staged tile then takes at most
// wide_smem_bytes(63) = 150,416 bytes, within the 227 KB (232,448 bytes)
// of shared memory a block can have on an H100.
constexpr int WIDE_R_MAX = 63;

// bit dx of m[dy + r]: the offset (dx, dy) is in the band
struct WideMask {
  uint64_t m[2 * WIDE_R_MAX + 1];
};

// dynamic shared memory of band_kernel_wide at radius r
size_t wide_smem_bytes(int r) {
  const size_t sx = BX + r, sy = LANES + 2 * r;
  return (3 * sx * sy + 2 * sx) * sizeof(float);
}

__global__ void __launch_bounds__(LANES * WARPS)
band_kernel_wide(const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ dev,
                 const float* __restrict__ bdev,
                 const uint8_t* __restrict__ alive, uint8_t* __restrict__ out,
                 const __grid_constant__ WideMask mask, int r, int w, int h) {
  extern __shared__ float smem[];
  const int sx = BX + r;                 // staged rows (band dx < r + 1)
  const int sy = LANES + 2 * r;          // staged lanes
  const int sn = sx * sy;
  const int pr = CX + r;                 // partner rows per thread and dy
  float* s_px = smem;
  float* s_py = smem + sn;
  float* s_dev = smem + 2 * sn;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + 3 * sn);
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.y * BX;
  const int y0 = blockIdx.x * LANES;

  // ---- stage, as band_kernel (a warp per row) --------------------------
  for (int row = warp; row < sx; row += WARPS) {
    const int gx = x0 + row;
    uint32_t kmax = 0u, kmin = 0xffffffffu;
    for (int c = 0; c < (sy + LANES - 1) / LANES; ++c) {
      const int col = lane + c * LANES;
      const int gy = y0 - r + col;
      const bool in = col < sy && gx < w && gy >= 0 && gy < h;
      const size_t g = in ? (size_t)gx * h + gy : 0;
      const bool a = in && alive[g];
      const float p = in ? px[g] : 0.0f;
      const float q = in ? py[g] : 0.0f;
      const float d = in ? dev[g] : 0.0f;
      if (col < sy) {
        s_px[row * sy + col] = a ? p : INFINITY;
        s_py[row * sy + col] = a ? q : INFINITY;
        s_dev[row * sy + col] = d;
        if (d == d) {
          kmax = max(kmax, order_key(d));
          kmin = min(kmin, order_key(d));
        }
      }
    }
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    if (lane == 0) {
      s_key[2 * row] = kmax;
      s_key[2 * row + 1] = kmin;
    }
  }
  __syncthreads();
  const int r0 = warp * CX;
  uint32_t kmax = 0u, kmin = 0xffffffffu;
  for (int q = 0; q < pr; ++q) {
    kmax = max(kmax, s_key[2 * (r0 + q)]);
    kmin = min(kmin, s_key[2 * (r0 + q) + 1]);
  }

  const int y = y0 + lane;
  float cpx[CX], cpy[CX], cb[CX];
  bool live[CX], hit[CX];
  bool done = true;
  float cb_max = -INFINITY, cb_min = INFINITY;
#pragma unroll
  for (int j = 0; j < CX; ++j) {
    const int x = x0 + r0 + j;
    const size_t g = (size_t)x * h + y;
    const bool in = x < w && y < h;
    live[j] = in && alive[g];
    cb[j] = live[j] ? bdev[g] : 0.0f;
    cpx[j] = s_px[(r0 + j) * sy + lane + r];
    cpy[j] = s_py[(r0 + j) * sy + lane + r];
    hit[j] = false;
    done = done && !live[j];
    cb_max = fmaxf(cb_max, cb[j]);
    cb_min = fminf(cb_min, cb[j]);
  }
  const float hi = cb_max + key_value(kmax);
  const float lo = cb_min + key_value(kmin);
  const float rb = kmin <= kmax ? fmaxf(fabsf(hi), fabsf(lo)) : 0.0f;

#pragma unroll 1
  for (int k = 0; k < 2 * r + 1; ++k) {
    if (__all_sync(0xffffffffu, done)) break;
    const uint64_t m = mask.m[k];
    if (m == 0) continue;
    const int base = r0 * sy + lane + k;
    const bool by_x = __ffsll((long long)m) - 1 >= abs(k - r);
    const float* s_axis = by_x ? s_px : s_py;
    float box[CX], ca[CX];
#pragma unroll
    for (int j = 0; j < CX; ++j) {
      ca[j] = by_x ? cpx[j] : cpy[j];
      box[j] = INFINITY;
    }
    for (uint64_t b = m; b != 0; b &= b - 1) {
      const int dx = __ffsll((long long)b) - 1;
#pragma unroll
      for (int j = 0; j < CX; ++j)
        box[j] = fminf(box[j], fabsf(s_axis[base + (j + dx) * sy] - ca[j]));
    }
    float nearest = box[0];
#pragma unroll
    for (int j = 1; j < CX; ++j) nearest = fminf(nearest, box[j]);
    if (nearest < rb) {  // the exact compares of this dy
      for (uint64_t b = m; b != 0; b &= b - 1) {
        const int dx = __ffsll((long long)b) - 1;
#pragma unroll
        for (int j = 0; j < CX; ++j) {
          const int q = base + (j + dx) * sy;
          hit[j] = hit[j] | band_pair_hit(cpx[j], cpy[j], cb[j], s_px[q],
                                          s_py[q], s_dev[q]);
        }
      }
    }
    done = true;
#pragma unroll
    for (int j = 0; j < CX; ++j) done = done && (hit[j] || !live[j]);
  }

#pragma unroll
  for (int j = 0; j < CX; ++j) {
    const int x = x0 + r0 + j;
    if (x < w && y < h) out[(size_t)x * h + y] = (live[j] && hit[j]) ? 1 : 0;
  }
}

}  // namespace

// Device pointers except `offsets_host` ([n, 2] int32 host array).  The
// offsets lie in dx >= 0; repeats are allowed and order does not matter
// (the flags are an OR).  Offsets in dx [0, 8), |dy| <= 7 (the band of
// chunk <= 4) run band_kernel; a wider band of radius r = max(max dx,
// max |dy|) <= 63 (chunk <= 32) runs band_kernel_wide.
extern "C" int sb_band_flags(const float* px, const float* py,
                             const float* dev, const float* bdev,
                             const uint8_t* alive, uint8_t* out,
                             const int* offsets_host, int n, int w, int h,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  int r = 0;
  for (int k = 0; k < n; ++k) {
    const int dx = offsets_host[2 * k], dy = offsets_host[2 * k + 1];
    if (dx < 0 || dx > WIDE_R_MAX || dy < -WIDE_R_MAX || dy > WIDE_R_MAX)
      return (int)cudaErrorInvalidValue;
    const int reach = dx > abs(dy) ? dx : abs(dy);
    r = reach > r ? reach : r;
  }
  dim3 block(LANES, WARPS);
  dim3 grid((h + LANES - 1) / LANES, (w + BX - 1) / BX);
  if (r <= DYR) {
    BandMask mask = {};
    for (int k = 0; k < n; ++k)
      mask.m[offsets_host[2 * k + 1] + DYR] |= 1u << offsets_host[2 * k];
    band_kernel<<<grid, block, SMEM_BYTES, (cudaStream_t)stream>>>(
        px, py, dev, bdev, alive, out, mask, w, h);
    return (int)cudaGetLastError();
  }
  const size_t smem = wide_smem_bytes(r);
  WideMask mask = {};
  for (int k = 0; k < n; ++k)
    mask.m[offsets_host[2 * k + 1] + r] |= 1ull << offsets_host[2 * k];
  int err = (int)cudaFuncSetAttribute(
      band_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  band_kernel_wide<<<grid, block, smem, (cudaStream_t)stream>>>(
      px, py, dev, bdev, alive, out, mask, r, w, h);
  return (int)cudaGetLastError();
}

// The kernel's residency (the argument is unused: K2 has one shape), as
// sb_fused_substep2_occupancy reports K1's.
extern "C" int sb_band_flags_occupancy(int, int* out) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, band_kernel);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], band_kernel, LANES * WARPS, SMEM_BYTES);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)SMEM_BYTES;
  out[4] = LANES * WARPS;
  return err;
}
