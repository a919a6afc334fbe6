// K8: the far apply's pair step, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  On the TPU the pair step is XLA's fusion of
// softbody_tpu/ops/farfield4.py (far_terms_from_mirror and
// far_delta_planes_narrow: a gather of record rows, masked window
// selects, farfield.far_pair_contributions, the inverse placement and a
// scatter-add); on the card the same steps as torch ops cost ~40
// elementwise launches over [k, 16, 16] tensors and a sorted scatter
// each substep.  Two kernels take their place:
//
// K8a (far_pairs_kernel): one block of 256 threads per list slot below
// the rung's capacity k.  A slot whose valid byte is 0 exits at once.
// Otherwise threads 0..31 read both sides' 4 x 4 windows (px py vx vy
// alive) straight from the planes into shared memory; a cell past the
// plane (in the tile-padded width, or past h) reads as dead, as the
// record table's zero pad gives.  Thread t then computes the cell pair
// (A cell t/16, B cell t%16) in registers with the operation sequence of
// farfield.far_pair_terms (the correctly rounded sqrtf and division of
// a build without fast math; -fmad=false keeps each product rounded) and
// leaves its five terms in shared memory.  Threads 0..79 sum the A side's
// rows and threads 80..159 the B side's columns, each over the 16
// partner cells in ascending order from +0.0, and write the row sums and
// the exact negation of the column sums to scratch[2k, 80] (row = side:
// A slots first, then B slots; 80 = 5 fields x 16 cells, cell = 4 ix +
// iy).
//
// K8b (far_accumulate_kernel): one thread per cell of the delta planes
// [5, wo, ho].  The cell's chunk has a run of entries in the destination
// order (far_apply.py, dest_order: each chunk's sides, A sides by
// ascending slot then B sides by ascending slot, as stencil.index_sum
// sums them), built once per rebuild from the full list.  The thread
// adds the scratch rows of the run's entries that are valid at this
// substep (slot < k and valid[slot]), in run order from +0.0, and writes
// its five sums: every cell is written, untouched ones with zeros.  A
// run is summed by one thread, so a chunk named by many sides (a pile)
// costs that thread one dependent load chain per entry; the loop keeps
// four entries' loads in flight.
//
// What bounds them on the card: bytes.  A valid pair's 256 cell pairs
// cost ~45 flops each (~11.5 kflop) against 2 x 80 floats read and 2 x
// 80 written; K8b writes the five planes once (20 MB at 1M, ~6 us at
// 3.35 TB/s) and reads each touched scratch row once per cell.  So K8a
// keeps the terms in registers and shared memory (the torch chain wrote
// and re-read [k, 16, 16] tensors ~40 times), and K8b writes each cell
// once, coalesced along h, with no zero pass and no sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 4;              // chunk side
constexpr int CC = C * C;         // cells per chunk
constexpr int NF = 5;             // dvx dvy dax day dyn / px py vx vy alive
constexpr int ROW = NF * CC;      // floats per side row of the scratch
constexpr int PAIR_THREADS = CC * CC;
constexpr int ACC_THREADS = 256;
// shared memory of K8a: both windows, then the terms [NF][CC][CC + 1]
constexpr int WIN_FLOATS = 2 * NF * CC;
constexpr int TERM_STRIDE = CC + 1;
constexpr int PAIR_SMEM = (WIN_FLOATS + NF * CC * TERM_STRIDE) * 4;

struct Planes {
  const float* f[NF];   // px py vx vy alive (0/1)
  long long sx, sy;     // element strides, shared by the five
  int w, h;             // the planes' own extent
};

struct Scalars {
  float two_r, dt2, ecoeff, friction;
  const float* ecoeff_dev;     // read in device memory where not null
  const float* friction_dev;
};

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// grid k, block 256, dynamic shared memory PAIR_SMEM
__global__ void __launch_bounds__(PAIR_THREADS)
far_pairs_kernel(const Planes planes, const long long* __restrict__ ca,
                 const long long* __restrict__ cb,
                 const bool* __restrict__ valid, float* __restrict__ scratch,
                 int k, int cwy, long long world_h, int s,
                 const Scalars sc) {
  const int slot = blockIdx.x;
  if (!valid[slot]) return;
  extern __shared__ float smem[];
  float* win = smem;                       // [2][NF][CC]
  float* terms = smem + WIN_FLOATS;        // [NF][CC][TERM_STRIDE]
  const int t = threadIdx.x;
  const long long ida = ca[slot];
  const long long idb = cb[slot];
  if (t < 2 * CC) {
    const int side = t / CC;
    const int cell = t % CC;
    const long long id = side ? idb : ida;
    const long long x = (id / cwy) * C + cell / C;
    const long long y = (id % cwy) * C + cell % C;
    const bool in = x < planes.w && y < planes.h;
    const long long at = x * planes.sx + y * planes.sy;
    for (int f = 0; f < NF; ++f)
      win[(side * NF + f) * CC + cell] = in ? planes.f[f][at] : 0.0f;
  }
  __syncthreads();
  const int i = t / CC;   // A cell
  const int j = t % CC;   // B cell
  const long long ax = (ida / cwy) * C + i / C;
  const long long ay = (ida % cwy) * C + i % C;
  const long long bx = (idb / cwy) * C + j / C;
  const long long by = (idb % cwy) * C + j % C;
  const long long alin = ax * world_h + ay;
  const long long blin = bx * world_h + by;
  const long long dxi = ax > bx ? ax - bx : bx - ax;
  const long long dyi = ay > by ? ay - by : by - ay;
  const long long cheb = dxi > dyi ? dxi : dyi;
  const float* A = win;
  const float* B = win + NF * CC;
  const bool pair = A[4 * CC + i] > 0.0f && B[4 * CC + j] > 0.0f &&
                    cheb > s && (ida != idb || alin < blin);
  const float ddx = B[0 * CC + j] - A[0 * CC + i];
  const float ddy = B[1 * CC + j] - A[1 * CC + i];
  const float d2 = ddx * ddx + ddy * ddy;
  const float dist = sqrtf(d2);
  const bool coincident = pair && dist == 0.0f;
  const bool overlap = pair && dist > 0.0f && dist < sc.two_r;
  const float co = coincident ? (alin < blin ? -1.0f
                                             : (alin > blin ? 1.0f : 0.0f))
                              : 0.0f;
  const float inv = overlap ? 1.0f / dist : 0.0f;
  const float nx = ddx * inv;
  const float ny = ddy * inv;
  const float rvx = A[2 * CC + i] - B[2 * CC + j];
  const float rvy = A[3 * CC + i] - B[3 * CC + j];
  const float ecoeff = sc.ecoeff_dev ? *sc.ecoeff_dev : sc.ecoeff;
  const float friction = sc.friction_dev ? *sc.friction_dev : sc.friction;
  const float imp_n = ecoeff * (rvx * nx + rvy * ny);
  const float max_fric = imp_n * friction;
  const float imp_t =
      nan_min(nan_max(rvx * -ny + rvy * nx, -max_fric), max_fric);
  const float clip = (sc.two_r - dist) * 0.5f / sc.dt2;
  const float term[NF] = {
      overlap ? -(imp_n * nx + imp_t * -ny) : 0.0f,
      overlap ? -(imp_n * ny + imp_t * nx) : 0.0f,
      overlap ? -nx * clip : 0.0f,
      overlap ? -ny * clip : 0.0f,
      co,
  };
  for (int f = 0; f < NF; ++f)
    terms[(f * CC + i) * TERM_STRIDE + j] = term[f];
  __syncthreads();
  if (t < ROW) {
    // A side: cell i's row over the B cells
    const int f = t / CC;
    const int a = t % CC;
    float acc = 0.0f;
    for (int b = 0; b < CC; ++b) acc += terms[(f * CC + a) * TERM_STRIDE + b];
    scratch[(long long)slot * ROW + t] = acc;
  } else if (t < 2 * ROW) {
    // B side: cell b's column over the A cells, negated
    const int f = (t - ROW) / CC;
    const int b = (t - ROW) % CC;
    float acc = 0.0f;
    for (int a = 0; a < CC; ++a) acc += terms[(f * CC + a) * TERM_STRIDE + b];
    scratch[((long long)k + slot) * ROW + (t - ROW)] = -acc;
  }
}

// grid ceil(wo*ho / 256), block 256
__global__ void __launch_bounds__(ACC_THREADS)
far_accumulate_kernel(const float* __restrict__ scratch,
                      const long long* __restrict__ sides,
                      const int* __restrict__ offsets,
                      const bool* __restrict__ valid, int k, int capacity,
                      int cwy, float* __restrict__ out, int wo, int ho) {
  const long long n = (long long)wo * ho;
  const long long idx = (long long)blockIdx.x * ACC_THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx / ho);
  const int y = (int)(idx - (long long)x * ho);
  const long long chunk = (long long)(x / C) * cwy + y / C;
  const int cell = (x % C) * C + y % C;
  float acc[NF] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int end = k > 0 ? offsets[chunk + 1] : 0;
  // an entry not valid now adds +0.0 (the sums start from +0.0, so none
  // is ever -0.0 and x + 0.0 == x): no branch, and the unrolled loads of
  // several entries are in flight at once on a long run
#pragma unroll 4
  for (int e = offsets[chunk]; e < end; ++e) {
    const long long side = sides[e];
    const bool b_side = side >= capacity;
    const long long slot = b_side ? side - capacity : side;
    const bool on = slot < k && valid[slot < k ? slot : 0];
    const float* row =
        scratch + (on ? ((b_side ? k : 0) + slot) * ROW + cell : 0);
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] += on ? row[f * CC] : 0.0f;
  }
  for (int f = 0; f < NF; ++f) out[f * n + idx] = acc[f];
}

}  // namespace

// K8a: the pair terms of the first k list slots.  px..alive: device
// pointers of five [w, h] planes with the element strides (sx, sy);
// ca, cb: int64 chunk ids (cx * cwy + cy), valid: bool, each [k]; out:
// scratch [2k, 80].  ecoeff_dev / friction_dev: device floats read in
// place of ecoeff / friction where not null.
extern "C" int sb_far_pairs(const float* px, const float* py,
                            const float* vx, const float* vy,
                            const float* alive, long long sx, long long sy,
                            int w, int h, const long long* ca,
                            const long long* cb, const bool* valid, int k,
                            int cwy, long long world_h, int s, float two_r,
                            float dt2, float ecoeff, float friction,
                            const float* ecoeff_dev,
                            const float* friction_dev, float* scratch,
                            void* stream) {
  if (k < 0 || w < 0 || h < 0 || cwy <= 0 || world_h <= 0)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  const Planes planes = {{px, py, vx, vy, alive}, sx, sy, w, h};
  const Scalars sc = {two_r, dt2, ecoeff, friction, ecoeff_dev,
                      friction_dev};
  far_pairs_kernel<<<k, PAIR_THREADS, PAIR_SMEM, (cudaStream_t)stream>>>(
      planes, ca, cb, valid, scratch, k, cwy, world_h, s, sc);
  return (int)cudaGetLastError();
}

// K8b: the delta planes out [5, wo, ho] (contiguous) from the scratch
// rows of K8a, each chunk's run of the destination order (sides [2 *
// capacity] int64, offsets [chunks + 1] int32) summed in order over the
// sides valid now (slot < k, valid [k] bool).
extern "C" int sb_far_accumulate(const float* scratch, const long long* sides,
                                 const int* offsets, const bool* valid,
                                 int k, int capacity, int cwy, float* out,
                                 int wo, int ho, void* stream) {
  if (k < 0 || capacity < k || cwy <= 0 || wo < 0 || ho < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)wo * ho;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + ACC_THREADS - 1) / ACC_THREADS;
  if (blocks > 0x7fffffffLL || NF * n > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  far_accumulate_kernel<<<(unsigned)blocks, ACC_THREADS, 0,
                          (cudaStream_t)stream>>>(
      scratch, sides, offsets, valid, k, capacity, cwy, out, wo, ho);
  return (int)cudaGetLastError();
}
