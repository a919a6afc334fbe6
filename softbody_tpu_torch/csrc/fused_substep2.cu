// K1: one whole lattice substep, hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/fused_substep2.py:_kernel2 (the
// Pallas TPU kernel launched by fused_substep2_call), in the instances
// its flags call for: strict, and the JAX kernel's arithmetic variants
// rsqrt, rollgroup and both (its default, rollgroup + rsqrt + dexp2 +
// layout flags; dexp2 is the strict drag's |v|^2 = |v|*|v| already, the
// layout flags are Mosaic's); each also in the modes of the far-field
// frames and of the attribution knobs (MODE, below).  Plain version:
// softbody_tpu_torch/ops/stencil.py (substep_planes, with the same
// flags), reached through softbody_tpu_torch/ops/cuda/fused_substep2.py:
// fused_substep2_plain (the modes' parts: trig_stats_plain,
// detect_side_plain there).
//
// Modes (template bits of MODE; JAX's _kernel2 flags):
// - M_TRIG (`trig`, fused_substep2.py:962-984): the rebuild trigger's
//   partials on the OUTPUT state against the far list's linear reference
//   motion (refs [4,W,H]: px py vx vy at rebuild, tau = consts[40 +
//   X_TAU]): per block the max over alive cells of dd^2 and dv^2 and the
//   sums of vx' and vy', into stats [blocks, 4]; the wrapper reduces the
//   blocks in a fixed order;
// - M_DETECT (`detect`, :405-486): on the INPUT state, per group of 4
//   rows along W and per column, the alive-masked min and max of px py
//   vx vy (fill +-3e38) and the band flag, into side [9, ceil(W/4), H];
//   runtime-gated by consts[40 + X_DET] (off: side is not written).  The
//   block stages a halo of max(s, 7) (the band reaches 7 rows after the
//   tile and 7 lanes each side);
// - M_KNOBS (`nospring`, `noint`, :561-574, :942-949; not physics, the
//   knobs that split the kernel's time): runtime flags: nospring skips
//   the springs and passes the edge and obs planes through, noint passes
//   the six particle planes through.
//
// The constants (consts[0 .. 39]: config.consts_vector, then the edge
// classes') come from the launch's parameters, or from device memory
// (DEVC, sb_fused_substep2_dev: a captured frame's constants and user
// input are device buffers, so a mouse drag replays one graph): the
// entry copies them device to device into the kernel's __constant__
// bank on the launch's stream just before the launch (a copy node in a
// captured graph), and the kernel reads them there as it reads its
// parameters, from the constant cache with no register held for them
// (staged in shared memory instead, they were loaded into registers
// early and raised the spills at K1's 48-register cap).  Launches with
// device constants are therefore ordered on one stream at a time, as
// the frames run them.  The pair skip is the host's decision, passed
// with them.
//
// The far-field scalars consts[40 .. 47] (X_*) come from the launch's
// constants, or from device memory where the launch passes `xdev`
// (sb_fused_substep2_modex): a captured frame computes them on the
// device (the far list's age, the trigger's band velocity), so no value
// of the state is baked into a graph's launch.
//
// The detect pass (K2's design, band_detect.cu, inside K1's block).  Only
// the group flag is stored (the OR over a group's 4 rows), so four
// threads share each of the tile's 64 group-columns, splitting the 15 dy
// of the band between them (DET_SPLIT; thread q takes dy + 7 = q, q + 4,
// ...), all four in one warp, where a ballot after each dy stops the
// group at its first hit and a vote stops the warp when every group is
// done.  Per dy a thread loads its group's 11 partner rows once and
// tests them against its 4 cells:
// - an exact one-axis pre-test first: a pair can hit only if |ddx| (or
//   |ddy|) < rb, rb bounding |reach| over the partner rows' deviations.
//   Each staged row's range of |v - vbar|^2 over alive cells (NaN left
//   out) is reduced once while staging; sqrt and * T_band are monotone,
//   so the range's ends bound every deviation of the rows, and no square
//   root is taken per cell;
// - the exact compare (band_pair_hit, the plain association (base +
//   dev_i) + dev_j bit for bit) only for a dy whose pre-test passes,
//   with each deviation computed there;
// - dead and out-of-grid cells are copied at +inf into two band planes
//   beside the staged tile (the springs and collisions read the tile
//   unchanged): both tests fail for them without an alive load.  The
//   band planes and row ranges cover the staged rows from the tile's
//   first on: the band reaches rows after a cell only.
// Splitting a group's dy 2 ways or not at all, the exact compares without
// the pre-test, and band planes for every staged row measured slower
// (kernel_variants.py, PERF.md §6).
// The trig pass: each cell's four partials reduced over its warp by
// __shfl_xor_sync butterflies (a fixed order; the maxima NaN-keeping),
// then the 8 warps' partials by one thread each; no float atomics.  The
// refs planes are copied with cp.async beside the staged tile, so their
// latency hides behind the staging and no register holds them.
//
// What bounds it on the card: device-memory bytes, once the arithmetic
// is cut to what the inputs need.  At 1M particles a substep reads 18
// hot + 2 immutable + 5 far planes (+8 obs when observing) and writes 18
// (+8): 172 MB, 51 us at 3.35 TB/s.  Each spring and each collision pair
// that can touch costs an IEEE square root and divide (multi-instruction
// sequences under strict physics); taken at both ends of every spring
// and every pair, they take longer to issue than the bytes take to move.
//
// What the design does about it (the block substep, lattice_device.cuh):
// - an 8 (W) x 32 (H) tile per block of 256 threads, one cell each,
//   every plane load and store a coalesced 128-byte row;
//   __launch_bounds__(256, 5) keeps 40 warps resident per SM;
// - the tile plus a halo of max(s, 1) (detect: max(s, 7)) of px py vx vy
//   alive is staged
//   with cp.async (no index division, zero fill outside the grid) while
//   each thread loads its own 12 edge planes;
// - springs, evaluated once: each cell's own spring and those of the
//   tile's halo owners (one row above, one column each side) go into
//   force planes in shared memory, where each cell reads its reaction;
//   the owners' edge planes are no longer read again at shifted
//   addresses;
// - collisions: each thread evaluates its cell's terms of each half
//   offset at both ends from the staged tile, but the square root and
//   divide only for pairs that can touch (pair_terms; the entry checks
//   once per launch that the constants allow the skip, pair_skip_allowed):
//   a pair well apart costs a few products, less than passing it through
//   shared memory:
//   sharing the pairs too (per offset, into shared pair slots behind a
//   barrier) measured slower on the card (PERF.md, Findings).
// The kernel reads `hot` and writes a separate `hot_out` (neighbours
// must see the previous substep).
//
// Penetration clip: (2r - dist) * 0.5 * inv_dt2 with inv_dt2 = 1/(dt*dt)
// in float32, as JAX's kernel (fused_substep2.py:394, :757); K4 and the
// stencil path divide by dt^2, as theirs do.
//
// Exactness: each cell sums per class -own + reaction and per half
// offset (acc + t(i, i+o)) - t(i-o, i), the order of the plain version
// (under ROLLGROUP its grouped order: lattice_device.cuh, collide_half
// and spring_sums).
// A reaction read from the force planes is the value the owner computed
// for its own spring, the same function of the same operands, so sharing
// it is bit-identical; outside the grid it is +0, the plain version's
// back() fill.  Built with -fmad=false and without fast math, every
// float op rounds as in torch, so the int32 spring sums and the edge
// planes equal the plain version's bit for bit.

#include <math.h>
#include <string.h>

#include "band_device.cuh"
#include "lattice_device.cuh"

namespace {

constexpr int PX = 0, PY = 1, VX = 2, VY = 3, AX = 4, AY = 5;
constexpr int EDGE0 = 6;                 // class c: tgt, lst, eal at 6 + 3c
constexpr int N_CONSTS = 20;
constexpr int N_EDGEC = 20;              // class c: spr dmp yld lim len at 20 + 5c
// the far-field frames' scalars after the edge constants
// (fused_substep2.py:96-98)
constexpr int N_EXTRA = 8;
constexpr int XB = N_CONSTS + N_EDGEC;
constexpr int X_TAU = 0, X_DET = 1, X_VBX = 2, X_VBY = 3, X_TBAND = 4,
              X_REACH = 5;
constexpr int N_STATS = 4;               // max dd2, max dv2, sum vx, sum vy
constexpr int N_SIDE = 9;
constexpr float SIDE_BIG = 3.0e38f;
constexpr int BAND_R = 7;                // band reach: 2 * chunk - 1
// the detect pass: groups of DET_CX rows along W (the side planes'
// chunk), DET_SPLIT threads per group-column, each taking every
// DET_SPLIT-th dy of the band
constexpr int DET_CX = 4;
constexpr int DET_SPLIT = 4;
constexpr int DET_GPW = 32 / DET_SPLIT;           // group-columns per warp
constexpr int DET_GC = SUB_TX / DET_CX * SUB_TY;  // group-columns per tile
constexpr int DET_PR = DET_CX + BAND_R;           // partner rows per dy
constexpr int DET_NDY = 2 * BAND_R + 1;

// MODE bits
constexpr int M_TRIG = 1, M_DETECT = 2, M_KNOBS = 4;

struct Consts {
  float v[N_CONSTS + N_EDGEC + N_EXTRA];
};

__host__ __device__ __forceinline__ int k1_halo(int s, int mode) {
  const int R = s > 1 ? s : 1;
  return (mode & M_DETECT) && R < BAND_R ? BAND_R : R;
}

// DEVC's constants, copied in from device memory before each launch
__constant__ float k1_consts_dev[N_CONSTS + N_EDGEC];

// Dynamic shared memory of K1: the staged tile and the force planes;
// under M_DETECT the band planes (px, py; +inf where dead) of the staged
// tile and each staged row's (max, min) of |v - vbar|^2; under M_TRIG
// the refs of the tile's cells and the warps' partials.
__host__ __device__ __forceinline__ size_t k1_smem_bytes(int s, int mode) {
  const int R = k1_halo(s, mode);
  const size_t sx = SUB_TX + 2 * R;
  size_t n = sub_stage_floats(R) + 8 * SUB_FN;
  if (mode & M_DETECT) n += 2 * sx * (SUB_TY + 2 * R) + 2 * sx;
  if (mode & M_TRIG) n += 4 * SUB_THREADS + N_STATS * (SUB_THREADS / 32);
  return n * sizeof(float);
}

// Blocks per SM each instance is built for (__launch_bounds__): 5 (48
// registers); the trig instances 4 (64 registers): at 48 they spill, and
// at 4 blocks they measured faster (kernel_variants.py, PERF.md §6).
__host__ __device__ constexpr int k1_min_blocks(int mode) {
  return (mode & M_TRIG) ? 4 : 5;
}

// the lanes of one group-column in a warp: lane = q * DET_GPW + column
__host__ __device__ constexpr uint32_t det_group_lanes() {
  uint32_t m = 0u;
  for (int q = 0; q < DET_SPLIT; ++q) m |= 1u << (q * DET_GPW);
  return m;
}

// The detect pass's search and side planes (every thread of the block
// calls it, after the band planes bpx/bpy and the row keys rkey are
// published).  Thread (warp, lane) takes group-column gc = warp * DET_GPW
// + lane % DET_GPW and the dy slot q = lane / DET_GPW.
__device__ __forceinline__ void detect_groups(const SmemTile& t,
                                              const float* bpx,
                                              const float* bpy,
                                              const uint32_t* rkey,
                                              const float* xv, int s, int R,
                                              int x0, int y0, int w, int h,
                                              float* __restrict__ side) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int q = lane / DET_GPW;
  const int gc = warp * DET_GPW + lane % DET_GPW;
  const bool gc_in = gc < DET_GC;
  const int r0 = gc_in ? gc / SUB_TY * DET_CX : 0;  // the group's tile row
  const int col = gc % SUB_TY;                      // its tile column
  const int sy = t.sy;
  const int s0 = (r0 + R) * sy + col + R;  // staged index of its first cell
  const float base = xv[X_REACH], tband = xv[X_TBAND];
  const float vbx = xv[X_VBX], vby = xv[X_VBY];

  bool any_alive = false;
#pragma unroll
  for (int j = 0; j < DET_CX; ++j)
    any_alive = any_alive || t.al[s0 + j * sy] > 0.0f;
  // rb bounds |reach| = |(base + dev_i) + dev_j| over the partner rows
  // r0 .. r0 + DET_PR - 1 (the group's own rows among them): each row's
  // alive |v - vbar|^2 lie in [kmin, kmax] (bits of floats >= +0, NaN
  // left out), and sqrt, * T_band and + are monotone, so every deviation
  // that is not NaN lies in [dlo, dhi] (fminf / fmaxf drop an end that is
  // NaN: inf * 0 or 0 * inf, where only the other end's values are not
  // NaN).  Where one end of reach is NaN (inf - inf) rb is +inf; where
  // both are, no reach is a number.  No row key: no alive partner.
  float rb = 0.0f;
  {
    uint32_t kmax = 0u, kmin = 0xffffffffu;
#pragma unroll
    for (int p = 0; p < DET_PR; ++p) {
      kmax = max(kmax, rkey[2 * (r0 + R + p)]);
      kmin = min(kmin, rkey[2 * (r0 + R + p) + 1]);
    }
    if (kmin <= kmax) {
      const float da = sqrtf(__uint_as_float(kmin)) * tband;
      const float db = sqrtf(__uint_as_float(kmax)) * tband;
      const float dlo = fminf(da, db), dhi = fmaxf(da, db);
      const float lo = (base + dlo) + dlo, hi = (base + dhi) + dhi;
      rb = lo == lo && hi == hi ? fmaxf(fabsf(lo), fabsf(hi))
           : lo == lo || hi == hi ? INFINITY
                                  : 0.0f;
    }
  }

  bool hit = false;
  bool done = !(gc_in && any_alive) || s >= BAND_R;
#pragma unroll 1
  for (int i = 0; i < (DET_NDY + DET_SPLIT - 1) / DET_SPLIT; ++i) {
    if (__all_sync(0xffffffffu, done)) break;
    const int k = q + DET_SPLIT * i;  // dy + BAND_R
    const uint32_t m = k < DET_NDY ? band_dx_mask(k - BAND_R, s) : 0u;
    if (!done && m != 0u) {
      const int dy = k - BAND_R;
      const int pb = s0 + dy;  // partner row p of cell j at dx = p - j
      // the one-axis test: x where every dx of the dy is at least |dy|
      // (the partners lie apart along W), else y; |partner - cell| >= rb
      // proves no hit, and NaN or an infinite operand fails (fminf drops
      // NaN); the cells' values are read here, not held in registers
      const bool by_x = __ffs((int)m) - 1 >= abs(dy);
      const float* ax = by_x ? bpx : bpy;
      float ca[DET_CX], box[DET_CX];
#pragma unroll
      for (int j = 0; j < DET_CX; ++j) {
        ca[j] = ax[s0 + j * sy];
        box[j] = INFINITY;
      }
#pragma unroll
      for (int p = 0; p < DET_PR; ++p) {
        const float a = ax[pb + p * sy];
#pragma unroll
        for (int j = 0; j < DET_CX; ++j) {
          const int dx = p - j;
          if (dx >= 0 && dx <= BAND_R && ((m >> dx) & 1u))
            box[j] = fminf(box[j], fabsf(a - ca[j]));
        }
      }
      float nearest = box[0];
#pragma unroll
      for (int j = 1; j < DET_CX; ++j) nearest = fminf(nearest, box[j]);
      if (nearest < rb) {
        // the exact compares of this dy, each deviation computed here
        // (a dead cell or partner at +inf fails whatever its deviation)
        float cpx[DET_CX], cpy[DET_CX], cb[DET_CX];
#pragma unroll
        for (int j = 0; j < DET_CX; ++j) {
          const int c = s0 + j * sy;
          const float ddx = t.vx[c] - vbx;
          const float ddy = t.vy[c] - vby;
          cpx[j] = bpx[c];
          cpy[j] = bpy[c];
          cb[j] = base + sqrtf(ddx * ddx + ddy * ddy) * tband;
        }
        for (int p = 0; p < DET_PR && !hit; ++p) {
          const int c = pb + p * sy;
          const float ddx = t.vx[c] - vbx;
          const float ddy = t.vy[c] - vby;
          const float qdev = sqrtf(ddx * ddx + ddy * ddy) * tband;
#pragma unroll
          for (int j = 0; j < DET_CX; ++j) {
            const int dx = p - j;
            if (dx >= 0 && dx <= BAND_R && ((m >> dx) & 1u))
              hit = hit || band_pair_hit(cpx[j], cpy[j], cb[j], bpx[c],
                                         bpy[c], qdev);
          }
        }
      }
    }
    // the group's threads learn of a hit: it stops there
    const uint32_t votes = __ballot_sync(0xffffffffu, hit);
    if ((votes >> (lane % DET_GPW)) & det_group_lanes()) {
      hit = true;
      done = true;
    }
  }

  // the side planes: thread q the min and max of plane q (px py vx vy,
  // alive-masked, the group's first row giving the start), q = 0 the flag
  const int gx = x0 + r0, gy = y0 + col;
  if (gc_in && gx < w && gy < h) {
    const size_t sw = (size_t)((w + 3) / 4) * h;
    const size_t gi = (size_t)(gx / 4) * h + gy;
    const int plane_stride = (int)(t.py - t.px);
    for (int p = q; p < 4; p += DET_SPLIT) {
      const float* pl = t.px + p * plane_stride;
      float mn = 0.0f, mx = 0.0f;
#pragma unroll
      for (int j = 0; j < DET_CX; ++j) {
        const int c = s0 + j * sy;
        const bool a = t.al[c] > 0.0f;
        const float val = pl[c];
        mn = j == 0 ? (a ? val : SIDE_BIG) : tmin(mn, a ? val : SIDE_BIG);
        mx = j == 0 ? (a ? val : -SIDE_BIG) : tmax(mx, a ? val : -SIDE_BIG);
      }
      side[(2 * p) * sw + gi] = mn;
      side[(2 * p + 1) * sw + gi] = mx;
    }
    if (q == 0) side[8 * sw + gi] = hit ? 1.0f : 0.0f;
  }
}

// SKIP: pair_skip_allowed for the launch's constants (a template
// parameter, so the usual instance compiles as if the skip were
// unconditional; under RSQRT always true).  RSQRT, ROLLGROUP: the
// arithmetic variants (lattice_device.cuh).  MODE: the M_* bits above.
// DEVC: the constants from k1_consts_dev (copied from device memory),
// else from `cs`.
template <bool SKIP, bool RSQRT, bool ROLLGROUP, int MODE, bool DEVC>
__global__ void __launch_bounds__(SUB_THREADS, k1_min_blocks(MODE))
fused_substep2_kernel(const float* __restrict__ hot,
                      const float* __restrict__ immut,
                      const float* __restrict__ far,
                      const float* __restrict__ obs_in,
                      float* __restrict__ hot_out,
                      float* __restrict__ obs_out, const Consts cs, int w,
                      int h, int s, int quantized,
                      const float* __restrict__ refs,
                      float* __restrict__ stats, float* __restrict__ side,
                      int nospring, int noint,
                      const float* __restrict__ xdev) {
  constexpr bool TRIG = (MODE & M_TRIG) != 0;
  constexpr bool DETECT = (MODE & M_DETECT) != 0;
  constexpr bool KNOBS = (MODE & M_KNOBS) != 0;
  extern __shared__ float smem[];
  const int R = k1_halo(s, MODE);
  const size_t WH = (size_t)w * h;
  const int x0 = blockIdx.y * SUB_TX;
  const int y0 = blockIdx.x * SUB_TY;
  const SmemTile t = stage_tile_async(smem, hot + PX * WH, hot + PY * WH,
                                      hot + VX * WH, hot + VY * WH, immut,
                                      x0, y0, R, w, h);
  uint32_t* fp = (uint32_t*)(smem + sub_stage_floats(R));
  float* extra = smem + sub_stage_floats(R) + 8 * SUB_FN;
  const int sx = SUB_TX + 2 * R;
  const int sn = sx * t.sy;
  // detect: the band planes, then each staged row's (max, min) key
  float* bpx = extra;
  float* bpy = extra + sn;
  uint32_t* rkey = (uint32_t*)(extra + 2 * sn);
  // trig: the refs of the tile's cells, then the warps' partials
  float* rf = extra + (DETECT ? 2 * sn + 2 * sx : 0);
  float* wpart = rf + 4 * SUB_THREADS;
  const float* v = DEVC ? k1_consts_dev : cs.v;
  // the far-field scalars (X_*), from device memory or the constants
  const float* xv = xdev != nullptr ? xdev : v + XB;
  const bool skip_springs = KNOBS && nospring;

  const int r = threadIdx.y, l = threadIdx.x;
  const int tid = r * SUB_TY + l;
  const int x = x0 + r, y = y0 + l;
  const bool live = x < w && y < h;
  const size_t g = live ? (size_t)x * h + y : 0;

  if constexpr (TRIG) {
    // this cell's refs, copied beside the staged tile (zero outside the
    // grid); they land at stage_wait()
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cp_async_f32(rf + k * SUB_THREADS + tid, refs + k * WH + g, live);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // own edge planes, loaded while the tile is in flight
  float tgt[4], lst[4];
  bool eal[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const size_t pt = (size_t)(EDGE0 + 3 * c) * WH;
    tgt[c] = live ? hot[pt + g] : 0.0f;
    lst[c] = live ? hot[pt + WH + g] : 0.0f;
    eal[c] = live && hot[pt + 2 * WH + g] > 0.0f;
  }
  // this thread's halo owner (the last warps take them) and its planes
  int hc = 0, hr = 0, hl = 0;
  const bool halo = halo_owner(SUB_THREADS - 1 - tid, hc, hr, hl);
  const bool halo_in = halo && x0 + hr >= 0 && x0 + hr < w &&
                       y0 + hl >= 0 && y0 + hl < h;
  float htgt = 0.0f, hlst = 0.0f;
  bool heal = false;
  if (halo_in) {
    const size_t go = (size_t)(x0 + hr) * h + y0 + hl;
    const size_t pt = (size_t)(EDGE0 + 3 * hc) * WH;
    htgt = hot[pt + go];
    hlst = hot[pt + WH + go];
    heal = hot[pt + 2 * WH + go] > 0.0f;
  }
  stage_wait();

  const int lc = (r + R) * t.sy + l + R;
  const bool al_c = t.al[lc] > 0.0f;
  const float px = t.px[lc], py = t.py[lc];

  // ---- detect, staging: the band planes and each row's range ----------
  // (a warp per staged row from the tile's first on: the band reaches
  // rows after a cell only; published by the springs' barrier)
  bool det_on = false;
  if constexpr (DETECT) {
    det_on = xv[X_DET] > 0.0f;
    if (det_on) {
      const float vbx = xv[X_VBX], vby = xv[X_VBY];
      for (int row = R + r; row < sx; row += SUB_TX) {
        uint32_t kmax = 0u, kmin = 0xffffffffu;
        for (int col = l; col < t.sy; col += SUB_TY) {
          const int i = row * t.sy + col;
          const bool a = t.al[i] > 0.0f;
          bpx[i] = a ? t.px[i] : INFINITY;
          bpy[i] = a ? t.py[i] : INFINITY;
          const float ddx = t.vx[i] - vbx;
          const float ddy = t.vy[i] - vby;
          const float s2 = ddx * ddx + ddy * ddy;  // +0 and up, or NaN
          if (a && s2 == s2) {
            kmax = max(kmax, __float_as_uint(s2));
            kmin = min(kmin, __float_as_uint(s2));
          }
        }
        kmax = __reduce_max_sync(0xffffffffu, kmax);
        kmin = __reduce_min_sync(0xffffffffu, kmin);
        if (l == 0) {
          rkey[2 * row] = kmax;
          rkey[2 * row + 1] = kmin;
        }
      }
    }
  }

  // ---- springs: own edges into the force planes, edge-state update ----
  if (skip_springs) {
    // nospring: the edge and obs planes pass through
    if (live) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const size_t pt = (size_t)(EDGE0 + 3 * c) * WH;
        hot_out[pt + g] = tgt[c];
        hot_out[pt + WH + g] = lst[c];
        hot_out[pt + 2 * WH + g] = eal[c] ? 1.0f : 0.0f;
        if (obs_in != nullptr) {
          const size_t po = (size_t)(2 * c) * WH;
          obs_out[po + g] = obs_in[po + g];
          obs_out[po + WH + g] = obs_in[po + WH + g];
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dx = EDX[c], dy = EDY[c];
      const float k = v[N_CONSTS + 5 * c + 0];
      const float damp = v[N_CONSTS + 5 * c + 1];
      const int lp = lc + dx * t.sy + dy;
      const Spring own =
          spring_eval<RSQRT>(px, py, t.px[lp], t.py[lp],
                      eal[c] && al_c && t.al[lp] > 0.0f, tgt[c], lst[c], k,
                      damp);
      fp[2 * c * SUB_FN + force_index(r, l)] = force_bits(own.fvx, quantized);
      fp[(2 * c + 1) * SUB_FN + force_index(r, l)] =
          force_bits(own.fvy, quantized);
      if (live) {
        const float yld = v[N_CONSTS + 5 * c + 2];
        const float lim = v[N_CONSTS + 5 * c + 3];
        const float len = v[N_CONSTS + 5 * c + 4];
        const size_t pt = (size_t)(EDGE0 + 3 * c) * WH;
        const float strain = (own.ln - tgt[c]) / len;
        const bool yielded = fabsf(strain) > yld;
        const float new_tgt =
            yielded ? own.ln - yld * len * tsign(strain) : tgt[c];
        const bool breaks = fabsf(own.ln - len) > len * lim;
        hot_out[pt + g] = own.active ? new_tgt : tgt[c];
        hot_out[pt + WH + g] = own.active ? own.ln : lst[c];
        hot_out[pt + 2 * WH + g] =
            (eal[c] && !(own.active && breaks)) ? 1.0f : 0.0f;
        if (obs_in != nullptr) {
          const size_t po = (size_t)(2 * c) * WH;
          obs_out[po + g] = own.active ? fabsf(strain) / yld : obs_in[po + g];
          obs_out[po + WH + g] =
              own.active ? own.fmag * STRESS_SCALE : obs_in[po + WH + g];
        }
      }
    }
    if (halo) {
      float fvx = 0.0f, fvy = 0.0f;  // +0 outside the grid: back()'s fill
      if (halo_in) {
        float k = 0.0f, damp = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c == hc) {
            k = v[N_CONSTS + 5 * c + 0];
            damp = v[N_CONSTS + 5 * c + 1];
          }
        }
        const int lo = (hr + R) * t.sy + hl + R;
        const int lp = lo + EDX[hc] * t.sy + EDY[hc];
        const Spring sp = spring_eval<RSQRT>(
            t.px[lo], t.py[lo], t.px[lp], t.py[lp],
            heal && t.al[lo] > 0.0f && t.al[lp] > 0.0f, htgt, hlst, k, damp);
        fvx = sp.fvx;
        fvy = sp.fvy;
      }
      fp[2 * hc * SUB_FN + force_index(hr, hl)] = force_bits(fvx, quantized);
      fp[(2 * hc + 1) * SUB_FN + force_index(hr, hl)] =
          force_bits(fvy, quantized);
    }
  }
  __syncthreads();
  float bfx = 0.0f, bfy = 0.0f;
  if (!skip_springs) spring_sums<ROLLGROUP>(fp, r, l, quantized, bfx, bfy);

  // ---- detect: the band search and the side planes -------------------
  if constexpr (DETECT) {
    if (det_on)
      detect_groups(t, bpx, bpy, rkey, xv, s, R, x0, y0, w, h, side);
  }
  if constexpr (!TRIG) {
    if (!live) return;
  }

  float part[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    // ---- collisions: half offsets, (acc + t(i, i+o)) - t(i-o, i) ------
    Terms d = collide_half<RSQRT, ROLLGROUP, true>(
        t, lc, x, y, w, h, s, v[0], v[1], v[7], v[8], SKIP);
    if (far != nullptr) {
      d.dvx = d.dvx + far[g];
      d.dvy = d.dvy + far[WH + g];
      d.dax = d.dax + far[2 * WH + g];
      d.day = d.day + far[3 * WH + g];
      d.dyn = d.dyn + far[4 * WH + g];
    }

    // ---- integration (compute.wgsl:171-199) ---------------------------
    const Particle in = {px, py, t.vx[lc], t.vy[lc], hot[AX * WH + g],
                         hot[AY * WH + g]};
    const Particle o =
        KNOBS && noint
            ? in
            : integrate<RSQRT>(in, al_c, immut[WH + g] > 0.0f, d, bfx, bfy,
                               v);
    hot_out[PX * WH + g] = o.px;
    hot_out[PY * WH + g] = o.py;
    hot_out[VX * WH + g] = o.vx;
    hot_out[VY * WH + g] = o.vy;
    hot_out[AX * WH + g] = o.ax;
    hot_out[AY * WH + g] = o.ay;

    // ---- trig: this cell's deviation from the linear reference --------
    if constexpr (TRIG) {
      if (al_c) {
        const float tau = xv[X_TAU];
        const float rvx = rf[2 * SUB_THREADS + tid];
        const float rvy = rf[3 * SUB_THREADS + tid];
        const float ddx = o.px - (rf[tid] + rvx * tau);
        const float ddy = o.py - (rf[SUB_THREADS + tid] + rvy * tau);
        const float dvx = o.vx - rvx;
        const float dvy = o.vy - rvy;
        part[0] = ddx * ddx + ddy * ddy;
        part[1] = dvx * dvx + dvy * dvy;
        part[2] = o.vx;
        part[3] = o.vy;
      }
    }
  }
  if constexpr (TRIG) {
    // the block's partials: xor butterflies over each warp (every lane
    // ends with the same values: a + b rounds as b + a), then the warps
    // in order; max with NaN kept, no atomics
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < N_STATS; ++k) {
        const float o = __shfl_xor_sync(0xffffffffu, part[k], off);
        part[k] = k < 2 ? tmax(part[k], o) : part[k] + o;
      }
    }
    if (l == 0) {
#pragma unroll
      for (int k = 0; k < N_STATS; ++k) wpart[r * N_STATS + k] = part[k];
    }
    __syncthreads();
    if (tid < N_STATS) {
      float acc = wpart[tid];
      for (int wi = 1; wi < SUB_TX; ++wi) {
        const float b = wpart[wi * N_STATS + tid];
        acc = tid < 2 ? tmax(acc, b) : acc + b;
      }
      const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      stats[blk * N_STATS + tid] = acc;
    }
  }
}

using K1Kernel = void (*)(const float*, const float*, const float*,
                          const float*, float*, float*, const Consts, int,
                          int, int, int, const float*, float*, float*, int,
                          int, const float*);

template <int MODE, bool DEVC>
K1Kernel k1_arith(bool skip, bool rsqrt, bool rollgroup) {
  return rsqrt
             ? (rollgroup
                    ? fused_substep2_kernel<true, true, true, MODE, DEVC>
                    : fused_substep2_kernel<true, true, false, MODE, DEVC>)
         : rollgroup
             ? (skip ? fused_substep2_kernel<true, false, true, MODE, DEVC>
                     : fused_substep2_kernel<false, false, true, MODE, DEVC>)
             : (skip
                    ? fused_substep2_kernel<true, false, false, MODE, DEVC>
                    : fused_substep2_kernel<false, false, false, MODE,
                                            DEVC>);
}

// K1's instances: the arithmetic variants in modes 0 (every fused path),
// M_DETECT (the fixed-cadence frame's kernel detection) and M_KNOBS (the
// attribution knobs); M_TRIG and M_TRIG | M_DETECT (the triggered frame,
// which JAX runs strict) strict only; each with the constants by value or
// from device memory (DEVC).  nullptr for any other.
template <bool DEVC>
K1Kernel k1_pick_c(int mode, bool skip, bool rsqrt, bool rollgroup) {
  const bool strict = !rsqrt && !rollgroup;
  switch (mode) {
    case 0:
      return k1_arith<0, DEVC>(skip, rsqrt, rollgroup);
    case M_DETECT:
      return k1_arith<M_DETECT, DEVC>(skip, rsqrt, rollgroup);
    case M_KNOBS:
      return k1_arith<M_KNOBS, DEVC>(skip, rsqrt, rollgroup);
    case M_TRIG:
      if (!strict) return nullptr;
      return skip ? fused_substep2_kernel<true, false, false, M_TRIG, DEVC>
                  : fused_substep2_kernel<false, false, false, M_TRIG,
                                          DEVC>;
    case M_TRIG | M_DETECT:
      if (!strict) return nullptr;
      return skip ? fused_substep2_kernel<true, false, false,
                                          M_TRIG | M_DETECT, DEVC>
                  : fused_substep2_kernel<false, false, false,
                                          M_TRIG | M_DETECT, DEVC>;
  }
  return nullptr;
}

K1Kernel k1_pick(int mode, bool skip, bool rsqrt, bool rollgroup,
                 bool devc = false) {
  return devc ? k1_pick_c<true>(mode, skip, rsqrt, rollgroup)
              : k1_pick_c<false>(mode, skip, rsqrt, rollgroup);
}

// `cdev`: the constants in device memory (40 floats; the far-field
// scalars then from `xdev` under trig or detect), with `skip_dev` the
// host's pair-skip decision; null: from `consts_host`, skip decided here.
int k1_launch(const float* hot, const float* immut, const float* far,
              const float* obs_in, const float* refs, float* hot_out,
              float* obs_out, float* stats, float* side,
              const float* consts_host, int w, int h, int stencil,
              int quantized, int rsqrt, int rollgroup, int mode,
              int nospring, int noint, void* stream,
              const float* xdev = nullptr, const float* cdev = nullptr,
              int skip_dev = 0) {
  Consts cs;
  memset(cs.v, 0, sizeof(cs.v));
  const bool devc = cdev != nullptr;
  bool skip = skip_dev != 0;
  if (devc) {
    if ((mode & (M_TRIG | M_DETECT)) && xdev == nullptr)
      return (int)cudaErrorInvalidValue;
  } else {
    const int n = (mode & (M_TRIG | M_DETECT)) && xdev == nullptr
                      ? N_CONSTS + N_EDGEC + N_EXTRA
                      : N_CONSTS + N_EDGEC;
    memcpy(cs.v, consts_host, n * sizeof(float));
    skip = pair_skip_allowed(cs.v, true);
  }
  const K1Kernel kernel = k1_pick(mode, skip, rsqrt, rollgroup, devc);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (devc) {
    void* bank = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&bank, k1_consts_dev);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(bank, cdev, sizeof(k1_consts_dev),
                            cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = k1_smem_bytes(stencil, mode);
  dim3 block(SUB_TY, SUB_TX);
  dim3 grid((h + SUB_TY - 1) / SUB_TY, (w + SUB_TX - 1) / SUB_TX);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      hot, immut, far, obs_in, hot_out, obs_out, cs, w, h, stencil,
      quantized, refs, stats, side, nospring, noint, xdev);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* sb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers except `consts_host` (40 floats, copied
// into the launch by value).  `far` and `obs_in`/`obs_out` may be null.
// `rsqrt`, `rollgroup` pick the instance.
extern "C" int sb_fused_substep2_variant(const float* hot, const float* immut,
                                         const float* far,
                                         const float* obs_in, float* hot_out,
                                         float* obs_out,
                                         const float* consts_host, int w,
                                         int h, int stencil, int quantized,
                                         int rsqrt, int rollgroup,
                                         void* stream) {
  return k1_launch(hot, immut, far, obs_in, nullptr, hot_out, obs_out,
                   nullptr, nullptr, consts_host, w, h, stencil, quantized,
                   rsqrt, rollgroup, 0, 0, 0, stream);
}

// Every mode: `trig` (refs [4,W,H] in, stats [blocks, 4] out: blocks =
// ceil(H/32) * ceil(W/8)), `detect` (side [9, ceil(W/4), H] out), and
// the knobs `nospring`, `noint` (M_KNOBS; not with trig or detect).
// `consts_host` holds 48 floats under trig or detect, else 40.  Returns
// cudaErrorInvalidValue for a combination without an instance.
extern "C" int sb_fused_substep2_mode(
    const float* hot, const float* immut, const float* far,
    const float* obs_in, const float* refs, float* hot_out, float* obs_out,
    float* stats, float* side, const float* consts_host, int w, int h,
    int stencil, int quantized, int rsqrt, int rollgroup, int trig,
    int detect, int nospring, int noint, void* stream) {
  const bool knobs = nospring || noint;
  if (knobs && (trig || detect)) return (int)cudaErrorInvalidValue;
  const int mode = (trig ? M_TRIG : 0) | (detect ? M_DETECT : 0) |
                   (knobs ? M_KNOBS : 0);
  return k1_launch(hot, immut, far, obs_in, refs, hot_out, obs_out, stats,
                   side, consts_host, w, h, stencil, quantized, rsqrt,
                   rollgroup, mode, nospring, noint, stream);
}

// The mode entry with the N_EXTRA far-field scalars read by the kernel
// from `xdev` (device memory, 8 floats; null: from `consts_host`, which
// then holds 48 floats under trig or detect, as above).  With `xdev`,
// `consts_host` holds 40 floats: a captured frame computes the scalars
// on the device.
extern "C" int sb_fused_substep2_modex(
    const float* hot, const float* immut, const float* far,
    const float* obs_in, const float* refs, float* hot_out, float* obs_out,
    float* stats, float* side, const float* consts_host, int w, int h,
    int stencil, int quantized, int rsqrt, int rollgroup, int trig,
    int detect, int nospring, int noint, void* stream, const float* xdev) {
  const bool knobs = nospring || noint;
  if (knobs && (trig || detect)) return (int)cudaErrorInvalidValue;
  const int mode = (trig ? M_TRIG : 0) | (detect ? M_DETECT : 0) |
                   (knobs ? M_KNOBS : 0);
  return k1_launch(hot, immut, far, obs_in, refs, hot_out, obs_out, stats,
                   side, consts_host, w, h, stencil, quantized, rsqrt,
                   rollgroup, mode, nospring, noint, stream, xdev);
}

// The mode entry with every constant in device memory: `consts_dev` (40
// floats, config.consts_vector then the edge classes'; copied into the
// kernel's constant bank on `stream` before the launch), `extras_dev`
// (the N_EXTRA far-field scalars; needed under trig or detect) and
// `skip`, whether the constants allow the pair skip (pair_skip_allowed
// with inv_dt2, decided on the host from the same values).  Nothing of
// the constants is in the launch: a captured graph replays with whatever
// the buffers hold.
extern "C" int sb_fused_substep2_dev(
    const float* hot, const float* immut, const float* far,
    const float* obs_in, const float* refs, float* hot_out, float* obs_out,
    float* stats, float* side, const float* consts_dev, int w, int h,
    int stencil, int quantized, int rsqrt, int rollgroup, int trig,
    int detect, int nospring, int noint, int skip, void* stream,
    const float* extras_dev) {
  const bool knobs = nospring || noint;
  if (knobs && (trig || detect)) return (int)cudaErrorInvalidValue;
  if (consts_dev == nullptr) return (int)cudaErrorInvalidValue;
  const int mode = (trig ? M_TRIG : 0) | (detect ? M_DETECT : 0) |
                   (knobs ? M_KNOBS : 0);
  return k1_launch(hot, immut, far, obs_in, refs, hot_out, obs_out, stats,
                   side, nullptr, w, h, stencil, quantized, rsqrt,
                   rollgroup, mode, nospring, noint, stream, extras_dev,
                   consts_dev, skip);
}

// The strict instance (the entry of earlier builds, kept for comparing
// checkouts).
extern "C" int sb_fused_substep2(const float* hot, const float* immut,
                                 const float* far, const float* obs_in,
                                 float* hot_out, float* obs_out,
                                 const float* consts_host, int w, int h,
                                 int stencil, int quantized, void* stream) {
  return sb_fused_substep2_variant(hot, immut, far, obs_in, hot_out, obs_out,
                                   consts_host, w, h, stencil, quantized, 0,
                                   0, stream);
}

// The residency of K1's strict instance in mode `(stencil >> 8) & 255`
// (0: the plain substep; M_* bits) at stencil radius `stencil & 255`,
// with the constants from device memory where bit 16 is set: out[0]
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1]
// registers per thread, out[2] local (spill) bytes per thread, out[3]
// dynamic shared bytes per block, out[4] threads per block.
extern "C" int sb_fused_substep2_occupancy(int stencil, int* out) {
  const int mode = (stencil >> 8) & 255;
  const bool devc = (stencil >> 16) & 1;
  stencil &= 255;
  const size_t smem = k1_smem_bytes(stencil, mode);
  const K1Kernel kernel = k1_pick(mode, true, false, false, devc);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, kernel);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, SUB_THREADS, smem);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  out[4] = SUB_THREADS;
  return err;
}
