// K1: one whole lattice substep, hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/fused_substep2.py:_kernel2 (the
// Pallas TPU kernel launched by fused_substep2_call), in four instances:
// strict, and the JAX kernel's arithmetic variants rsqrt, rollgroup and
// both (its default, rollgroup + rsqrt + dexp2 + layout flags; dexp2 is
// the strict drag's |v|^2 = |v|*|v| already, the layout flags are
// Mosaic's).  Plain version: softbody_tpu_torch/ops/stencil.py
// (substep_planes, with the same flags), reached through
// softbody_tpu_torch/ops/cuda/fused_substep2.py:fused_substep2_plain.
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
// - the tile plus a halo of max(s, 1) of px py vx vy alive is staged
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

#include <string.h>

#include "lattice_device.cuh"

namespace {

constexpr int PX = 0, PY = 1, VX = 2, VY = 3, AX = 4, AY = 5;
constexpr int EDGE0 = 6;                 // class c: tgt, lst, eal at 6 + 3c
constexpr int N_CONSTS = 20;
constexpr int N_EDGEC = 20;              // class c: spr dmp yld lim len at 20 + 5c

struct Consts {
  float v[N_CONSTS + N_EDGEC];
};

// SKIP: pair_skip_allowed for the launch's constants (a template
// parameter, so the usual instance compiles as if the skip were
// unconditional; under RSQRT always true).  RSQRT, ROLLGROUP: the
// arithmetic variants (lattice_device.cuh).
template <bool SKIP, bool RSQRT, bool ROLLGROUP>
__global__ void __launch_bounds__(SUB_THREADS, 5)
fused_substep2_kernel(const float* __restrict__ hot,
                      const float* __restrict__ immut,
                      const float* __restrict__ far,
                      const float* __restrict__ obs_in,
                      float* __restrict__ hot_out,
                      float* __restrict__ obs_out, const Consts cs, int w,
                      int h, int s, int quantized) {
  extern __shared__ float smem[];
  const int R = s > 1 ? s : 1;
  const size_t WH = (size_t)w * h;
  const int x0 = blockIdx.y * SUB_TX;
  const int y0 = blockIdx.x * SUB_TY;
  const SmemTile t = stage_tile_async(smem, hot + PX * WH, hot + PY * WH,
                                      hot + VX * WH, hot + VY * WH, immut,
                                      x0, y0, R, w, h);
  uint32_t* fp = (uint32_t*)(smem + sub_stage_floats(R));
  const float* v = cs.v;

  const int r = threadIdx.y, l = threadIdx.x;
  const int x = x0 + r, y = y0 + l;
  const bool live = x < w && y < h;
  const size_t g = live ? (size_t)x * h + y : 0;

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
  const bool halo =
      halo_owner(SUB_THREADS - 1 - (r * SUB_TY + l), hc, hr, hl);
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

  // ---- springs: own edges into the force planes, edge-state update ----
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
  __syncthreads();
  float bfx, bfy;
  spring_sums<ROLLGROUP>(fp, r, l, quantized, bfx, bfy);
  if (!live) return;

  // ---- collisions: half offsets, (acc + t(i, i+o)) - t(i-o, i) --------
  Terms d = collide_half<RSQRT, ROLLGROUP>(t, lc, x, y, w, h, s, v[0], v[1],
                                           v[7], v[8], SKIP);
  if (far != nullptr) {
    d.dvx = d.dvx + far[g];
    d.dvy = d.dvy + far[WH + g];
    d.dax = d.dax + far[2 * WH + g];
    d.day = d.day + far[3 * WH + g];
    d.dyn = d.dyn + far[4 * WH + g];
  }

  // ---- integration (compute.wgsl:171-199) -----------------------------
  const Particle in = {px, py, t.vx[lc], t.vy[lc], hot[AX * WH + g],
                       hot[AY * WH + g]};
  const Particle o =
      integrate<RSQRT>(in, al_c, immut[WH + g] > 0.0f, d, bfx, bfy, v);
  hot_out[PX * WH + g] = o.px;
  hot_out[PY * WH + g] = o.py;
  hot_out[VX * WH + g] = o.vx;
  hot_out[VY * WH + g] = o.vy;
  hot_out[AX * WH + g] = o.ax;
  hot_out[AY * WH + g] = o.ay;
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
  Consts cs;
  memcpy(cs.v, consts_host, sizeof(cs.v));
  const size_t smem = substep_smem_bytes(stencil);
  dim3 block(SUB_TY, SUB_TX);
  dim3 grid((h + SUB_TY - 1) / SUB_TY, (w + SUB_TX - 1) / SUB_TX);
  const bool skip = pair_skip_allowed(cs.v);
  const auto kernel =
      rsqrt ? (rollgroup ? fused_substep2_kernel<true, true, true>
                         : fused_substep2_kernel<true, true, false>)
      : rollgroup ? (skip ? fused_substep2_kernel<true, false, true>
                          : fused_substep2_kernel<false, false, true>)
                  : (skip ? fused_substep2_kernel<true, false, false>
                          : fused_substep2_kernel<false, false, false>);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      hot, immut, far, obs_in, hot_out, obs_out, cs, w, h, stencil,
      quantized);
  return (int)cudaGetLastError();
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

// The kernel's residency at stencil radius `stencil`: out[0] blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers
// per thread, out[2] local (spill) bytes per thread, out[3] dynamic
// shared bytes per block, out[4] threads per block.
extern "C" int sb_fused_substep2_occupancy(int stencil, int* out) {
  const size_t smem = substep_smem_bytes(stencil);
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(
      &a, fused_substep2_kernel<true, false, false>);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], fused_substep2_kernel<true, false, false>, SUB_THREADS,
      smem);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  out[4] = SUB_THREADS;
  return err;
}
