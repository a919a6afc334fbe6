// K4: one whole lattice substep with per-edge parameter planes,
// hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/fused_substep.py:_kernel (the Pallas
// TPU kernel launched by fused_substep_call).  Plain version:
// softbody_tpu_torch/ops/stencil.py (substep_planes), reached through
// softbody_tpu_torch/ops/cuda/fused_substep.py:fused_substep_plain.
//
// K4 is K1's physics (fused_substep2.cu) with two differences: the edge
// parameters (spring damp yield limit length) are planes of `immut`,
// not one value per edge class, and every substep writes each edge's
// strain and stress into `mut`.  Layout (contiguous f32, H innermost):
//   mut   [26, W, H]: px py vx vy ax ay, class c at 6 + 5c: target last
//                     strain stress alive
//   immut [22, W, H]: alive pinned, class c at 2 + 5c: spring damp yield
//                     limit length
//   far   [5, W, H] (optional): dvx dvy dax day dyn, added to the
//                     stencil's terms
//
// What bounds it on the card: device-memory bytes.  At 1M particles a
// substep reads 26 + 22 (+5) planes and writes 26: ~300 MB, ~90 us at
// 3.35 TB/s.
//
// What the design does about it: the tile layout of K1 (one thread per
// particle, 32 (H) x 8 (W), tile + halo of max(s, 1) of px py vx vy alive
// in shared memory, coalesced rows).  Each particle evaluates its 4 own
// edges and the 4 edges owned by (x-dx, y-dy); a reaction edge reads the
// owner's target, last and spring/damp planes at the owner's cell, which
// hit L1/L2.  The kernel reads `mut` and writes a separate `mut_out`.
//
// Exactness: sums in the plain version's (XLA) order, springs per class
// as -own + reaction, collisions per half offset as
// (acc + t(i, i+o)) - t(i-o, i).  The coincident nudge is
// -sign(ox*H + oy); the TPU kernel hard-codes -1 on half offsets, which
// is the same value while H > s.  With -fmad=false and no fast math the
// int32 spring sums and the edge planes equal the plain version's bit
// for bit.

#include <string.h>

#include "lattice_device.cuh"

namespace {

constexpr int PX = 0, PY = 1, VX = 2, VY = 3, AX = 4, AY = 5;
constexpr int MUT_EDGE0 = 6;  // class c: tgt lst str sts eal at 6 + 5c
constexpr int TGT = 0, LST = 1, STR = 2, STS = 3, EAL = 4;
constexpr int ALIVE = 0, PINNED = 1;
constexpr int IMM_EDGE0 = 2;  // class c: spr dmp yld lim len at 2 + 5c
constexpr int SPR = 0, DMP = 1, YLD = 2, LIM = 3, LEN = 4;
constexpr int N_CONSTS = 20;

struct Consts {
  float v[N_CONSTS];
};

__global__ void __launch_bounds__(TX * TY)
fused_substep_kernel(const float* __restrict__ mut,
                     const float* __restrict__ immut,
                     const float* __restrict__ far,
                     float* __restrict__ mut_out, const Consts cs, int w,
                     int h, int s, int quantized) {
  extern __shared__ float smem[];
  const int R = s > 1 ? s : 1;
  const size_t WH = (size_t)w * h;
  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;
  const SmemTile t =
      stage_tile(smem, mut + PX * WH, mut + PY * WH, mut + VX * WH,
                 mut + VY * WH, immut + ALIVE * WH, x0, y0, R, w, h);

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const int lc = (threadIdx.y + R) * t.sy + threadIdx.x + R;
  const float* v = cs.v;
  const bool al_c = t.al[lc] > 0.0f;
  const float px = t.px[lc], py = t.py[lc];

  // ---- springs: own edges (-f, edge-state update) + reactions (+f) ----
  uint32_t fxq = 0u, fyq = 0u;  // int32 sums, wrapping like XLA's
  float fxf = 0.0f, fyf = 0.0f;
  for (int c = 0; c < 4; ++c) {
    const int dx = EDX[c], dy = EDY[c];
    const size_t pm = (size_t)(MUT_EDGE0 + 5 * c) * WH;
    const size_t pi = (size_t)(IMM_EDGE0 + 5 * c) * WH;
    const float tgt = mut[pm + TGT * WH + g];
    const float lst = mut[pm + LST * WH + g];
    const bool eal = mut[pm + EAL * WH + g] > 0.0f;
    const float yld = immut[pi + YLD * WH + g];
    const float lim = immut[pi + LIM * WH + g];
    const float len = immut[pi + LEN * WH + g];

    // own edge: self -> self + (dx, dy)
    const int lp = lc + dx * t.sy + dy;
    const bool pal = t.al[lp] > 0.0f;
    Spring own = spring_eval(px, py, t.px[lp], t.py[lp], eal && al_c && pal,
                             tgt, lst, immut[pi + SPR * WH + g],
                             immut[pi + DMP * WH + g]);
    // reaction: owner self - (dx, dy) -> self, with the owner's planes
    Spring rea;
    rea.fvx = rea.fvy = 0.0f;
    const int ox = x - dx, oy = y - dy;
    if (ox >= 0 && ox < w && oy >= 0 && oy < h) {
      const size_t go = (size_t)ox * h + oy;
      const int lo = lc - dx * t.sy - dy;
      const bool oal = t.al[lo] > 0.0f;
      const bool oeal = mut[pm + EAL * WH + go] > 0.0f;
      rea = spring_eval(t.px[lo], t.py[lo], px, py, oeal && oal && al_c,
                        mut[pm + TGT * WH + go], mut[pm + LST * WH + go],
                        immut[pi + SPR * WH + go], immut[pi + DMP * WH + go]);
    }
    if (quantized) {
      fxq = fxq - (uint32_t)__float2int_rz(own.fvx * FORCE_SCALE)
            + (uint32_t)__float2int_rz(rea.fvx * FORCE_SCALE);
      fyq = fyq - (uint32_t)__float2int_rz(own.fvy * FORCE_SCALE)
            + (uint32_t)__float2int_rz(rea.fvy * FORCE_SCALE);
    } else {
      fxf = fxf - own.fvx + rea.fvx;
      fyf = fyf - own.fvy + rea.fvy;
    }

    // edge-state update of the own edge, strain and stress every substep
    const float strain = (own.ln - tgt) / len;
    const bool yielded = fabsf(strain) > yld;
    const float new_tgt = yielded ? own.ln - yld * len * tsign(strain) : tgt;
    const bool breaks = fabsf(own.ln - len) > len * lim;
    mut_out[pm + TGT * WH + g] = own.active ? new_tgt : tgt;
    mut_out[pm + LST * WH + g] = own.active ? own.ln : lst;
    mut_out[pm + STR * WH + g] =
        own.active ? fabsf(strain) / yld : mut[pm + STR * WH + g];
    mut_out[pm + STS * WH + g] =
        own.active ? own.fmag * STRESS_SCALE : mut[pm + STS * WH + g];
    mut_out[pm + EAL * WH + g] =
        (eal && !(own.active && breaks)) ? 1.0f : 0.0f;
  }
  float bfx, bfy;
  if (quantized) {
    bfx = (float)(int32_t)fxq / FORCE_SCALE;
    bfy = (float)(int32_t)fyq / FORCE_SCALE;
  } else {
    bfx = fxf;
    bfy = fyf;
  }

  // ---- collisions: half offsets, (acc + t(i, i+o)) - t(i-o, i) --------
  Terms d = collide_half(t, lc, x, y, w, h, s, v[0], v[1], v[7], v[8]);
  if (far != nullptr) {
    d.dvx = d.dvx + far[g];
    d.dvy = d.dvy + far[WH + g];
    d.dax = d.dax + far[2 * WH + g];
    d.day = d.day + far[3 * WH + g];
    d.dyn = d.dyn + far[4 * WH + g];
  }

  // ---- integration (compute.wgsl:171-199) -----------------------------
  const Particle in = {px, py, t.vx[lc], t.vy[lc], mut[AX * WH + g],
                       mut[AY * WH + g]};
  const Particle o =
      integrate(in, al_c, immut[PINNED * WH + g] > 0.0f, d, bfx, bfy, v);
  mut_out[PX * WH + g] = o.px;
  mut_out[PY * WH + g] = o.py;
  mut_out[VX * WH + g] = o.vx;
  mut_out[VY * WH + g] = o.vy;
  mut_out[AX * WH + g] = o.ax;
  mut_out[AY * WH + g] = o.ay;
}

}  // namespace

// Pointers are device pointers except `consts_host` (20 floats, copied
// into the launch by value).  `far` may be null.
extern "C" int sb_fused_substep(const float* mut, const float* immut,
                                const float* far, float* mut_out,
                                const float* consts_host, int w, int h,
                                int stencil, int quantized, void* stream) {
  Consts cs;
  memcpy(cs.v, consts_host, sizeof(cs.v));
  dim3 block(TY, TX);
  dim3 grid((h + TY - 1) / TY, (w + TX - 1) / TX);
  fused_substep_kernel<<<grid, block, tile_smem_bytes(stencil > 1 ? stencil : 1),
                         (cudaStream_t)stream>>>(mut, immut, far, mut_out, cs,
                                                 w, h, stencil, quantized);
  return (int)cudaGetLastError();
}
