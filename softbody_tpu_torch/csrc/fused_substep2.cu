// K1: one whole lattice substep, hand-written for Hopper (sm_90a).
//
// Replaces: softbody_tpu/ops/pallas/fused_substep2.py:_kernel2 (the
// Pallas TPU kernel launched by fused_substep2_call), strict physics
// only (no kernel variants).  Plain version:
// softbody_tpu_torch/ops/stencil.py (substep_planes), reached through
// softbody_tpu_torch/ops/cuda/fused_substep2.py:fused_substep2_plain.
//
// What bounds it on the card: device-memory bytes.  At 1M particles a
// substep reads 18 hot + 2 immutable + 5 far planes (+8 obs when
// observing) and writes 18 (+8): ~170 MB, ~50 us at 3.35 TB/s.  The
// arithmetic (~8 spring and ~24 pair evaluations per particle, each
// with an IEEE sqrt and divide) is below that.
//
// What the design does about it:
// - one thread per particle on a 32 (H, fastest index) x 8 (W) tile, so
//   every plane load and store is a coalesced 128-byte row;
// - the tile plus a halo of max(s, 1) of px, py, vx, vy, alive is staged
//   once in shared memory; every stencil read hits it.  Out-of-range
//   cells read as dead particles at the origin (the JAX zero pad);
// - the kernel reads `hot` and writes a separate `hot_out` (neighbours
//   must see the previous substep), so nothing is read twice from
//   device memory except the owners' edge planes of the reaction
//   springs, which hit L1/L2.
//
// Exactness: each particle evaluates its 4 owned edges (-f) and the 4
// edges owned by (x-dx, y-dy) (+f) with the owner's operand order, and
// each collision half offset as (acc + t(i, i+o)) - t(i-o, i), the
// order of the plain version.  Built with -fmad=false and without fast
// math, every float op rounds as in torch, so the int32 spring sums and
// the edge planes equal the plain version's bit for bit.

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

__global__ void __launch_bounds__(TX * TY)
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
  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;
  const SmemTile t = stage_tile(smem, hot + PX * WH, hot + PY * WH,
                                hot + VX * WH, hot + VY * WH, immut, x0, y0,
                                R, w, h);
  const float* s_px = t.px;
  const float* s_py = t.py;
  const float* s_al = t.al;
  const int SY = t.sy;

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const int lc = (threadIdx.y + R) * SY + threadIdx.x + R;
  const float* v = cs.v;
  const bool al_c = s_al[lc] > 0.0f;
  const float px = s_px[lc], py = s_py[lc];

  // ---- springs: own edges (-f, edge-state update) + reactions (+f) ----
  uint32_t fxq = 0u, fyq = 0u;  // int32 sums, wrapping like XLA's
  float fxf = 0.0f, fyf = 0.0f;
  for (int c = 0; c < 4; ++c) {
    const int dx = EDX[c], dy = EDY[c];
    const float k = v[N_CONSTS + 5 * c + 0];
    const float damp = v[N_CONSTS + 5 * c + 1];
    const float yld = v[N_CONSTS + 5 * c + 2];
    const float lim = v[N_CONSTS + 5 * c + 3];
    const float len = v[N_CONSTS + 5 * c + 4];
    const size_t pt = (size_t)(EDGE0 + 3 * c) * WH;
    const float tgt = hot[pt + g];
    const float lst = hot[pt + WH + g];
    const bool eal = hot[pt + 2 * WH + g] > 0.0f;

    // own edge: self -> self + (dx, dy)
    const int lp = lc + dx * SY + dy;
    const bool pal = s_al[lp] > 0.0f;
    Spring own = spring_eval(px, py, s_px[lp], s_py[lp], eal && al_c && pal,
                             tgt, lst, k, damp);
    // reaction: owner self - (dx, dy) -> self
    Spring rea;
    rea.fvx = rea.fvy = 0.0f;
    const int ox = x - dx, oy = y - dy;
    if (ox >= 0 && ox < w && oy >= 0 && oy < h) {
      const size_t go = (size_t)ox * h + oy;
      const int lo = lc - dx * SY - dy;
      const bool oal = s_al[lo] > 0.0f;
      const bool oeal = hot[pt + 2 * WH + go] > 0.0f;
      rea = spring_eval(s_px[lo], s_py[lo], px, py, oeal && oal && al_c,
                        hot[pt + go], hot[pt + WH + go], k, damp);
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

    // edge-state update of the own edge
    const float strain = (own.ln - tgt) / len;
    const bool yielded = fabsf(strain) > yld;
    const float new_tgt = yielded ? own.ln - yld * len * tsign(strain) : tgt;
    const bool breaks = fabsf(own.ln - len) > len * lim;
    hot_out[pt + g] = own.active ? new_tgt : tgt;
    hot_out[pt + WH + g] = own.active ? own.ln : lst;
    hot_out[pt + 2 * WH + g] = (eal && !(own.active && breaks)) ? 1.0f : 0.0f;
    if (obs_in != nullptr) {
      const size_t po = (size_t)(2 * c) * WH;
      obs_out[po + g] = own.active ? fabsf(strain) / yld : obs_in[po + g];
      obs_out[po + WH + g] =
          own.active ? own.fmag * STRESS_SCALE : obs_in[po + WH + g];
    }
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
  const Particle in = {px, py, t.vx[lc], t.vy[lc], hot[AX * WH + g],
                       hot[AY * WH + g]};
  const Particle o =
      integrate(in, al_c, immut[WH + g] > 0.0f, d, bfx, bfy, v);
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
extern "C" int sb_fused_substep2(const float* hot, const float* immut,
                                 const float* far, const float* obs_in,
                                 float* hot_out, float* obs_out,
                                 const float* consts_host, int w, int h,
                                 int stencil, int quantized, void* stream) {
  Consts cs;
  memcpy(cs.v, consts_host, sizeof(cs.v));
  const size_t smem = tile_smem_bytes(stencil > 1 ? stencil : 1);
  dim3 block(TY, TX);
  dim3 grid((h + TY - 1) / TY, (w + TX - 1) / TX);
  fused_substep2_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      hot, immut, far, obs_in, hot_out, obs_out, cs, w, h, stencil,
      quantized);
  return (int)cudaGetLastError();
}
