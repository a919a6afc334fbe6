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

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int PX = 0, PY = 1, VX = 2, VY = 3, AX = 4, AY = 5;
constexpr int EDGE0 = 6;                 // class c: tgt, lst, eal at 6 + 3c
constexpr int N_CONSTS = 20;
constexpr int N_EDGEC = 20;              // class c: spr dmp yld lim len at 20 + 5c
constexpr int TX = 8;                    // W rows per block
constexpr int TY = 32;                   // H lanes per block (threadIdx.x)
constexpr float FORCE_SCALE = 65536.0f;
constexpr float STRESS_SCALE = 0.05f;    // BEAM_STRESS_SCALE = 1/20

__constant__ int EDX[4] = {0, 1, 1, 1};
__constant__ int EDY[4] = {1, 0, 1, -1};

struct Consts {
  float v[N_CONSTS + N_EDGEC];
};

// torch semantics: NaN-propagating min/max/clamp, sign(NaN) = 0
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tsign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}
// torch.pow(tensor, scalar) fast paths for the exponents it special-cases
__device__ __forceinline__ float tpow(float x, float e) {
  if (e == 1.0f) return x;
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * x * x;
  if (e == 0.5f) return sqrtf(x);
  if (e == 0.0f) return 1.0f;
  return powf(x, e);
}

struct Spring {
  float fvx, fvy, ln, fmag;
  bool active;
};

// owner o, partner p = o + (dx, dy); identical at both endpoints
__device__ __forceinline__ Spring spring_eval(float opx, float opy,
                                              float ppx, float ppy,
                                              bool active, float tgt,
                                              float lst, float k, float c) {
  Spring r;
  float ddx = ppx - opx;
  float ddy = ppy - opy;
  float raw = sqrtf(ddx * ddx + ddy * ddy);
  bool zero = raw == 0.0f;
  if (zero) {
    ddx = 0.0f;
    ddy = -1.0e-10f;
  }
  r.ln = zero ? 1.0e-10f : raw;
  r.fmag = (tgt - r.ln) * k + (lst - r.ln) * c;
  float inv = 1.0f / r.ln;
  r.fvx = active ? r.fmag * ddx * inv : 0.0f;
  r.fvy = active ? r.fmag * ddy * inv : 0.0f;
  r.active = active;
  return r;
}

struct Terms {
  float dvx, dvy, dax, day, dyn;
};

// pair (base b, partner p = b + o): the term the base receives
__device__ __forceinline__ Terms pair_terms(float bpx, float bpy, float bvx,
                                            float bvy, bool bal, float ppx,
                                            float ppy, float pvx, float pvy,
                                            bool pal, float co_sign,
                                            float two_r, float dt2,
                                            float ecoeff, float friction) {
  Terms t;
  bool valid = bal && pal;
  float ddx = ppx - bpx;
  float ddy = ppy - bpy;
  float dist = sqrtf(ddx * ddx + ddy * ddy);
  bool coincident = valid && dist == 0.0f;
  bool overlap = valid && dist > 0.0f && dist < two_r;
  t.dyn = coincident ? co_sign : 0.0f;
  float inv = overlap ? 1.0f / dist : 0.0f;
  float nx = ddx * inv;
  float ny = ddy * inv;
  float rvx = bvx - pvx;
  float rvy = bvy - pvy;
  float imp_n = ecoeff * (rvx * nx + rvy * ny);
  float max_fric = imp_n * friction;
  float imp_t = tmin(tmax(rvx * -ny + rvy * nx, -max_fric), max_fric);
  float pdvx = -(imp_n * nx + imp_t * -ny);
  float pdvy = -(imp_n * ny + imp_t * nx);
  float clip = (two_r - dist) * 0.5f / dt2;
  float gate = overlap ? 1.0f : 0.0f;
  t.dax = -nx * clip * gate;
  t.day = -ny * clip * gate;
  t.dvx = overlap ? pdvx : 0.0f;
  t.dvy = overlap ? pdvy : 0.0f;
  return t;
}

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
  const int SX = TX + 2 * R;
  const int SY = TY + 2 * R;
  const int SN = SX * SY;
  float* s_px = smem;
  float* s_py = smem + SN;
  float* s_vx = smem + 2 * SN;
  float* s_vy = smem + 3 * SN;
  float* s_al = smem + 4 * SN;
  const size_t WH = (size_t)w * h;
  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;

  for (int i = threadIdx.y * TY + threadIdx.x; i < SN; i += TX * TY) {
    int gx = x0 - R + i / SY;
    int gy = y0 - R + i % SY;
    float px = 0.0f, py = 0.0f, vx = 0.0f, vy = 0.0f, al = 0.0f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      size_t g = (size_t)gx * h + gy;
      px = hot[PX * WH + g];
      py = hot[PY * WH + g];
      vx = hot[VX * WH + g];
      vy = hot[VY * WH + g];
      al = immut[g] > 0.0f ? 1.0f : 0.0f;
    }
    s_px[i] = px;
    s_py[i] = py;
    s_vx[i] = vx;
    s_vy[i] = vy;
    s_al[i] = al;
  }
  __syncthreads();

  const int x = x0 + threadIdx.y;
  const int y = y0 + threadIdx.x;
  if (x >= w || y >= h) return;
  const size_t g = (size_t)x * h + y;
  const int lc = (threadIdx.y + R) * SY + threadIdx.x + R;
  const float* v = cs.v;
  const float radius = v[0], dt = v[1], bounds = v[2], gx_ = v[3],
              gy_ = v[4], be = v[5], bf = v[6], ecoeff = v[7],
              friction = v[8], drag_c = v[9], drag_e = v[10], ustr = v[11],
              mact = v[12], mpx = v[13], mpy = v[14], mvx = v[15],
              mvy = v[16], afx = v[17], afy = v[18];
  const bool al_c = s_al[lc] > 0.0f;
  const float px = s_px[lc], py = s_py[lc], vx = s_vx[lc], vy = s_vy[lc];

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
  float dvx = 0.0f, dvy = 0.0f, dax = 0.0f, day = 0.0f, dyn = 0.0f;
  if (s > 0) {
    const float two_r = 2.0f * radius;
    const float dt2 = dt * dt;
    for (int ox = 0; ox <= s; ++ox) {
      for (int oy = -s; oy <= s; ++oy) {
        if (ox == 0 && oy <= 0) continue;
        // coincident nudge sign(lin_i - lin_j) = -sign(ox*H + oy)
        const float co_sign = -tsign((float)(ox * h + oy));
        const int lp = lc + ox * SY + oy;
        Terms t = pair_terms(px, py, vx, vy, al_c, s_px[lp], s_py[lp],
                             s_vx[lp], s_vy[lp], s_al[lp] > 0.0f, co_sign,
                             two_r, dt2, ecoeff, friction);
        Terms r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const int bx = x - ox, by = y - oy;
        if (bx >= 0 && bx < w && by >= 0 && by < h) {
          const int lb = lc - ox * SY - oy;
          r = pair_terms(s_px[lb], s_py[lb], s_vx[lb], s_vy[lb],
                         s_al[lb] > 0.0f, px, py, vx, vy, al_c, co_sign,
                         two_r, dt2, ecoeff, friction);
        }
        dvx = dvx + t.dvx - r.dvx;
        dvy = dvy + t.dvy - r.dvy;
        dax = dax + t.dax - r.dax;
        day = day + t.day - r.day;
        dyn = dyn + t.dyn - r.dyn;
      }
    }
  }
  if (far != nullptr) {
    dvx = dvx + far[g];
    dvy = dvy + far[WH + g];
    dax = dax + far[2 * WH + g];
    day = day + far[3 * WH + g];
    dyn = dyn + far[4 * WH + g];
  }

  // ---- integration (compute.wgsl:171-199) -----------------------------
  const float ax = hot[AX * WH + g], ay = hot[AY * WH + g];
  float p_x = px;
  float p_y = py + (al_c ? dyn : 0.0f);
  float v_x = vx + dvx;
  float v_y = vy + dvy;
  float a_x = ax + dax + gx_;
  float a_y = ay + day + gy_;

  const float speed = sqrtf(v_x * v_x + v_y * v_y);
  const bool moving = speed > 0.0f;
  const float inv_speed = 1.0f / (moving ? speed : 1.0f);
  a_x = a_x - (moving ? drag_c * tpow(fabsf(v_x), drag_e) * v_x * inv_speed
                      : 0.0f);
  a_y = a_y - (moving ? drag_c * tpow(fabsf(v_y), drag_e) * v_y * inv_speed
                      : 0.0f);

  a_x = a_x + afx * ustr;
  a_y = a_y + afy * ustr;

  const float mdx = mpx - p_x;
  const float mdy = mpy - p_y;
  const bool grabbed =
      (sqrtf(mdx * mdx + mdy * mdy) < radius * 10.0f) && (mact > 0.0f);
  a_x = a_x + (grabbed ? (mvx - v_x) * ustr - gx_ : 0.0f);
  a_y = a_y + (grabbed ? (mvy - v_y) * ustr - gy_ : 0.0f);

  a_x = a_x + bfx;
  a_y = a_y + bfy;

  v_x = v_x + a_x * dt;
  v_y = v_y + a_y * dt;
  p_x = p_x + v_x * dt;
  p_y = p_y + v_y * dt;

  const float lo = radius, hi = bounds - radius;
  const float cx_ = tclamp(p_x, lo, hi);
  const float cy_ = tclamp(p_y, lo, hi);
  const bool hit_x = p_x != cx_;
  const bool hit_y = p_y != cy_;
  const float one_be = 1.0f + be;

  const float fric_y = tsign(v_y) * bf * fabsf(v_x) * one_be;
  const float na_y = hit_x ? 0.0f - tmin(fric_y, 0.0f) : 0.0f;
  const float nv_x = hit_x ? v_x * -be : v_x;
  const float fric_x = tsign(nv_x) * bf * fabsf(v_y) * one_be;
  const float na_x = hit_y ? 0.0f - tmin(fric_x, 0.0f) : 0.0f;
  const float nv_y = hit_y ? v_y * -be : v_y;

  const bool keep = al_c && !(immut[WH + g] > 0.0f);
  hot_out[PX * WH + g] = keep ? cx_ : px;
  hot_out[PY * WH + g] = keep ? cy_ : py;
  hot_out[VX * WH + g] = keep ? nv_x : vx;
  hot_out[VY * WH + g] = keep ? nv_y : vy;
  hot_out[AX * WH + g] = keep ? na_x : ax;
  hot_out[AY * WH + g] = keep ? na_y : ay;
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
  const int R = stencil > 1 ? stencil : 1;
  const size_t smem = (size_t)5 * (TX + 2 * R) * (TY + 2 * R) * sizeof(float);
  dim3 block(TY, TX);
  dim3 grid((h + TY - 1) / TY, (w + TX - 1) / TX);
  fused_substep2_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      hot, immut, far, obs_in, hot_out, obs_out, cs, w, h, stencil,
      quantized);
  return (int)cudaGetLastError();
}
