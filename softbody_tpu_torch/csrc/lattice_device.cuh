// Device code shared by the lattice kernels K1 (fused_substep2.cu), K3
// (collide_stencil.cu) and K4 (fused_substep.cu): torch-semantics float
// helpers, the spring and pair math of compute.wgsl, the staged
// shared-memory tile, the half-offset collision sum and the integration
// step.  Every function evaluates the float32 operations of the plain
// torch versions (softbody_tpu_torch/ops/stencil.py) in the same order;
// with -fmad=false and no fast math each one rounds as there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;                    // W rows per block (threadIdx.y)
constexpr int TY = 32;                   // H lanes per block (threadIdx.x)
constexpr float FORCE_SCALE = 65536.0f;
constexpr float STRESS_SCALE = 0.05f;    // BEAM_STRESS_SCALE = 1/20

__constant__ int EDX[4] = {0, 1, 1, 1};
__constant__ int EDY[4] = {1, 0, 1, -1};

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

// A block's tile of TX x TY particles plus a halo of R cells, as five
// shared-memory planes px py vx vy alive (alive 1.0 / 0.0), row stride
// sy = TY + 2R.  Out-of-range cells hold dead particles at the origin.
struct SmemTile {
  float *px, *py, *vx, *vy, *al;
  int sy;
};

__host__ __device__ __forceinline__ size_t tile_smem_bytes(int R) {
  return (size_t)5 * (TX + 2 * R) * (TY + 2 * R) * sizeof(float);
}

// Stage the block's tile; `alive` is any type whose value > 0 means
// alive (bool planes, float 1.0 / 0.0 planes).  Ends with a barrier.
template <typename A>
__device__ __forceinline__ SmemTile stage_tile(
    float* smem, const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const A* __restrict__ alive, int x0, int y0, int R, int w, int h) {
  const int SX = TX + 2 * R;
  const int SY = TY + 2 * R;
  const int SN = SX * SY;
  SmemTile t = {smem, smem + SN, smem + 2 * SN, smem + 3 * SN, smem + 4 * SN,
                SY};
  for (int i = threadIdx.y * TY + threadIdx.x; i < SN; i += TX * TY) {
    int gx = x0 - R + i / SY;
    int gy = y0 - R + i % SY;
    float a = 0.0f, b = 0.0f, c = 0.0f, d = 0.0f, e = 0.0f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      size_t g = (size_t)gx * h + gy;
      a = px[g];
      b = py[g];
      c = vx[g];
      d = vy[g];
      e = (float)alive[g] > 0.0f ? 1.0f : 0.0f;
    }
    t.px[i] = a;
    t.py[i] = b;
    t.vx[i] = c;
    t.vy[i] = d;
    t.al[i] = e;
  }
  __syncthreads();
  return t;
}

// Collisions of particle (x, y) at tile cell lc over the half offsets of
// radius s, each applied as (acc + t(i, i+o)) - t(i-o, i): the order of
// ops/stencil.py::_stencil_collisions.
__device__ __forceinline__ Terms collide_half(const SmemTile& t, int lc,
                                              int x, int y, int w, int h,
                                              int s, float radius, float dt,
                                              float ecoeff, float friction) {
  Terms acc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (s <= 0) return acc;
  const float px = t.px[lc], py = t.py[lc], vx = t.vx[lc], vy = t.vy[lc];
  const bool al_c = t.al[lc] > 0.0f;
  const float two_r = 2.0f * radius;
  const float dt2 = dt * dt;
  for (int ox = 0; ox <= s; ++ox) {
    for (int oy = -s; oy <= s; ++oy) {
      if (ox == 0 && oy <= 0) continue;
      // coincident nudge sign(lin_i - lin_j) = -sign(ox*H + oy)
      const float co_sign = -tsign((float)(ox * h + oy));
      const int lp = lc + ox * t.sy + oy;
      Terms a = pair_terms(px, py, vx, vy, al_c, t.px[lp], t.py[lp],
                           t.vx[lp], t.vy[lp], t.al[lp] > 0.0f, co_sign,
                           two_r, dt2, ecoeff, friction);
      Terms r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const int bx = x - ox, by = y - oy;
      if (bx >= 0 && bx < w && by >= 0 && by < h) {
        const int lb = lc - ox * t.sy - oy;
        r = pair_terms(t.px[lb], t.py[lb], t.vx[lb], t.vy[lb],
                       t.al[lb] > 0.0f, px, py, vx, vy, al_c, co_sign, two_r,
                       dt2, ecoeff, friction);
      }
      acc.dvx = acc.dvx + a.dvx - r.dvx;
      acc.dvy = acc.dvy + a.dvy - r.dvy;
      acc.dax = acc.dax + a.dax - r.dax;
      acc.day = acc.day + a.day - r.day;
      acc.dyn = acc.dyn + a.dyn - r.dyn;
    }
  }
  return acc;
}

struct Particle {
  float px, py, vx, vy, ax, ay;
};

// Body forces, drag, user force, mouse grab, semi-implicit Euler and the
// border (compute.wgsl:171-199).  `v` is the consts vector
// (config.consts_vector order).
__device__ __forceinline__ Particle integrate(Particle in, bool al_c,
                                              bool pinned, Terms d, float bfx,
                                              float bfy, const float* v) {
  const float radius = v[0], dt = v[1], bounds = v[2], gx_ = v[3],
              gy_ = v[4], be = v[5], bf = v[6], drag_c = v[9],
              drag_e = v[10], ustr = v[11], mact = v[12], mpx = v[13],
              mpy = v[14], mvx = v[15], mvy = v[16], afx = v[17],
              afy = v[18];
  float p_x = in.px;
  float p_y = in.py + (al_c ? d.dyn : 0.0f);
  float v_x = in.vx + d.dvx;
  float v_y = in.vy + d.dvy;
  float a_x = in.ax + d.dax + gx_;
  float a_y = in.ay + d.day + gy_;

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

  const bool keep = al_c && !pinned;
  return keep ? Particle{cx_, cy_, nv_x, nv_y, na_x, na_y} : in;
}

}  // namespace
