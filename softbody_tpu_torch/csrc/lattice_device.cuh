// Device code shared by the lattice kernels K1 (fused_substep2.cu), K3
// (collide_stencil.cu) and K4 (fused_substep.cu): torch-semantics float
// helpers, the spring and pair math of compute.wgsl, the integration
// step, the cp.async staging helpers, and the block substep of K1 and K4
// (the section "block substep" below).  Every function evaluates the
// float32 operations of the plain torch versions
// (softbody_tpu_torch/ops/stencil.py) in the same order; with
// -fmad=false and no fast math each one rounds as there.
//
// Kernel variants.  spring_eval, pair_terms, integrate and collide_half
// take the JAX kernel's arithmetic variants as template flags, strict
// by default (K3 and K4 use only the defaults):
// - RSQRT: rsqrtf and products where strict takes sqrtf and a divide,
//   contact and grab tests on squared distances, the terms of a pair not
//   in contact +0 (fused_substep2.py:593-600, :736-745, :850-854,
//   :884-889).  rsqrtf is the card's approximate reciprocal square root
//   (rsqrt.approx.f32), which torch.rsqrt on CUDA tensors also runs;
// - ROLLGROUP (K1's collide_half and spring_sums): the partners'
//   reactions summed per dy after the loop over offsets or classes
//   (fused_substep2.py:646-658, :764-786).
//
// The block substep.  K1 and K4 are bound by device-memory bytes once
// their arithmetic is cut to what the inputs need.  Every spring and
// every collision pair that can touch costs an IEEE square root and
// divide, multi-instruction sequences under strict physics; taken at
// both ends of every spring and pair they take longer to issue than the
// bytes take to move.  The block substep:
// - springs are evaluated once per block: every cell's own spring of
//   class c, and those of the owners one row above and one column beside
//   the tile (the halo owners), go into a force plane in shared memory; a
//   cell takes its reaction there at owner = cell - d_c (+0 where the
//   owner lies outside the grid: the plain version's back() fill).  The
//   reaction is the value the owner computed from the same operands, so
//   sharing it is bit-identical;
// - a collision pair's square root and divide are taken only when the
//   pair can touch (pair_terms); the terms of a pair well apart are
//   zeros formed by a few products, cheap enough that each thread
//   evaluates both ends of its pairs from the staged tile, which on the
//   card costs less than passing them through shared memory;
// - the tile plus halo of px py vx vy alive is staged with cp.async (zero
//   fill outside the grid: the JAX zero pad) while the threads load their
//   own edge planes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// owner o, partner p = o + (dx, dy); identical at both endpoints.
// RSQRT: inv = rsqrt(d2) (1e10 at d2 = 0) and ln = d2 * inv.
template <bool RSQRT = false>
__device__ __forceinline__ Spring spring_eval(float opx, float opy,
                                              float ppx, float ppy,
                                              bool active, float tgt,
                                              float lst, float k, float c) {
  Spring r;
  float ddx = ppx - opx;
  float ddy = ppy - opy;
  float inv;
  if constexpr (RSQRT) {
    const float d2 = ddx * ddx + ddy * ddy;
    const bool zero = d2 == 0.0f;
    if (zero) {
      ddx = 0.0f;
      ddy = -1.0e-10f;
    }
    inv = zero ? 1.0e10f : rsqrtf(d2);
    r.ln = zero ? 1.0e-10f : d2 * inv;
    r.fmag = (tgt - r.ln) * k + (lst - r.ln) * c;
  } else {
    float raw = sqrtf(ddx * ddx + ddy * ddy);
    bool zero = raw == 0.0f;
    if (zero) {
      ddx = 0.0f;
      ddy = -1.0e-10f;
    }
    r.ln = zero ? 1.0e-10f : raw;
    r.fmag = (tgt - r.ln) * k + (lst - r.ln) * c;
    inv = 1.0f / r.ln;
  }
  r.fvx = active ? r.fmag * ddx * inv : 0.0f;
  r.fvy = active ? r.fmag * ddy * inv : 0.0f;
  r.active = active;
  return r;
}

struct Terms {
  float dvx, dvy, dax, day, dyn;
};

// Whether pair_terms may skip pairs apart under the consts vector `v`
// (config.consts_vector order), checked on the host once per launch of K1
// and K4: the conditions K3 checks (collide_stencil.cu:consts_allow_skip)
// with clip's factor, 1/dt^2 (K1, `inv_dt2`: the JAX kernel multiplies by
// it, fused_substep2.py:394) or a division by dt^2 (K4): ecoeff,
// friction, 2r and the factor finite, (2r)^2 a normal float, and clip
// finite at the largest finite distance (clip is monotonic in dist).
// Where clip overflows (dt^2 tiny or 0), the plain version's terms of a
// pair apart are ±0 × inf = NaN, which only the full path gives.  Under
// RSQRT the terms of a pair apart are +0 whatever the constants (each is
// selected, not multiplied by a gate): its skip needs no check.
inline bool pair_skip_allowed(const float* v, bool inv_dt2 = false) {
  const float big = 3.402823466e38f;
  const float two_r = 2.0f * v[0];
  const float dt2 = v[1] * v[1];
  const float scale = inv_dt2 ? 1.0f / dt2 : dt2;
  const float sq = two_r * two_r * 1.00001f;
  const float gap = (two_r - sqrtf(big)) * 0.5f;
  const float clip_far = inv_dt2 ? gap * scale : gap / scale;
  const float vals[] = {v[7], v[8], two_r, scale, sq, clip_far};
  for (float x : vals)
    if (!(fabsf(x) <= big)) return false;  // ±inf or NaN
  return sq >= 1.17549435e-38f;
}

// pair (base b, partner p = b + o): the term the base receives (K1, K4).
// `skip`: pair_skip_allowed for the launch's constants (RSQRT: always).
// `dt2s`: dt^2, or 1/dt^2 under INV_DT2 (K1: clip multiplies by it).
template <bool RSQRT = false, bool INV_DT2 = false>
__device__ __forceinline__ Terms pair_terms(float bpx, float bpy, float bvx,
                                            float bvy, bool bal, float ppx,
                                            float ppy, float pvx, float pvy,
                                            bool pal, float co_sign,
                                            float two_r, float dt2s,
                                            float ecoeff, float friction,
                                            bool skip) {
  Terms t;
  bool valid = bal && pal;
  float ddx = ppx - bpx;
  float ddy = ppy - bpy;
  const float d2 = ddx * ddx + ddy * ddy;
  if constexpr (RSQRT) {
    // contact where 0 < d2 < (2r)^2; every term of any other pair is +0,
    // so the test in the squared domain skips exactly the pairs apart
    const float two_r2 = two_r * two_r;
    t = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (skip && d2 >= two_r2) return t;
    const bool coincident = valid && d2 == 0.0f;
    const bool overlap = valid && d2 > 0.0f && d2 < two_r2;
    t.dyn = coincident ? co_sign : 0.0f;
    if (!overlap) return t;
    const float inv = rsqrtf(d2);
    const float dist = d2 * inv;
    const float nx = ddx * inv;
    const float ny = ddy * inv;
    const float rvx = bvx - pvx;
    const float rvy = bvy - pvy;
    const float imp_n = ecoeff * (rvx * nx + rvy * ny);
    const float max_fric = imp_n * friction;
    const float imp_t = tmin(tmax(rvx * -ny + rvy * nx, -max_fric), max_fric);
    t.dvx = -(imp_n * nx + imp_t * -ny);
    t.dvy = -(imp_n * ny + imp_t * nx);
    const float clip = INV_DT2 ? (two_r - dist) * 0.5f * dt2s
                               : (two_r - dist) * 0.5f / dt2s;
    t.dax = -nx * clip;
    t.day = -ny * clip;
    return t;
  }
  // Most pairs lie well apart (d2 above (2r)^2 by far more than rounding:
  // dist > two_r for sure, finite).  Then the terms below are 0 without
  // the square root and the divide: dvx dvy dyn +0, and dax = ((-nx) *
  // clip) * gate with nx = ddx * 0, clip < 0 (finite: `skip`) and gate
  // +0, a zero with ddx's sign (day likewise with ddy), formed here by the
  // same products with clip = -1.
  if (skip && d2 > two_r * two_r * 1.00001f && d2 <= 3.402823466e38f) {
    t.dyn = 0.0f;
    t.dvx = 0.0f;
    t.dvy = 0.0f;
    t.dax = -(ddx * 0.0f) * -1.0f * 0.0f;
    t.day = -(ddy * 0.0f) * -1.0f * 0.0f;
    return t;
  }
  float dist = sqrtf(d2);
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
  float clip = INV_DT2 ? (two_r - dist) * 0.5f * dt2s
                     : (two_r - dist) * 0.5f / dt2s;
  float gate = overlap ? 1.0f : 0.0f;
  t.dax = -nx * clip * gate;
  t.day = -ny * clip * gate;
  t.dvx = overlap ? pdvx : 0.0f;
  t.dvy = overlap ? pdvy : 0.0f;
  return t;
}

// A block's staged tile plus halo as five shared-memory planes px py vx
// vy alive (alive 1.0 / 0.0), row stride sy.
struct SmemTile {
  float *px, *py, *vx, *vy, *al;
  int sy;
};

struct Particle {
  float px, py, vx, vy, ax, ay;
};

// Body forces, drag, user force, mouse grab, semi-implicit Euler and the
// border (compute.wgsl:171-199).  `v` is the consts vector
// (config.consts_vector order).  RSQRT: 1/speed = rsqrt(|v|^2) and the
// grab test on squared distances.
template <bool RSQRT = false>
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

  float inv_speed;
  bool moving;
  if constexpr (RSQRT) {
    const float s2 = v_x * v_x + v_y * v_y;
    moving = s2 > 0.0f;
    inv_speed = rsqrtf(moving ? s2 : 1.0f);
  } else {
    const float speed = sqrtf(v_x * v_x + v_y * v_y);
    moving = speed > 0.0f;
    inv_speed = 1.0f / (moving ? speed : 1.0f);
  }
  a_x = a_x - (moving ? drag_c * tpow(fabsf(v_x), drag_e) * v_x * inv_speed
                      : 0.0f);
  a_y = a_y - (moving ? drag_c * tpow(fabsf(v_y), drag_e) * v_y * inv_speed
                      : 0.0f);

  a_x = a_x + afx * ustr;
  a_y = a_y + afy * ustr;

  const float mdx = mpx - p_x;
  const float mdy = mpy - p_y;
  const float grab_r = radius * 10.0f;
  const bool near = RSQRT ? mdx * mdx + mdy * mdy < grab_r * grab_r
                          : sqrtf(mdx * mdx + mdy * mdy) < grab_r;
  const bool grabbed = near && (mact > 0.0f);
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

// ---- block substep (K1, K4) ---------------------------------------------
//
// A block of SUB_TY x SUB_TX threads (one warp per tile row) owns a tile
// of SUB_TX rows (W) x SUB_TY lanes (H), one cell per thread.  Shared
// memory: the staged tile (sub_stage_floats(R)), then the four classes'
// spring-force planes.

constexpr int SUB_TX = 8;                    // W rows per block (threadIdx.y)
constexpr int SUB_TY = 32;                   // H lanes per block (threadIdx.x)
constexpr int SUB_THREADS = SUB_TX * SUB_TY;
// force planes: owners at tile rows -1 .. SUB_TX-1, lanes -1 .. SUB_TY
constexpr int SUB_FS = SUB_TY + 2;
constexpr int SUB_FN = (SUB_TX + 1) * SUB_FS;

__host__ __device__ __forceinline__ int sub_stage_floats(int R) {
  return 5 * (SUB_TX + 2 * R) * (SUB_TY + 2 * R);
}

// Dynamic shared memory of K1 and K4 at stencil radius s: the staged
// tile (halo R = max(s, 1): the springs need one cell) and the force
// planes.
__host__ __device__ __forceinline__ size_t substep_smem_bytes(int s) {
  const int R = s > 1 ? s : 1;
  return (size_t)(sub_stage_floats(R) + 8 * SUB_FN) * sizeof(float);
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool in) {
  // src-size 0 copies nothing and zero-fills the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Issue the copies of the tile plus a halo of R cells of five planes
// (px py vx vy alive, row stride SUB_TY + 2R) into shared memory: warp
// y takes rows y, y + SUB_TX, ..., its lanes the columns; cells outside
// the grid read zero, a dead particle at the origin.  Returns before the
// copies land: stage_wait() first.
__device__ __forceinline__ SmemTile stage_tile_async(
    float* smem, const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ alive, int x0, int y0, int R, int w, int h) {
  const int SX = SUB_TX + 2 * R;
  const int SY = SUB_TY + 2 * R;
  const int SN = SX * SY;
  SmemTile t = {smem, smem + SN, smem + 2 * SN, smem + 3 * SN, smem + 4 * SN,
                SY};
  for (int row = threadIdx.y; row < SX; row += SUB_TX) {
    const int gx = x0 - R + row;
    const bool row_in = gx >= 0 && gx < w;
    for (int col = threadIdx.x; col < SY; col += SUB_TY) {
      const int gy = y0 - R + col;
      const bool in = row_in && gy >= 0 && gy < h;
      const size_t g = in ? (size_t)gx * h + gy : 0;
      const int i = row * SY + col;
      cp_async_f32(t.px + i, px + g, in);
      cp_async_f32(t.py + i, py + g, in);
      cp_async_f32(t.vx + i, vx + g, in);
      cp_async_f32(t.vy + i, vy + g, in);
      cp_async_f32(t.al + i, alive + g, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return t;
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The spring owners outside the tile whose forces its cells take as
// reactions (owner = cell - d_c), one per item: class 0 (0, 1) the column
// left of the tile; class 1 (1, 0) the row above; class 2 (1, 1) the row
// above shifted left and the column left; class 3 (1, -1) the row above
// shifted right and the column right.  3 SUB_TX + 3 SUB_TY - 2 items.
// Item k gives the class and the owner's tile coordinates (r, l), or
// false past the last item.
__device__ __forceinline__ bool halo_owner(int k, int& c, int& r, int& l) {
  constexpr int EDGE = SUB_TY + SUB_TX - 1;  // classes 2 and 3
  if (k < SUB_TX) {
    c = 0; r = k; l = -1;
  } else if ((k -= SUB_TX) < SUB_TY) {
    c = 1; r = -1; l = k;
  } else if ((k -= SUB_TY) < EDGE) {
    c = 2; r = k < SUB_TY ? -1 : k - SUB_TY; l = k < SUB_TY ? k - 1 : -1;
  } else if ((k -= EDGE) < EDGE) {
    c = 3; r = k < SUB_TY ? -1 : k - SUB_TY; l = k < SUB_TY ? k + 1 : SUB_TY;
  } else {
    return false;
  }
  return true;
}

// A spring force as stored in a force plane: trunc(f * 2^16) as int32
// when quantized (compute.wgsl:127-130), else the float's bits.
__device__ __forceinline__ uint32_t force_bits(float f, int quantized) {
  return quantized ? (uint32_t)__float2int_rz(f * FORCE_SCALE)
                   : __float_as_uint(f);
}

// Index of owner (r, l) (tile coordinates) in a force plane.
__device__ __forceinline__ int force_index(int r, int l) {
  return (r + 1) * SUB_FS + l + 1;
}

// Spring forces of tile cell (r, l) from the force planes `fp` (class c:
// x at fp + 2c SUB_FN, y after it): per class -own + reaction, the order
// of ops/stencil.py::spring_pass (int32 sums wrap like XLA's).
// ROLLGROUP, float sums: per class -own, with the reaction at once only
// for class 1 (dy = 0); then the reactions of dy = 1 (classes 0, 2) and
// of dy = -1 (class 3), the groups of EDGE_OFFSETS in the order each dy
// first appears.  The int32 sums are exact in any order: unchanged.
template <bool ROLLGROUP = false>
__device__ __forceinline__ void spring_sums(const uint32_t* fp, int r, int l,
                                            int quantized, float& bfx,
                                            float& bfy) {
  uint32_t fxq = 0u, fyq = 0u;
  float fxf = 0.0f, fyf = 0.0f;
  const int io = force_index(r, l);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t* fx = fp + 2 * c * SUB_FN;
    const uint32_t* fy = fx + SUB_FN;
    const int ir = force_index(r - EDX[c], l - EDY[c]);
    if (quantized) {
      fxq = fxq - fx[io] + fx[ir];
      fyq = fyq - fy[io] + fy[ir];
    } else if (ROLLGROUP) {
      fxf = fxf - __uint_as_float(fx[io]);
      fyf = fyf - __uint_as_float(fy[io]);
      if (c == 1) {
        fxf = fxf + __uint_as_float(fx[ir]);
        fyf = fyf + __uint_as_float(fy[ir]);
      }
    } else {
      fxf = fxf - __uint_as_float(fx[io]) + __uint_as_float(fx[ir]);
      fyf = fyf - __uint_as_float(fy[io]) + __uint_as_float(fy[ir]);
    }
  }
  if (ROLLGROUP && !quantized) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c == 1) continue;
      const uint32_t* fx = fp + 2 * c * SUB_FN;
      const uint32_t* fy = fx + SUB_FN;
      const int ir = force_index(r - EDX[c], l - EDY[c]);
      fxf = fxf + __uint_as_float(fx[ir]);
      fyf = fyf + __uint_as_float(fy[ir]);
    }
  }
  if (quantized) {
    bfx = (float)(int32_t)fxq / FORCE_SCALE;
    bfy = (float)(int32_t)fyq / FORCE_SCALE;
  } else {
    bfx = fxf;
    bfy = fyf;
  }
}

// Collisions of the particle at staged cell lc, grid cell (x, y), over
// the half offsets of radius s, each applied as
// (acc + t(i, i+o)) - t(i-o, i): the order of
// ops/stencil.py::_stencil_collisions.  The thread evaluates both terms
// from the staged tile; pair_terms takes its square root and divide only
// for pairs that can touch (where `skip`, pair_skip_allowed), so a pair
// well apart costs a few products at each end, less than sharing it
// through shared memory would.
//
// ROLLGROUP: the same terms, each evaluated once, in another order:
// first every offset's own term t(i, i+o) and, for dy = 0, its reaction,
// in offset order; then, one dy group at a time (1 .. s, then -s .. -1:
// the order each dy first appears among the half offsets), the group's
// reactions t(i-o, i) summed in offset order from its first, and the sum
// subtracted.  One group sum is live at a time (the loops are reordered,
// not 2s partial sums kept).
__device__ __forceinline__ Terms add_terms(Terms a, Terms b) {
  return {a.dvx + b.dvx, a.dvy + b.dvy, a.dax + b.dax, a.day + b.day,
          a.dyn + b.dyn};
}
__device__ __forceinline__ Terms sub_terms(Terms a, Terms b) {
  return {a.dvx - b.dvx, a.dvy - b.dvy, a.dax - b.dax, a.day - b.day,
          a.dyn - b.dyn};
}

template <bool RSQRT = false, bool ROLLGROUP = false, bool INV_DT2 = false>
__device__ __forceinline__ Terms collide_half(const SmemTile& t, int lc,
                                              int x, int y, int w, int h,
                                              int s, float radius, float dt,
                                              float ecoeff, float friction,
                                              bool skip) {
  Terms acc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (s <= 0) return acc;
  const float px = t.px[lc], py = t.py[lc], vx = t.vx[lc], vy = t.vy[lc];
  const bool al_c = t.al[lc] > 0.0f;
  const float two_r = 2.0f * radius;
  const float dt2s = INV_DT2 ? 1.0f / (dt * dt) : dt * dt;
  // t(i-o, i), +0 where i-o lies outside the grid (back()'s fill)
  auto reaction = [&](int ox, int oy, float co_sign) {
    Terms r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int bx = x - ox, by = y - oy;
    if (bx >= 0 && bx < w && by >= 0 && by < h) {
      const int lb = lc - ox * t.sy - oy;
      r = pair_terms<RSQRT, INV_DT2>(t.px[lb], t.py[lb], t.vx[lb],
                                     t.vy[lb], t.al[lb] > 0.0f, px, py, vx,
                                     vy, al_c, co_sign, two_r, dt2s, ecoeff,
                                     friction, skip);
    }
    return r;
  };
  for (int ox = 0; ox <= s; ++ox) {
    for (int oy = -s; oy <= s; ++oy) {
      if (ox == 0 && oy <= 0) continue;
      // coincident nudge sign(lin_i - lin_j) = -sign(ox*H + oy)
      const float co_sign = -tsign((float)(ox * h + oy));
      const int lp = lc + ox * t.sy + oy;
      const Terms a = pair_terms<RSQRT, INV_DT2>(
          px, py, vx, vy, al_c, t.px[lp], t.py[lp], t.vx[lp], t.vy[lp],
          t.al[lp] > 0.0f, co_sign, two_r, dt2s, ecoeff, friction, skip);
      if (ROLLGROUP && oy != 0) {
        acc = add_terms(acc, a);
      } else {
        acc = sub_terms(add_terms(acc, a), reaction(ox, oy, co_sign));
      }
    }
  }
  if (ROLLGROUP) {
    for (int gi = 0; gi < 2 * s; ++gi) {
      const int oy = gi < s ? gi + 1 : gi - 2 * s;
      Terms g = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int ox = oy > 0 ? 0 : 1; ox <= s; ++ox) {
        const Terms r = reaction(ox, oy, -tsign((float)(ox * h + oy)));
        g = ox == (oy > 0 ? 0 : 1) ? r : add_terms(g, r);
      }
      acc = sub_terms(acc, g);
    }
  }
  return acc;
}

}  // namespace
