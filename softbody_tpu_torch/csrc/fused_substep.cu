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
// substep reads 26 + 22 (+5) planes and writes 26: 296 MB, 88 us at
// 3.35 TB/s.  Evaluating every spring at both ends would read the
// owners' target, last, alive, spring and damp planes again at shifted
// addresses and take every spring's square root and divide twice.
//
// What the design does about it: K1's block substep (lattice_device.cuh,
// described in fused_substep2.cu): an 8 (W) x 32 (H) tile per block of
// 256 threads (__launch_bounds__(256, 4): K4 needs 63 registers, and at
// 5 blocks per SM it spilled 40 bytes and ran slower), the tile plus a
// halo of max(s, 1) of px py vx vy alive staged with cp.async while each
// thread loads its own target, last, alive, spring and damp planes; each
// spring (the tile's and its halo owners') evaluated once into force
// planes in shared memory, where each cell reads its reactions; a halo
// owner reads its own five planes, one row above and one column each side
// of the tile.  Collisions per thread at both ends from the staged tile,
// with the square root and divide only for pairs that can touch (where the
// launch's constants allow it: pair_skip_allowed, checked by the entry).
// The kernel reads `mut` and writes a separate `mut_out`.
//
// The constants (config.consts_vector) come from the launch's parameters,
// or from device memory (DEVC, sb_fused_substep_dev: a captured frame's
// constants and user input are device buffers): copied device to device
// into the kernel's __constant__ bank on the launch's stream just before
// the launch, and read there as the parameters are (K1's design,
// fused_substep2.cu); the pair skip is then the host's decision, passed
// with them.
//
// Exactness: sums in the plain version's (XLA) order, springs per class
// as -own + reaction, collisions per half offset as
// (acc + t(i, i+o)) - t(i-o, i).  A shared reaction is the value its
// owner computed from the same operands, so it is bit-identical to
// evaluating it again; outside the grid it is +0, the plain version's
// back() fill.  The coincident nudge is -sign(ox*H + oy); the TPU kernel
// hard-codes -1 on half offsets, which is the same value while H > s.
// With -fmad=false and no fast math the int32 spring sums and the edge
// planes equal the plain version's bit for bit.

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

// DEVC's constants, copied in from device memory before each launch
__constant__ float k4_consts_dev[N_CONSTS];

// SKIP: pair_skip_allowed for the launch's constants (as K1)
template <bool SKIP, bool DEVC>
__global__ void __launch_bounds__(SUB_THREADS, 4)
fused_substep_kernel(const float* __restrict__ mut,
                     const float* __restrict__ immut,
                     const float* __restrict__ far,
                     float* __restrict__ mut_out, const Consts cs, int w,
                     int h, int s, int quantized) {
  extern __shared__ float smem[];
  const int R = s > 1 ? s : 1;
  const size_t WH = (size_t)w * h;
  const int x0 = blockIdx.y * SUB_TX;
  const int y0 = blockIdx.x * SUB_TY;
  const SmemTile t = stage_tile_async(
      smem, mut + PX * WH, mut + PY * WH, mut + VX * WH, mut + VY * WH,
      immut + ALIVE * WH, x0, y0, R, w, h);
  uint32_t* fp = (uint32_t*)(smem + sub_stage_floats(R));
  const float* v = DEVC ? k4_consts_dev : cs.v;

  const int r = threadIdx.y, l = threadIdx.x;
  const int x = x0 + r, y = y0 + l;
  const bool live = x < w && y < h;
  const size_t g = live ? (size_t)x * h + y : 0;

  // own target, last, alive, spring, damp, loaded while the tile is in
  // flight
  float tgt[4], lst[4], spr[4], dmp[4];
  bool eal[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const size_t pm = (size_t)(MUT_EDGE0 + 5 * c) * WH;
    const size_t pi = (size_t)(IMM_EDGE0 + 5 * c) * WH;
    tgt[c] = live ? mut[pm + TGT * WH + g] : 0.0f;
    lst[c] = live ? mut[pm + LST * WH + g] : 0.0f;
    eal[c] = live && mut[pm + EAL * WH + g] > 0.0f;
    spr[c] = live ? immut[pi + SPR * WH + g] : 0.0f;
    dmp[c] = live ? immut[pi + DMP * WH + g] : 0.0f;
  }
  // this thread's halo owner (the last warps take them) and its planes
  int hc = 0, hr = 0, hl = 0;
  const bool halo =
      halo_owner(SUB_THREADS - 1 - (r * SUB_TY + l), hc, hr, hl);
  const bool halo_in = halo && x0 + hr >= 0 && x0 + hr < w &&
                       y0 + hl >= 0 && y0 + hl < h;
  float htgt = 0.0f, hlst = 0.0f, hspr = 0.0f, hdmp = 0.0f;
  bool heal = false;
  if (halo_in) {
    const size_t go = (size_t)(x0 + hr) * h + y0 + hl;
    const size_t pm = (size_t)(MUT_EDGE0 + 5 * hc) * WH;
    const size_t pi = (size_t)(IMM_EDGE0 + 5 * hc) * WH;
    htgt = mut[pm + TGT * WH + go];
    hlst = mut[pm + LST * WH + go];
    heal = mut[pm + EAL * WH + go] > 0.0f;
    hspr = immut[pi + SPR * WH + go];
    hdmp = immut[pi + DMP * WH + go];
  }
  stage_wait();

  const int lc = (r + R) * t.sy + l + R;
  const bool al_c = t.al[lc] > 0.0f;
  const float px = t.px[lc], py = t.py[lc];

  // ---- springs: own edges into the force planes, edge-state update ----
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dx = EDX[c], dy = EDY[c];
    const int lp = lc + dx * t.sy + dy;
    const Spring own =
        spring_eval(px, py, t.px[lp], t.py[lp],
                    eal[c] && al_c && t.al[lp] > 0.0f, tgt[c], lst[c],
                    spr[c], dmp[c]);
    fp[2 * c * SUB_FN + force_index(r, l)] = force_bits(own.fvx, quantized);
    fp[(2 * c + 1) * SUB_FN + force_index(r, l)] =
        force_bits(own.fvy, quantized);
    if (live) {
      // edge-state update, strain and stress every substep
      const size_t pm = (size_t)(MUT_EDGE0 + 5 * c) * WH;
      const size_t pi = (size_t)(IMM_EDGE0 + 5 * c) * WH;
      const float yld = immut[pi + YLD * WH + g];
      const float lim = immut[pi + LIM * WH + g];
      const float len = immut[pi + LEN * WH + g];
      const float strain = (own.ln - tgt[c]) / len;
      const bool yielded = fabsf(strain) > yld;
      const float new_tgt =
          yielded ? own.ln - yld * len * tsign(strain) : tgt[c];
      const bool breaks = fabsf(own.ln - len) > len * lim;
      mut_out[pm + TGT * WH + g] = own.active ? new_tgt : tgt[c];
      mut_out[pm + LST * WH + g] = own.active ? own.ln : lst[c];
      mut_out[pm + STR * WH + g] =
          own.active ? fabsf(strain) / yld : mut[pm + STR * WH + g];
      mut_out[pm + STS * WH + g] =
          own.active ? own.fmag * STRESS_SCALE : mut[pm + STS * WH + g];
      mut_out[pm + EAL * WH + g] =
          (eal[c] && !(own.active && breaks)) ? 1.0f : 0.0f;
    }
  }
  if (halo) {
    float fvx = 0.0f, fvy = 0.0f;  // +0 outside the grid: back()'s fill
    if (halo_in) {
      const int lo = (hr + R) * t.sy + hl + R;
      const int lp = lo + EDX[hc] * t.sy + EDY[hc];
      const Spring sp = spring_eval(
          t.px[lo], t.py[lo], t.px[lp], t.py[lp],
          heal && t.al[lo] > 0.0f && t.al[lp] > 0.0f, htgt, hlst, hspr,
          hdmp);
      fvx = sp.fvx;
      fvy = sp.fvy;
    }
    fp[2 * hc * SUB_FN + force_index(hr, hl)] = force_bits(fvx, quantized);
    fp[(2 * hc + 1) * SUB_FN + force_index(hr, hl)] =
        force_bits(fvy, quantized);
  }
  __syncthreads();
  float bfx, bfy;
  spring_sums(fp, r, l, quantized, bfx, bfy);
  if (!live) return;

  // ---- collisions: half offsets, (acc + t(i, i+o)) - t(i-o, i) --------
  Terms d = collide_half(t, lc, x, y, w, h, s, v[0], v[1], v[7], v[8],
                         SKIP);
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

template <bool DEVC>
int k4_launch(const float* mut, const float* immut, const float* far,
              float* mut_out, const Consts& cs, bool skip, int w, int h,
              int stencil, int quantized, void* stream, const float* cdev) {
  if (DEVC) {
    void* bank = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&bank, k4_consts_dev);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(bank, cdev, sizeof(k4_consts_dev),
                            cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = substep_smem_bytes(stencil);
  dim3 block(SUB_TY, SUB_TX);
  dim3 grid((h + SUB_TY - 1) / SUB_TY, (w + SUB_TX - 1) / SUB_TX);
  const auto kernel = skip ? fused_substep_kernel<true, DEVC>
                           : fused_substep_kernel<false, DEVC>;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      mut, immut, far, mut_out, cs, w, h, stencil, quantized);
  return (int)cudaGetLastError();
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
  return k4_launch<false>(mut, immut, far, mut_out, cs,
                          pair_skip_allowed(cs.v), w, h, stencil, quantized,
                          stream, nullptr);
}

// As sb_fused_substep, with the constants in device memory: `consts_dev`
// (20 floats, config.consts_vector; copied into the kernel's constant
// bank on `stream` before the launch) and `skip`, whether they allow the
// pair skip (pair_skip_allowed, decided on the host from the same
// values).  A captured graph replays with whatever the buffer holds.
extern "C" int sb_fused_substep_dev(const float* mut, const float* immut,
                                    const float* far, float* mut_out,
                                    const float* consts_dev, int skip,
                                    int w, int h, int stencil,
                                    int quantized, void* stream) {
  if (consts_dev == nullptr) return (int)cudaErrorInvalidValue;
  Consts cs;
  memset(cs.v, 0, sizeof(cs.v));
  return k4_launch<true>(mut, immut, far, mut_out, cs, skip != 0, w, h,
                         stencil, quantized, stream, consts_dev);
}

// The kernel's residency at stencil radius `stencil & 255`, as
// sb_fused_substep2_occupancy reports K1's (bit 16: the instance with the
// constants from device memory).
extern "C" int sb_fused_substep_occupancy(int stencil, int* out) {
  const bool devc = (stencil >> 16) & 1;
  stencil &= 255;
  const size_t smem = substep_smem_bytes(stencil);
  const auto kernel = devc ? fused_substep_kernel<true, true>
                           : fused_substep_kernel<true, false>;
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
