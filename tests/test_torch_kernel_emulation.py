"""The CUDA sources of K1, K2, K3, K4 and K8 run on the CPU, in emulation,
against their plain versions.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here their sources are compiled with the host C++
compiler against a small emulation of the CUDA they use: one
``std::thread`` per CUDA thread of a block (reused from block to block);
``std::barrier`` for ``__syncthreads`` and, with a shared flag, for
``__syncthreads_and``; ``__constant__`` arrays as globals, filled by
``cudaMemcpyAsync`` at once; per warp of 32 threads a barrier behind which
each lane reads the others' posted values, for ``__all_sync``,
``__ballot_sync``, ``__shfl_xor_sync`` and ``__reduce_{max,min}_sync``;
the 4- and 8-byte ``cp.async`` copies land
only when ``cp.async.wait_group 0`` waits for the group
``cp.async.commit_group`` closed (zero fill included; shared memory
starts as NaN, so a copy read before it is committed and waited for
shows); ``__grid_constant__`` is a by-value parameter; the launch is a
loop over blocks.  Float arithmetic is IEEE
single precision without contraction (``-ffp-contract=off``, as the
kernels' ``-fmad=false`` build) and x86's square root and divide are
correctly rounded, so every output plane must equal the plain version bit
for bit (NaN where the plain version has NaN).  This holds the kernels'
indexing — tiles, halos, ragged edges, strided and interleaved planes,
the spring reactions shared through shared memory, every barrier reached
by every thread — and the skip of pairs that cannot touch (K3, and K1/K4
under constants that forbid it), K1's detect pass on its edge cases and
non-finite halos (``kernel_cases.py``), K2's compile-time box (chunk ≤ 4)
and the box set at launch (chunks 8 and 16), K8's pair terms and
ordered sums on an overlap-rich pile (``kernel_cases.far_collapse``), at
shapes and stencils the CPU can afford.  Skipped where there is no
``g++``."""

import ctypes
import dataclasses
import itertools
import os
import re
import shutil
import subprocess

import pytest
import torch

import numpy as np

import softbody_tpu_torch as tb
from softbody_tpu_torch.config import N_CONSTS
from softbody_tpu_torch.models import make_lattice
from softbody_tpu_torch.ops.cuda import band_detect, collide_stencil, far_apply
from softbody_tpu_torch.ops.cuda import fused_substep, fused_substep2
from softbody_tpu_torch.ops.cuda._lib import CSRC, HEADERS
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import host_decisions
from torch_threads import two_torch_threads  # noqa: F401

import kernel_cases
from kernel_cases import same_bits

EMULATED = ("fused_substep2.cu", "fused_substep.cu", "collide_stencil.cu",
            "band_detect.cu", "far_apply.cu")

RUNTIME_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <algorithm>
#include <array>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 {
  float x, y;
};
// a block: its barrier and vote, and per warp of 32 threads a barrier and
// two sets of lane slots for the warp collectives
struct EmuBlock {
  unsigned threads, dim_x;
  std::barrier<> bar;
  std::atomic<int> vote{1};
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::array<std::array<uint32_t, 32>, 2>> warp_slots;
  EmuBlock(unsigned n, unsigned dx)
      : threads(n), dim_x(dx), bar(n), warp_slots((n + 31) / 32) {
    for (unsigned w = 0; w < (n + 31) / 32; ++w)
      warp_bar.emplace_back(std::make_unique<std::barrier<>>(warp_lanes(w)));
  }
  unsigned warp_lanes(unsigned w) const {
    return threads - 32 * w < 32 ? threads - 32 * w : 32;
  }
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local EmuBlock* emu_block;
inline thread_local float* emu_shared;
inline thread_local unsigned emu_warp_calls;
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
// __syncthreads_and: every thread clears the flag or not, reads it after
// a barrier, and the flag is set again behind a second barrier before
// anyone votes anew
inline int __syncthreads_and(int pred) {
  EmuBlock& b = *emu_block;
  if (!pred) b.vote.store(0);
  b.bar.arrive_and_wait();
  const int all = b.vote.load();
  b.bar.arrive_and_wait();
  if (threadIdx.x == 0 && threadIdx.y == 0) b.vote.store(1);
  b.bar.arrive_and_wait();
  return all;
}
// A warp collective: each lane posts a 4-byte value into this call's set
// of slots, one barrier, then each lane reads the slots it needs.  The
// sets alternate from call to call: a lane can be one call ahead of a
// slower lane, never two (the barrier between waits for it), so no set
// is written while it is read.
struct EmuWarp {
  const std::array<uint32_t, 32>& slot;
  unsigned lane, lanes;
};
inline EmuWarp emu_warp_post(uint32_t v) {
  EmuBlock& b = *emu_block;
  const unsigned lin = threadIdx.y * b.dim_x + threadIdx.x;
  std::array<uint32_t, 32>& slot =
      b.warp_slots[lin / 32][emu_warp_calls++ & 1u];
  slot[lin % 32] = v;
  b.warp_bar[lin / 32]->arrive_and_wait();
  return {slot, lin % 32, b.warp_lanes(lin / 32)};
}
inline bool __all_sync(unsigned, int pred) {
  const EmuWarp w = emu_warp_post(pred != 0);
  for (unsigned i = 0; i < w.lanes; ++i)
    if (!w.slot[i]) return false;
  return true;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const EmuWarp w = emu_warp_post(pred != 0);
  unsigned out = 0u;
  for (unsigned i = 0; i < w.lanes; ++i) out |= w.slot[i] << i;
  return out;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const EmuWarp w = emu_warp_post(v);
  unsigned out = 0u;
  for (unsigned i = 0; i < w.lanes; ++i) out = std::max(out, w.slot[i]);
  return out;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const EmuWarp w = emu_warp_post(v);
  unsigned out = ~0u;
  for (unsigned i = 0; i < w.lanes; ++i) out = std::min(out, w.slot[i]);
  return out;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  uint32_t u;
  std::memcpy(&u, &v, 4);
  const EmuWarp w = emu_warp_post(u);
  T out;
  std::memcpy(&out, &w.slot[w.lane ^ (unsigned)lane_mask], 4);
  return out;
}
using std::max;
using std::min;
// the card's rsqrtf is an approximation (rsqrt.approx.f32); the plain
// version on the CPU takes torch's rsqrt, which rounds as 1/sqrtf
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline int __ffs(int x) { return x ? __builtin_ctz((unsigned)x) + 1 : 0; }
inline int __ffsll(long long x) {
  return x ? __builtin_ctzll((unsigned long long)x) + 1 : 0;
}
// cp.async: a copy is queued, a commit closes the queued copies into
// groups, wait_group 0 lands every closed group (copies never committed
// never land)
struct EmuCopy {
  void* dst;
  const void* src;
  int bytes;
  bool in;
};
inline thread_local std::vector<EmuCopy> emu_queued, emu_committed;
inline void emu_cp_async(void* dst, const void* src, int bytes, bool in) {
  emu_queued.push_back({dst, src, bytes, in});
}
inline void emu_commit() {
  emu_committed.insert(emu_committed.end(), emu_queued.begin(),
                       emu_queued.end());
  emu_queued.clear();
}
inline void emu_wait_all() {
  for (const EmuCopy& c : emu_committed) {
    if (c.in)
      std::memcpy(c.dst, c.src, c.bytes);
    else
      std::memset(c.dst, 0, c.bytes);
  }
  emu_committed.clear();
}
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
// __constant__ arrays are globals here; a copy into one lands at once
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
template <class T>
cudaError_t cudaGetSymbolAddress(void** p, T& symbol) {
  *p = (void*)&symbol;
  return 0;
}
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  std::memcpy(dst, src, n);
  return 0;
}
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the launch allocates the shared memory it is given (emu_launch)
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 0;
  return 0;
}
// cvt.rzi.s32.f32: truncate, saturate, NaN -> 0
inline int __float2int_rz(float f) {
  if (std::isnan(f)) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f <= -2147483648.0f) return (int)0x80000000u;
  return (int)f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// blocks one after another, run by one set of threads (a thread per CUDA
// thread of a block, reused for every block); a block's shared memory
// starts as NaN so that a read before any write shows.  `fence` (not the
// block's barrier) separates the blocks: a thread that returns early
// waits there.
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  const unsigned n = block.x * block.y;
  std::vector<float> shared(smem / 4 + 1);
  EmuBlock blk(n, block.x);
  std::barrier<> fence(n);
  std::vector<std::thread> threads;
  for (unsigned i = 0; i < n; ++i)
    threads.emplace_back([&, i] {
      threadIdx = dim3(i % block.x, i / block.x);
      gridDim = grid;
      emu_block = &blk;
      emu_shared = shared.data();
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          if (i == 0) std::fill(shared.begin(), shared.end(), std::nanf(""));
          fence.arrive_and_wait();
          blockIdx = dim3(bx, by);
          emu_warp_calls = 0;
          emu_queued.clear();
          emu_committed.clear();
          f();
          fence.arrive_and_wait();
        }
    });
  for (auto& t : threads) t.join();
}
"""


def _emulated_source(text: str) -> str:
    """A kernel source rewritten for the emulation: dynamic shared memory,
    the cp.async copies of 4 and 8 bytes (queued; src-size 0
    zero-fills), their commit and wait, and the launch syntax."""
    text = text.replace("extern __shared__ float smem[];",
                        "float* smem = emu_shared;")
    text = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global '
                  r'\[%0\], \[%1\], (4|8), %2;.*?: "memory"\);',
                  lambda m: f"emu_cp_async(dst, src, {m.group(1)}, in);",
                  text, flags=re.S)
    text = text.replace(
        'asm volatile("cp.async.commit_group;\\n" ::: "memory");',
        "emu_commit();")
    text = text.replace(
        'asm volatile("cp.async.wait_group 0;\\n" ::: "memory");',
        "emu_wait_all();")
    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                  lambda m: (f"emu_launch({m.group(2)}, [&]() "
                             f"{{ {m.group(1)}({m.group(3)}); }});"),
                  text, flags=re.S)
    if "asm" in text or "<<<" in text:
        raise AssertionError("a construct the emulation does not cover")
    return text


class _TwoCores:
    """The emulated library, each call run with the calling thread held to
    two cores: the threads the emulation starts (one per CUDA thread)
    inherit that, so tests running beside this file keep the other
    cores.  The calling thread's cores are restored after each call."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not hasattr(os, "sched_setaffinity"):
            return fn

        def call(*args):
            cpus = os.sched_getaffinity(0)
            os.sched_setaffinity(0, sorted(cpus)[:2])
            try:
                return fn(*args)
            finally:
                os.sched_setaffinity(0, cpus)

        return call


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the CPU")
    d = tmp_path_factory.mktemp("emulated_kernels")
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    for name in EMULATED + HEADERS:
        (d / name).write_text(_emulated_source((CSRC / name).read_text()))

    def run(*args):
        out = subprocess.run([gxx, *args], capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"g++ {' '.join(args)}:\n{out.stderr}")

    objs = []
    for name in EMULATED:
        obj = d / (name + ".o")
        run("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread",
            f"-I{d}", "-x", "c++", "-c", str(d / name), "-o", str(obj))
        objs.append(str(obj))
    so = d / "libemulated.so"
    run("-shared", "-pthread", "-o", str(so), *objs)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sb_fused_substep2.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.sb_fused_substep2_variant.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.sb_fused_substep2_mode.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.sb_fused_substep2_modex.argtypes = [p] * 10 + [i] * 10 + [p, p]
    lib.sb_fused_substep.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.sb_collide_stencil.argtypes = [p] * 6 + [f] * 4 + [i] * 3 + [p]
    lib.sb_collide_stencil_strided.argtypes = ([p] * 7 + [f] * 4 + [i] * 3
                                               + [p])
    lib.sb_band_flags.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.sb_fused_substep2_dev.argtypes = [p] * 10 + [i] * 11 + [p, p]
    lib.sb_fused_substep_dev.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.sb_collide_stencil_dev.argtypes = [p] * 8 + [i] * 4 + [p]
    q = ctypes.c_longlong
    lib.sb_far_pairs.argtypes = ([p] * 5 + [q, q, i, i] + [p] * 3
                                 + [i, i, q, i] + [f] * 4 + [p] * 4)
    lib.sb_far_accumulate.argtypes = [p] * 4 + [i] * 3 + [p, i, i, p]
    for fn in (lib.sb_far_pairs, lib.sb_far_accumulate, lib.sb_fused_substep2, lib.sb_fused_substep2_variant,
               lib.sb_fused_substep2_mode, lib.sb_fused_substep2_modex,
               lib.sb_fused_substep2_dev, lib.sb_fused_substep,
               lib.sb_fused_substep_dev, lib.sb_collide_stencil,
               lib.sb_collide_stencil_strided, lib.sb_collide_stencil_dev,
               lib.sb_band_flags):
        fn.restype = i
    return _TwoCores(lib)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _state(w, h, seed):
    """A stirred ``w × h`` lattice: springs yield and break and particles
    collide in one substep; 5% of the particles and 10% of the edges
    dead."""
    spacing = 20.0
    state = make_lattice(w, h, spacing, spring=200.0, damp=10.0,
                         yield_strain=0.18, strain_limit=0.22, device="cpu")
    g = torch.Generator().manual_seed(seed)

    def noise(scale):
        return torch.randn(state.pos.shape, generator=g) * scale

    edges = tuple(dataclasses.replace(
        e, alive=e.alive & (torch.rand((w, h), generator=g) > 0.1))
        for e in state.edges)
    state = dataclasses.replace(
        state, pos=state.pos + noise(0.3 * spacing),
        vel=state.vel + noise(6.0 * spacing), edges=edges,
        alive=torch.rand((w, h), generator=g) > 0.05)
    cfg = tb.StaticConfig(subticks=64, collision_mode="allpairs",
                          particle_radius=spacing * 0.35)
    return state, cfg, tb.PhysicsConstants(gravity=(0.0, -1.0)), g


# shapes that are multiples of no tile side (8 or 16 rows, 32 lanes), one
# a single lane wide
SHAPES = [(37, 45), (64, 1)]
SHAPE_IDS = [f"{w}x{h}" for w, h in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [0, 1, 2, 3])
def test_k1_source_matches_plain(lib, stencil, shape):
    w, h = shape
    state, cfg, consts, g = _state(w, h, seed=w + h)
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    far = torch.randn((5, w, h), generator=g) * 0.5
    for quantized, with_far, observe in itertools.product(
            (True, False), (False, True), (False, True)):
        kw = dict(stencil=stencil, quantized=quantized,
                  far=far if with_far else None,
                  obs_in=obs if observe else None)
        ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
        got_hot = torch.empty_like(hot)
        got_obs = torch.empty_like(obs) if observe else None
        assert lib.sb_fused_substep2(
            _ptr(hot), _ptr(immut), _ptr(kw["far"]), _ptr(kw["obs_in"]),
            _ptr(got_hot), _ptr(got_obs), _ptr(cvec), w, h, stencil,
            int(quantized), None) == 0
        ref_hot, ref_obs = ref if observe else (ref, None)
        case = f"quantized={quantized} far={with_far} observe={observe}"
        assert torch.equal(got_hot, ref_hot), case
        if observe:
            assert torch.equal(got_obs, ref_obs), case


@pytest.mark.parametrize("rsqrt,rollgroup", [(True, False), (False, True),
                                             (True, True)],
                         ids=["rsqrt", "rollgroup", "rsqrt+rollgroup"])
def test_k1_variant_sources_match_plain(lib, rsqrt, rollgroup):
    """K1's instances under the arithmetic variants against the plain
    version with the same flags (``rsqrtf`` emulated as torch's CPU
    ``rsqrt``), at stencils 1 and 3, quantized and float, with a far
    stack and the mouse grabbing, and observing; under ``rsqrt`` also with
    dt = 1e-19 (clip overflows; the variant's skip stays on: the terms of
    a pair apart are +0 there whatever the constants).  The radius is
    0.8 spacings, so that most pairs out to offset (1, 1) touch and the
    sums of one Δy group, and the groups themselves, meet in one cell."""
    w, h = SHAPES[0]
    state, cfg, consts, g = _state(w, h, seed=29)
    cfg = dataclasses.replace(cfg, particle_radius=16.0)
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    uin = tb.UserInput(mouse_active=True,
                       mouse_pos=tuple(state.pos[w // 2, h // 2].tolist()),
                       mouse_vel=(3.0, -1.0))
    cvec = torch.cat([tb.consts_vector(consts, uin, cfg, h), ec])
    far = torch.randn((5, w, h), generator=g) * 0.5
    tiny_dt = cvec.clone()
    tiny_dt[1] = 1e-19
    cases = [(cvec, s, q, far, obs) for s in (1, 3) for q in (True, False)]
    if rsqrt:
        cases.append((tiny_dt, 2, True, None, None))
    flags = dict(rsqrt=rsqrt, rollgroup=rollgroup)
    for cv, stencil, quantized, f, obs_in in cases:
        ref = fused_substep2.fused_substep2_plain(
            hot, immut, cv, stencil=stencil, quantized=quantized, far=f,
            obs_in=obs_in, **flags)
        got_hot = torch.empty_like(hot)
        got_obs = None if obs_in is None else torch.empty_like(obs)
        assert lib.sb_fused_substep2_variant(
            _ptr(hot), _ptr(immut), _ptr(f), _ptr(obs_in), _ptr(got_hot),
            _ptr(got_obs), _ptr(cv), w, h, stencil, int(quantized),
            int(rsqrt), int(rollgroup), None) == 0
        ref_hot, ref_obs = ref if obs_in is not None else (ref, None)
        case = f"s={stencil} quantized={quantized} dt={float(cv[1])}"
        assert same_bits(got_hot, ref_hot), case
        if obs_in is not None:
            assert torch.equal(got_obs, ref_obs), case
        strict = fused_substep2.fused_substep2_plain(
            hot, immut, cv, stencil=stencil, quantized=quantized, far=f)
        if not quantized or rsqrt:   # the variant is not strict here
            assert not torch.equal(strict, ref_hot), case


def _k1_mode_source(lib, hot, immut, cvec, *, stencil, quantized, far=None,
                    obs_in=None, refs=None, detect=False, rsqrt=False,
                    rollgroup=False, nospring=False, noint=False,
                    side_fill=None):
    """K1's source through its mode entry, the trig partials reduced as
    the wrapper reduces them: ``(hot', obs' or None, stats or None, side
    or None)``."""
    w, h = hot.shape[1:]
    got_hot = torch.empty_like(hot)
    got_obs = None if obs_in is None else torch.empty_like(obs_in)
    nb = -(-h // 32) * -(-w // 8)
    stats = None if refs is None else torch.empty((nb, 4))
    side = None
    if detect:
        side = torch.full((9, -(-w // 4), h),
                          float("nan") if side_fill is None else side_fill)
    assert lib.sb_fused_substep2_mode(
        _ptr(hot), _ptr(immut), _ptr(far), _ptr(obs_in), _ptr(refs),
        _ptr(got_hot), _ptr(got_obs), _ptr(stats), _ptr(side), _ptr(cvec),
        w, h, stencil, int(quantized), int(rsqrt), int(rollgroup),
        int(refs is not None), int(detect), int(nospring), int(noint),
        None) == 0
    if stats is not None:
        stats = torch.cat([stats[:, :2].amax(0), stats[:, 2:].sum(0)])
    return got_hot, got_obs, stats, side


def _mode_extras(state, cfg, *, tau, det, t_band):
    """The far-field frames' scalars: the band's mean velocity, T_band and
    base reach 2r + one spacing."""
    alive = state.alive
    vbar = state.vel[alive].mean(0).tolist()
    return torch.tensor([tau, det, vbar[0], vbar[1], t_band,
                         2.0 * cfg.particle_radius + 20.0, 0.03, 0.0],
                        dtype=torch.float32)


# (modes, rsqrt, rollgroup, stencil, quantized, state): the stirred
# lattice (``_state``), detect's edge cases
# (``kernel_cases.band_scenarios``), or non-finite velocities in the
# staged halo (``kernel_cases.halo_nonfinite``)
MODE_CASES = [
    (("trig",), False, False, 2, True, "stirred"),
    (("detect",), False, False, 1, True, "stirred"),
    (("detect",), True, True, 2, False, "stirred"),
    (("trig", "detect"), False, False, 2, False, "stirred"),
    (("nospring",), False, False, 2, True, "stirred"),
    (("noint",), False, True, 1, False, "stirred"),
    (("nospring", "noint"), True, False, 2, True, "stirred"),
    (("detect",), False, False, 2, True, "bound"),
    (("trig", "detect"), False, False, 2, True, "bound"),
    (("detect",), True, True, 2, False, "nonfinite"),
    (("trig", "detect"), False, False, 2, False, "nonfinite"),
]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize(
    "modes,rsqrt,rollgroup,stencil,quantized,kind", MODE_CASES,
    ids=["+".join(c[0]) + ("-rsqrt" if c[1] else "")
         + ("-rollgroup" if c[2] else "")
         + ("" if c[5] == "stirred" else f"-{c[5]}") for c in MODE_CASES])
def test_k1_mode_sources_match_plain(lib, shape, modes, rsqrt, rollgroup,
                                     stencil, quantized, kind):
    """K1's modes against the plain version with the same flags, with a far
    stack and observing: the output state bit for bit; ``detect``: the
    side planes bit for bit (W = 37 ends in a partial group of rows), band
    flags both set and clear; ``trig``: the maxima bit for bit, the sums
    within 1e-5 relative (their order differs: butterflies per warp, the
    warps, then the blocks); the knobs: what passes through equals the
    input.  ``bound``: detect's edge cases, each scenario's cells flagged
    as it expects; ``nonfinite``: NaN and ±inf velocities in the staged
    halo, garbage in dead partners (NaN where the plain version has
    NaN)."""
    w, h = shape
    state, cfg, consts, g = _state(w, h, seed=41 + w + stencil)
    want = {}
    if kind == "bound":
        state, want = kernel_cases.band_scenarios(
            state, 20.0, float(np.float32(2.0 * cfg.particle_radius + 20.0)))
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    base = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    trig, detect = "trig" in modes, "detect" in modes
    refs = None
    cvec = base
    if trig or detect:
        # T_band: a band whose flags are neither all set nor all clear
        cvec = torch.cat([base, _mode_extras(
            state, cfg, tau=0.05, det=1.0,
            t_band=0.02 if stencil == 1 else 0.06)])
    if kind == "nonfinite":
        # (the band's mean velocity is the stirred state's)
        hot, obs, immut, ec = fused_substep2.pack_lattice2(
            kernel_cases.halo_nonfinite(state, seed=w + h))
    if trig:
        refs = (hot[:4] + torch.randn((4, w, h), generator=g)).contiguous()
    far = torch.randn((5, w, h), generator=g) * 0.5
    kw = dict(stencil=stencil, quantized=quantized, far=far, obs_in=obs,
              refs=refs, detect=detect, rsqrt=rsqrt, rollgroup=rollgroup,
              nospring="nospring" in modes, noint="noint" in modes)
    if trig or detect:
        kw["obs_in"] = None if detect else obs
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
    ref = list(ref) if isinstance(ref, tuple) else [ref]
    got_hot, got_obs, got_stats, got_side = _k1_mode_source(
        lib, hot, immut, cvec, **kw)
    assert same_bits(got_hot, ref.pop(0))
    if kw["obs_in"] is not None:
        ref_obs = ref.pop(0)
        assert torch.equal(got_obs, ref_obs)
        if "nospring" in modes:
            assert torch.equal(ref_obs, obs)
    if trig:
        ref_stats = ref.pop(0)
        assert same_bits(got_stats[:2], ref_stats[:2])
        # the sums within 1e-5 of the sums of |v| (chip_smoke.py's
        # TRIG_SUM_RTOL), non-finite sums equal; the stirred lattice's
        # within 1e-5 of themselves too
        alive = immut[0] > 0
        scale = torch.stack([torch.where(alive, got_hot[k].abs(), 0.0).sum()
                             for k in (2, 3)])
        fin = torch.isfinite(ref_stats[2:])
        assert same_bits(got_stats[2:][~fin], ref_stats[2:][~fin])
        assert bool(((got_stats[2:] - ref_stats[2:]).abs()[fin]
                     <= 1e-5 * scale[fin]).all())
        if kind == "stirred":
            torch.testing.assert_close(got_stats[2:], ref_stats[2:],
                                       rtol=1e-5, atol=0.0)
    if detect:
        ref_side = ref.pop(0)
        assert same_bits(got_side, ref_side)
        alive_groups = ref_side[0] < 1e38
        band = ref_side[8][alive_groups]
        assert 0 < int(band.sum()) < band.numel()
    if want:
        ex = cvec[N_CONSTS + fused_substep2.N_EDGEC:].tolist()
        alive = immut[0] > 0
        flags = band_detect.band_flags_plain(
            hot[0], hot[1], torch.zeros((w, h)),
            torch.full((w, h), ex[fused_substep2.X_REACH]), alive,
            fused_substep2._band_offsets(stencil))
        for (x, y), hit in want.items():
            assert bool(flags[x, y]) == hit, (x, y)
            assert bool(got_side[8, x // 4, y]) == any(
                bool(flags[x4, y]) for x4 in range(x - x % 4,
                                                   min(w, x - x % 4 + 4)))
    if "nospring" in modes:
        assert torch.equal(got_hot[6:], hot[6:])
    if "noint" in modes:
        assert torch.equal(got_hot[:6], hot[:6])


def test_k1_detect_source_flag_off(lib):
    """``detect`` with the consts' detect flag off: the side planes are not
    written, the state is the flag-on state."""
    w, h = SHAPES[0]
    state, cfg, consts, _g = _state(w, h, seed=47)
    hot, _obs, immut, ec = fused_substep2.pack_lattice2(state)
    base = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    outs = []
    for det in (0.0, 1.0):
        cvec = torch.cat([base, _mode_extras(state, cfg, tau=0.0, det=det,
                                             t_band=0.02)])
        outs.append(_k1_mode_source(lib, hot, immut, cvec, stencil=2,
                                    quantized=True, detect=True,
                                    side_fill=-7.0))
    assert bool((outs[0][3] == -7.0).all())
    assert not bool((outs[1][3] == -7.0).any())
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("modes", [("trig",), ("detect",),
                                   ("trig", "detect")],
                         ids=["trig", "detect", "trig+detect"])
def test_k1_device_extras_match_consts(lib, modes):
    """The far-field scalars read by the kernel from device memory
    (``sb_fused_substep2_modex``, the captured frames' entry: the 40
    constants alone, then the scalars' own pointer) against the same
    scalars appended to the constants (``sb_fused_substep2_mode``) and
    against the plain version given them as ``extras``: the state, the
    trig statistics and the side planes bit for bit."""
    w, h = SHAPES[0]
    state, cfg, consts, g = _state(w, h, seed=53)
    hot, _obs, immut, ec = fused_substep2.pack_lattice2(state)
    base = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    extras = _mode_extras(state, cfg, tau=0.05, det=1.0, t_band=0.06)
    trig, detect = "trig" in modes, "detect" in modes
    refs = ((hot[:4] + torch.randn((4, w, h), generator=g)).contiguous()
            if trig else None)
    far = torch.randn((5, w, h), generator=g) * 0.5
    kw = dict(stencil=2, quantized=True, far=far, refs=refs, detect=detect)
    want = _k1_mode_source(lib, hot, immut, torch.cat([base, extras]), **kw)
    got_hot = torch.empty_like(hot)
    nb = -(-h // 32) * -(-w // 8)
    stats = torch.empty((nb, 4)) if trig else None
    side = torch.full((9, -(-w // 4), h), float("nan")) if detect else None
    assert lib.sb_fused_substep2_modex(
        _ptr(hot), _ptr(immut), _ptr(far), None, _ptr(refs), _ptr(got_hot),
        None, _ptr(stats), _ptr(side), _ptr(base), w, h, 2, 1, 0, 0,
        int(trig), int(detect), 0, 0, None, _ptr(extras)) == 0
    assert same_bits(got_hot, want[0])
    if trig:
        assert same_bits(torch.cat([stats[:, :2].amax(0),
                                    stats[:, 2:].sum(0)]), want[2])
    if detect:
        assert same_bits(side, want[3])
    plain = fused_substep2.fused_substep2_call(hot, immut, base,
                                               extras=extras, **kw)
    plain = [plain] if isinstance(plain, torch.Tensor) else list(plain)
    assert same_bits(got_hot, plain.pop(0))
    if trig:
        assert same_bits(stats[:, :2].amax(0), plain.pop(0)[:2])
    if detect:
        assert same_bits(side, plain.pop(0))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [0, 1, 2, 3])
def test_k4_source_matches_plain(lib, stencil, shape):
    """Per-edge varied edge parameters."""
    w, h = shape
    state, cfg, consts, g = _state(w, h, seed=3 + w + h)
    mut, immut = fused_substep.pack_lattice(state)
    immut[2:] *= 0.5 + torch.rand(immut[2:].shape, generator=g)
    cvec = tb.consts_vector(consts, tb.UserInput(), cfg, h)
    far = torch.randn((5, w, h), generator=g) * 0.5
    for quantized, with_far in itertools.product((True, False),
                                                 (False, True)):
        kw = dict(stencil=stencil, quantized=quantized,
                  far=far if with_far else None)
        ref = fused_substep.fused_substep_plain(mut, immut, cvec, **kw)
        got = torch.empty_like(mut)
        assert lib.sb_fused_substep(
            _ptr(mut), _ptr(immut), _ptr(kw["far"]), _ptr(got), _ptr(cvec),
            w, h, stencil, int(quantized), None) == 0
        assert torch.equal(got, ref), f"quantized={quantized} far={with_far}"


@pytest.mark.parametrize("stencil", [1, 2])
def test_k1_k4_sources_constants_that_overflow_clip(lib, stencil):
    """With dt = 1e-19, clip = (2r − dist)·0.5/dt² overflows for every pair
    apart, whose plain terms are then ±0 × inf = NaN: the entries' check
    of the constants (pair_skip_allowed) must keep every pair on the full
    path, NaN where the plain version has NaN."""
    w, h = SHAPES[0]
    state, cfg, consts, g = _state(w, h, seed=19 + stencil)
    hot, _obs, immut, ec = fused_substep2.pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    cvec[1] = 1e-19
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec,
                                              stencil=stencil, quantized=True)
    got = torch.empty_like(hot)
    assert lib.sb_fused_substep2(_ptr(hot), _ptr(immut), None, None,
                                 _ptr(got), None, _ptr(cvec), w, h, stencil,
                                 1, None) == 0
    nan = torch.isnan(ref[:6]).any(0)
    assert 0 < int(nan.sum()) < nan.numel()
    assert same_bits(got, ref), "K1"
    mut, immut4 = fused_substep.pack_lattice(state)
    cvec4 = cvec[:N_CONSTS].clone()
    ref = fused_substep.fused_substep_plain(mut, immut4, cvec4,
                                            stencil=stencil, quantized=True)
    got = torch.empty_like(mut)
    assert lib.sb_fused_substep(_ptr(mut), _ptr(immut4), None, _ptr(got),
                                _ptr(cvec4), w, h, stencil, 1, None) == 0
    assert bool(torch.isnan(ref[:6]).any())
    assert same_bits(got, ref), "K4"


# (kernel, dt, drag_exp): the device-constants entries against the
# by-value ones; dt = 1e-19 overflows clip, so the host's decision must
# turn the pair skip off as the by-value entries' own check does
DEVC_CASES = [("K1", 1.0 / 64, 1.5), ("K1", 1e-19, 3.3), ("K1 modes", 1.0 / 64,
                                                          2.0),
              ("K4", 1.0 / 64, 3.3), ("K4", 1e-19, 2.0), ("K3", 1.0 / 64, 2.0),
              ("K3", 1e-19, 2.0)]


@pytest.mark.parametrize("kernel,dt,drag_exp", DEVC_CASES,
                         ids=[f"{k}-dt{dt:g}-e{e:g}".replace(" ", "-")
                              for k, dt, e in DEVC_CASES])
def test_device_constants_entries_match_by_value(lib, kernel, dt, drag_exp):
    """K1's, K4's and K3's entries that read their constants from device
    memory (``*_dev``, the captured frames': the pair skip passed in, as
    ``stencil.host_decisions`` decides it) against the entries that take
    them by value (which decide it themselves), bit for bit (NaN where
    NaN), with the mouse grabbing and a keyboard force: K1 strict and
    rsqrt+rollgroup, and in its trig+detect and knobs modes; K4; K3 on
    the interleaved views."""
    w, h = SHAPES[0]
    state, cfg, consts, g = _state(w, h, seed=61)
    consts = dataclasses.replace(consts, drag_exp=drag_exp)
    uin = tb.UserInput(mouse_active=True, user_strength=1.5,
                       mouse_pos=tuple(state.pos[w // 2, h // 2].tolist()),
                       mouse_vel=(3.0, -1.0), applied_force=(0.5, 0.25))
    base = tb.consts_vector(consts, uin, cfg, h)
    base[1] = dt
    dec = host_decisions(cfg.particle_radius, dt, consts.ecoeff,
                         consts.friction, drag_exp)
    assert (dt < 1e-10) != dec.k1_skip
    far = torch.randn((5, w, h), generator=g) * 0.5
    if kernel == "K3":
        views = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
                 state.vel[..., 1])
        strides = np.ascontiguousarray([t.stride() for t in views],
                                       np.int64)
        two_r, inv_dt2 = collide_stencil._scalars(cfg.particle_radius, dt)
        want, got = (torch.empty((5, w, h)) for _ in range(2))
        assert lib.sb_collide_stencil_strided(
            *(_ptr(t) for t in views), strides.ctypes.data,
            _ptr(state.alive), _ptr(want), two_r, inv_dt2,
            float(np.float32(consts.ecoeff)),
            float(np.float32(consts.friction)), w, h, 2, None) == 0
        assert lib.sb_collide_stencil_dev(
            *(_ptr(t) for t in views), strides.ctypes.data,
            _ptr(state.alive), _ptr(got), _ptr(base), int(dec.k3_skip), w,
            h, 2, None) == 0
        assert same_bits(got, want)
        return
    if kernel == "K4":
        mut, immut = fused_substep.pack_lattice(state)
        want, got = torch.empty_like(mut), torch.empty_like(mut)
        assert lib.sb_fused_substep(_ptr(mut), _ptr(immut), _ptr(far),
                                    _ptr(want), _ptr(base), w, h, 2, 1,
                                    None) == 0
        assert lib.sb_fused_substep_dev(_ptr(mut), _ptr(immut), _ptr(far),
                                        _ptr(got), _ptr(base),
                                        int(dec.k4_skip), w, h, 2, 1,
                                        None) == 0
        assert same_bits(got, want)
        return
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    cvec = torch.cat([base, ec])
    if kernel == "K1":
        runs = [dict(rsqrt=0, rollgroup=0), dict(rsqrt=1, rollgroup=1)]
    else:
        runs = [dict(trig=1, detect=1), dict(nospring=1, noint=1)]
    extras = _mode_extras(state, cfg, tau=0.05, det=1.0, t_band=0.06)
    refs = (hot[:4] + torch.randn((4, w, h), generator=g)).contiguous()
    nb = -(-h // 32) * -(-w // 8)
    for run in runs:
        flags = [run.get(k, 0) for k in ("rsqrt", "rollgroup", "trig",
                                         "detect", "nospring", "noint")]
        trig, detect = flags[2], flags[3]
        outs = []
        for entry in ("modex", "dev"):
            o = dict(hot=torch.empty_like(hot), obs=torch.empty_like(obs),
                     stats=torch.empty((nb, 4)),
                     side=torch.full((9, -(-w // 4), h), float("nan")))
            args = (_ptr(hot), _ptr(immut), _ptr(far), _ptr(obs),
                    _ptr(refs if trig else None), _ptr(o["hot"]),
                    _ptr(o["obs"]), _ptr(o["stats"] if trig else None),
                    _ptr(o["side"] if detect else None), _ptr(cvec), w, h,
                    2, 1, *flags)
            x = _ptr(extras if trig or detect else None)
            if entry == "modex":
                assert lib.sb_fused_substep2_modex(*args, None, x) == 0
            else:
                assert lib.sb_fused_substep2_dev(*args, int(dec.k1_skip),
                                                 None, x) == 0
            outs.append(o)
        for k in ("hot", "obs") + ("stats",) * trig + ("side",) * detect:
            assert same_bits(outs[1][k], outs[0][k]), f"{run} {k}"


def _k3_both_entries(lib, state, stencil, radius, dt, ecoeff, friction):
    """K3's plain version against the source through its contiguous entry
    and through its strided entry on the state's interleaved views and on
    H-major planes."""
    w, h = state.alive.shape
    views = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
             state.vel[..., 1])
    planes = [t.contiguous() for t in views] + [state.alive]
    ref = torch.stack(collide_stencil.collide_stencil_plain(
        *planes, radius=radius, dt=dt, ecoeff=ecoeff, friction=friction,
        stencil=stencil))
    two_r, inv_dt2 = collide_stencil._scalars(radius, dt)
    scalars = (two_r, inv_dt2, float(np.float32(ecoeff)),
               float(np.float32(friction)))
    got = torch.empty_like(ref)
    assert lib.sb_collide_stencil(*(_ptr(t) for t in planes), _ptr(got),
                                  *scalars, w, h, stencil, None) == 0
    assert same_bits(got, ref), "contiguous entry"
    # the interleaved views (staged as pairs), and planes laid out H-major
    # (row stride 1, element stride W)
    h_major = [t.t().contiguous().t() for t in planes[:4]]
    for layout, vs in (("interleaved views", views), ("H-major", h_major)):
        strides = np.ascontiguousarray([t.stride() for t in vs], np.int64)
        got = torch.empty_like(ref)
        assert lib.sb_collide_stencil_strided(
            *(_ptr(t) for t in vs), strides.ctypes.data, _ptr(state.alive),
            _ptr(got), *scalars, w, h, stencil, None) == 0
        assert same_bits(got, ref), f"strided entry, {layout}"
    return ref


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [1, 2, 3])
def test_k3_source_matches_plain(lib, stencil, shape):
    w, h = shape
    state, cfg, consts, _g = _state(w, h, seed=7 + w + h)
    _k3_both_entries(lib, state, stencil, cfg.particle_radius, cfg.dt,
                     consts.ecoeff, consts.friction)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [1, 2, 3])
def test_k3_source_nonfinite_and_garbage(lib, stencil, shape):
    """Both entries on a state with non-finite velocities in some tiles and
    garbage in dead particles: NaN where the plain version has NaN."""
    w, h = shape
    state, cfg, consts, g = _state(w, h, seed=11 + w + h)
    ref = _k3_both_entries(lib, kernel_cases.hostile(state, g), stencil,
                           cfg.particle_radius, cfg.dt, consts.ecoeff,
                           consts.friction)
    nan = torch.isnan(ref).any(0)
    assert 0 < int(nan.sum()) < nan.numel() // 2


def test_k3_source_constants_that_overflow_clip(lib):
    """With 1/dt² = 1e38, clip overflows for pairs a few units apart and
    their terms are NaN: the host's check of the constants must keep
    every pair on the full path."""
    w, h = SHAPES[0]
    state, cfg, consts, _g = _state(w, h, seed=5)
    ref = _k3_both_entries(lib, state, 2, cfg.particle_radius, 1e-19,
                           consts.ecoeff, consts.friction)
    assert bool(torch.isnan(ref).any())


def _band_state(w, h, seed, odd_dev=False):
    """K2's five input planes on a stirred lattice (``_state``) with 6% of
    the particles thrown up to eight spacings off their sites (along W
    only where H is one lane), so that band partners at every dx come
    within reach; dead particles in rows 8-15 only (the other warps are
    all alive and stop early), half of them at the position of the
    particle three rows before them (alive, they would hit), half at NaN
    or +inf; two alive particles at +inf and NaN; where ``odd_dev``,
    reaches that the box test must bound: deviations of +inf, NaN and
    below −base in a few places."""
    state, cfg, _consts, g = _state(w, h, seed)
    spacing = 20.0
    pos = state.pos.clone()
    thrown = torch.rand((w, h), generator=g) < 0.06
    reach = torch.tensor([16.0, 16.0 if h > 1 else 1.0]) * spacing
    pos = pos + thrown[..., None] * (torch.rand(pos.shape, generator=g)
                                     - 0.5) * reach
    dead = torch.zeros((w, h), dtype=torch.bool)
    dead[8:16] = torch.rand((min(w, 16) - 8, h), generator=g) < 0.3
    garbage = torch.where(torch.rand((w, h, 1), generator=g) < 0.5,
                          torch.roll(pos, 3, dims=0),
                          torch.tensor([float("nan"), float("inf")]))
    pos = torch.where(dead[..., None], garbage, pos)
    pos[w // 2, h // 2, 0] = float("inf")
    pos[w // 3, 0, 1] = float("nan")
    alive = ~dead
    dev = torch.where(alive, torch.rand((w, h), generator=g) * 0.25 * spacing,
                      0.0)
    base = float(np.float32(2.0 * cfg.particle_radius + 0.75 * spacing))
    if odd_dev:
        dev[w // 4, 0] = float("inf")
        dev[w - 1, h - 1] = float("nan")
        dev[2 * w // 3, h // 3] = -6.0 * spacing
    return (pos[..., 0].contiguous(), pos[..., 1].contiguous(), dev,
            base + dev, alive)


def _k2_source(lib, planes, offsets):
    w, h = planes[0].shape
    offs = np.ascontiguousarray(offsets, np.int32).reshape(-1, 2)
    got = torch.empty_like(planes[4])
    assert lib.sb_band_flags(*(_ptr(t) for t in planes), _ptr(got),
                             offs.ctypes.data, len(offs), w, h, None) == 0
    return got


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [1, 2])
def test_k2_source_matches_plain(lib, stencil, shape):
    """The band of chunk 4 at stencils 1 and 2 (112 and 100 offsets)."""
    w, h = shape
    planes = _band_state(w, h, seed=13 + w + h + stencil)
    offsets = FarFieldSpec().band_half_offsets(stencil)
    ref = band_detect.band_flags_plain(*planes, offsets)
    assert torch.equal(_k2_source(lib, planes, offsets), ref)
    assert 0 < int(ref.sum()) < int(planes[4].sum())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("chunk", [8, 16])
def test_k2_source_wide_bands(lib, chunk, shape):
    """The bands of chunks 8 and 16 at stencil 2 (radii 15 and 31: the
    kernel whose box and shared memory are set at launch), and one with
    odd reaches."""
    w, h = shape
    for odd in (False, True):
        planes = _band_state(w, h, seed=23 + w + chunk, odd_dev=odd)
        offsets = FarFieldSpec(chunk=chunk).band_half_offsets(2)
        assert band_detect.band_radius(offsets) == 2 * chunk - 1
        ref = band_detect.band_flags_plain(*planes, offsets)
        assert torch.equal(_k2_source(lib, planes, offsets), ref), odd
        assert 0 < int(ref.sum()) < int(planes[4].sum())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k2_source_odd_reaches_and_offsets(lib, shape):
    """Infinite, NaN and negative deviations (the box test's bound), and
    offset sets other than a band: the self offset (0, 0), a scattered
    few, a repeated one, none."""
    w, h = shape
    planes = _band_state(w, h, seed=17 + w + h, odd_dev=True)
    for offsets in (FarFieldSpec().band_half_offsets(2),
                    [(0, 0), (7, -7), (3, 5), (3, 5), (1, 0)], []):
        ref = band_detect.band_flags_plain(*planes, offsets)
        assert torch.equal(_k2_source(lib, planes, offsets), ref), offsets


def _k8a_source(lib, planes, fl, *, h, s, radius, dt, ecoeff, friction,
                on_device):
    """K8a's source on ``fl`` (its scratch starts as NaN: unwritten rows
    show); ``on_device``: ecoeff and friction read through pointers."""
    k = fl.capacity
    pw, ph = planes[0].shape
    scratch = torch.full((2 * k, far_apply.ROW), float("nan"))
    sc = torch.tensor([ecoeff, friction], dtype=torch.float32)
    ptrs = ((sc[0:1].data_ptr(), sc[1:2].data_ptr()) if on_device
            else (None, None))
    two_r = float(np.float32(2.0) * np.float32(radius))
    dt2 = float(np.float32(dt) * np.float32(dt))
    sx, sy = planes[0].stride()
    assert lib.sb_far_pairs(
        *(_ptr(t) for t in planes), sx, sy, pw, ph, _ptr(fl.ca),
        _ptr(fl.cb), _ptr(fl.valid), k, h // 4, -(-h // 32) * 32, s, two_r,
        dt2, 0.0 if on_device else ecoeff, 0.0 if on_device else friction,
        *ptrs, _ptr(scratch), None) == 0
    return scratch


@pytest.mark.parametrize("layout", ["planes", "interleaved"])
@pytest.mark.parametrize("stencil", [1, 2, 3])
def test_k8a_source_matches_plain(lib, stencil, layout):
    """K8a's rows of the valid slots bit for bit against its plain
    version on the collapsed pile (self pairs, neighbouring chunks,
    coincident particles, dead ones), the planes short of the padded grid
    (cells past them read dead); the empty slots' rows left unwritten;
    the scalars by value and through device memory alike."""
    w, h = 48, 32
    planes, ca, cb, valid = kernel_cases.far_collapse(w, h, 64, 50,
                                                      seed=stencil)
    planes = tuple(p[: w - 4, : h - 5] for p in planes)
    if layout == "interleaved":
        inter = torch.stack(planes, dim=-1)
        planes = tuple(inter[..., i] for i in range(5))
    else:
        planes = tuple(p.contiguous() for p in planes)
    fl = kernel_cases.far_list(ca, cb, valid)
    kw = dict(s=stencil, radius=4.5, dt=1.0 / 64, ecoeff=0.75, friction=0.3)
    ref = far_apply.far_pairs_plain(planes, fl, ff=FarFieldSpec(), h=h,
                                    world_h=-(-h // 32) * 32, **kw)
    rows = torch.cat([valid, valid])
    assert float(ref[rows].abs().max()) > 0
    for on_device in (False, True):
        got = _k8a_source(lib, planes, fl, h=h, on_device=on_device, **kw)
        assert same_bits(got[rows], ref[rows]), on_device
        assert torch.isnan(got[~rows]).all()


def test_k8b_source_matches_plain(lib):
    """K8b's planes bit for bit against its plain version (the ordered
    sums), on rows of ten orders of magnitude, a list with one chunk
    named many times, empty slots and an active prefix, cropped to two
    rungs; the output a corner of the grid; every cell written."""
    w, h = 48, 32
    _planes, ca, cb, valid = kernel_cases.far_collapse(w, h, 128, 100,
                                                       seed=5)
    order = far_apply.dest_order(ca, cb, valid, (w // 4) * (h // 4))
    g = np.random.default_rng(5)
    for k, n_act in ((64, 64), (128, 100), (128, 31), (64, 0)):
        vk = (valid & (torch.arange(128) < n_act))[:k]
        rows = torch.from_numpy((g.normal(0, 1, (2 * k, 80)) * np.exp(
            g.normal(0, 5, (2 * k, 80)))).astype(np.float32))
        ref = far_apply.far_accumulate_plain(rows, order, vk,
                                             torch.empty((5, w - 4, h - 3)),
                                             h=h)
        got = torch.full((5, w - 4, h - 3), float("nan"))
        assert lib.sb_far_accumulate(
            _ptr(rows), _ptr(order.sides), _ptr(order.offsets), _ptr(vk), k,
            order.capacity, h // 4, _ptr(got), w - 4, h - 3, None) == 0
        assert same_bits(got, ref), (k, n_act)
        assert (float(ref.abs().max()) > 0) == (n_act > 0)
