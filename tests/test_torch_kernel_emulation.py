"""The CUDA sources of K1, K3 and K4 run on the CPU, in emulation, against
their plain versions.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Here their sources are compiled with the host C++
compiler against a small emulation of the CUDA they use: one
``std::thread`` per CUDA thread, ``std::barrier`` for ``__syncthreads``,
the ``cp.async`` copies as plain copies (zero fill included), the launch
as a loop over blocks.  Float arithmetic is IEEE single precision without
contraction (``-ffp-contract=off``, as the kernels' ``-fmad=false``
build) and x86's square root and divide are correctly rounded, so every
output plane must equal the plain version bit for bit.  This holds the
kernels' indexing — tiles, halos, ragged edges, the spring reactions
shared through shared memory, every barrier reached by every thread — at
shapes and stencils the CPU can afford.  Skipped where there is no
``g++``."""

import ctypes
import dataclasses
import itertools
import re
import shutil
import subprocess

import pytest
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.models import make_lattice
from softbody_tpu_torch.ops.cuda import collide_stencil, fused_substep
from softbody_tpu_torch.ops.cuda import fused_substep2
from softbody_tpu_torch.ops.cuda._lib import CSRC

EMULATED = ("fused_substep2.cu", "fused_substep.cu", "collide_stencil.cu")

RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_barrier;
inline thread_local float* emu_shared;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
typedef int cudaError_t;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
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
// blocks one after another; a block's threads run together, its shared
// memory starts as NaN so that a read before any write shows
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  const unsigned n = block.x * block.y;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<float> shared(smem / 4 + 1, std::nanf(""));
      std::barrier<> bar(n);
      std::vector<std::thread> threads;
      for (unsigned i = 0; i < n; ++i)
        threads.emplace_back([&, i] {
          threadIdx = dim3(i % block.x, i / block.x);
          blockIdx = dim3(bx, by);
          emu_barrier = &bar;
          emu_shared = shared.data();
          f();
        });
      for (auto& t : threads) t.join();
    }
}
"""


def _emulated_source(text: str) -> str:
    """A kernel source rewritten for the emulation: dynamic shared memory,
    the cp.async copies (plain copies, src-size 0 zero-fills) and the
    launch syntax."""
    text = text.replace("extern __shared__ float smem[];",
                        "float* smem = emu_shared;")
    text = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global.*?'
                  r': "memory"\);', "*dst = in ? *src : 0.0f;", text,
                  flags=re.S)
    text = re.sub(r'asm volatile\("cp\.async\.(commit|wait)_group[^;]*;'
                  r'\\n" ::: "memory"\);', ";", text)
    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                  lambda m: (f"emu_launch({m.group(2)}, [&]() "
                             f"{{ {m.group(1)}({m.group(3)}); }});"),
                  text, flags=re.S)
    if "asm" in text or "<<<" in text:
        raise AssertionError("a construct the emulation does not cover")
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the CPU")
    d = tmp_path_factory.mktemp("emulated_kernels")
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    for name in EMULATED + ("lattice_device.cuh",):
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
    lib.sb_fused_substep.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.sb_collide_stencil.argtypes = [p] * 6 + [f] * 4 + [i] * 3 + [p]
    for fn in (lib.sb_fused_substep2, lib.sb_fused_substep,
               lib.sb_collide_stencil):
        fn.restype = i
    return lib


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


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("stencil", [1, 2, 3])
def test_k3_source_matches_plain(lib, stencil, shape):
    w, h = shape
    state, cfg, consts, _g = _state(w, h, seed=7 + w + h)
    planes = [t.contiguous() for t in (state.pos[..., 0], state.pos[..., 1],
                                       state.vel[..., 0], state.vel[..., 1],
                                       state.alive)]
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=stencil)
    ref = torch.stack(collide_stencil.collide_stencil_plain(*planes, **kw))
    got = torch.empty_like(ref)
    two_r, inv_dt2 = collide_stencil._scalars(cfg.particle_radius, cfg.dt)
    assert lib.sb_collide_stencil(
        *(_ptr(t) for t in planes), _ptr(got), two_r, inv_dt2,
        float(consts.ecoeff), float(consts.friction), w, h, stencil,
        None) == 0
    assert torch.equal(got, ref)
