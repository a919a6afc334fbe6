#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Builds the hand-written kernels from ``softbody_tpu_torch/csrc``, holds
each against its plain torch version on the card, drives the port's
paths at full size, checks the results, and times the kernels against
their plain versions.  The paths, each with the kernel launch counts set
to 0 just before it and read just after:

- the bench path: the 1M-particle tearing cloth with far-field
  self-collision through ``FusedLatticeBackend`` (kernels K1, K2);
- path A: the dense ``LatticeBackend`` with ``use_pallas`` on the 1M
  tearing cloth with default arguments and far field armed with
  ``FarFieldSpec()`` (``play --path lattice --farfield``; K3, K2);
- path B: the per-edge fused frame ``fused_frame`` on the same scene,
  bench.py's ``BENCH_PATH=fused_v1`` (K4);
- the probe of ``scripts/probe_recmirror.py``: the record casts (K5, K6)
  and the mirror table (K7) at the probe's and the bench path's sizes
  (K7 also runs on the bench path, in each far apply with pairs);
- the general gather engine (``ops/step.frame``, no kernel of its own) at
  BASELINE configs 1, 4 and 3: the 32×32 cloth, 64 blobs and the 100k
  self-colliding cloth;
- the runtime, as a user drives it: ``LatticeEngine(fused=True)`` on the
  bench scene stepping on its worker thread while this thread polls
  render packets (K1, K2, K7), its L1 snapshot round trip, fault
  injection and re-creation; ``LatticeEngine`` on path A (K3); ``Engine``
  on the general path;
- the planified general-topology path (phase 12): BASELINE config 3, the
  100k self-colliding cloth, embedded into planes by ``PlanifiedBackend``
  and stepped far-armed with ``use_pallas`` (K3 every substep, K2 every
  rebuild, K7 in every far apply above 256 pairs); config 4 planified
  behind ``Engine``; the small fold through both far-apply routes, card
  against CPU; ``FusedLatticeBackend(far_activation=True)`` on the bench
  scene (K1, K2, K7); the directed-CSR engine at config 3;
- the CLI (phase 13), as a user first runs it, in this process:
  ``run`` of the 1M tearing cloth on the lattice path and of the 100k
  cloth planified and far-armed (K2, K7), ``render`` of the 1M cloth,
  ``play`` headless of the 1M cloth far-armed (K2) and of the default
  scene, ``snapshot create``/``info`` of the 1M scene, the editor; the
  renderer and the far apply's fixed order held card against CPU.

Every phase raises on failure.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: also build the kernels of the checkout at DIR (another
commit of this repo) and time its K1, K2, K3 and K4 beside this tree's,
in turns, on the same inputs.

Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, default
``/usr/local/cuda``); refuses to run without a device.  The last line
of standard output is one JSON object naming the device; the line
before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import math
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch import cli, viz
from softbody_tpu_torch.editor import SoftbodyEditor
from softbody_tpu_torch.engine import (
    Engine,
    EngineOptions,
    FusedLatticeBackend,
    LatticeBackend,
    LatticeEngine,
    PlanifiedBackend,
    SimBackend,
)
from softbody_tpu_torch.mapping import SceneRegistry
from softbody_tpu_torch.models import (
    add_rectangle,
    cloth_lattice,
    lattice_to_simstate,
    make_lattice,
    tearing_cloth_lattice,
)
from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
from softbody_tpu_torch.convert import (
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    planified_state_from_numpy,
    planified_state_to_numpy,
    sim_state_to_numpy,
)
from softbody_tpu_torch.models import scenes
from softbody_tpu_torch.ops import farfield4
from softbody_tpu_torch.ops import planify
from softbody_tpu_torch.ops import step as gstep
from softbody_tpu_torch.ops.collisions import broad_phase_overflow
from softbody_tpu_torch.ops.cuda import (
    _lib,
    band_detect,
    collide_stencil,
    fused_substep,
    fused_substep2,
    recmirror,
)
from softbody_tpu_torch.ops.cuda.band_detect import (
    band_flag_call,
    band_flags_plain,
)
from softbody_tpu_torch.ops.cuda.collide_stencil import (
    collide_stencil_call,
    collide_stencil_plain,
)
from softbody_tpu_torch.ops.cuda.fused_substep import (
    fused_frame,
    fused_frame_far,
    fused_substep_call,
    fused_substep_plain,
    pack_lattice,
    rebuild_far_list_packed,
)
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    PX,
    PY,
    VX,
    VY,
    fused_frame4,
    fused_substep2_call,
    fused_substep2_plain,
    pack_lattice2,
    unpack_lattice2,
)
from softbody_tpu_torch.ops.directed import (
    build_directed,
    directed_beam_pass,
    directed_frame,
)
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    crop_far_list,
    far_collision_terms,
    rebuild_far_list_planes,
)
from softbody_tpu_torch.ops.farfield4 import (
    bucket_capacity,
    bucketed_far_delta_planes,
    far_terms_from_mirror,
    mirror_table,
    unmirror_table,
)
from softbody_tpu_torch.ops.forces import accumulate_forces, beam_forces
from softbody_tpu_torch.ops.stencil import (
    LatticeSpec,
    half_offsets,
    lattice_frame,
    shifted,
    sqrt32,
)
from softbody_tpu_torch.parallel import (
    batched_frame_fn,
    device_put_batched,
    make_mesh,
    pad_state_for_mesh,
    shard_state,
    spatial_frame_fn,
    stack_states,
    unshard_state,
    unstack_states,
)
from softbody_tpu_torch.parallel.fused_spatial import (
    fused_spatial_frame_fn,
    ghost_width,
    interiors,
    pack_lattice_sharded,
    shard_stacks,
)
from softbody_tpu_torch.parallel.fused_spatial2 import (
    far_stats,
    fused_spatial2_frame_fn,
    pack_lattice2_sharded,
    shard_stacks2,
)
from softbody_tpu_torch.parallel.lattice_spatial import (
    lattice_spatial_frame_fn,
    shard_lattice,
    unshard_lattice,
)
from softbody_tpu_torch.snapshot import load_snapshot, save_snapshot

# the bench scene of bench.py:79-107 (1000 x 1000 lattice, ~3.98M springs)
N_PARTICLES = 1_000_000
SCENE_KW = dict(fall_speed=2.5, slits=7, strain_limit=0.22,
                yield_strain=0.18)
# frames 3-10, bench.py's window (first frame, one warm frame, 8 timed):
# the sheet reaches the floor and starts to tear, so far pairs appear
WARM_FRAMES = 2
TIMED_FRAMES = 8
SEED = 0

# paths A and B: frames run (both start from the default scene, which
# falls for ~5 frames before it reaches the floor)
PATH_A_FRAMES = 3
PATH_B_FRAMES = 8

# the probe's sizes (scripts/probe_recmirror.py): the casts at 64 rows and
# at the 1M bench table's (32 lane blocks x 252 record columns x 640
# floats = 40320 rows of 128); the mirror at 256 x 256 and at the 1M
# bench lattice on its apply grid (1000 x 1000 padded to 1008 x 1024)
PROBE_CAST_ROWS = (64, 40320)
PROBE_MIRRORS = ((256, 256, 256, 256), (1000, 1000, 1008, 1024))
# the bench path's far buckets (fused_frame4's default ladder)
FAR_BUCKETS = (1024, 2048, 4096)

# the general engine's configurations (BASELINE.json configs 1, 4, 3):
# (label, scene builder, frames timed, frames run before)
GENERAL_CONFIGS = (
    ("config 1 cloth(32, 32)", lambda dev: scenes.cloth(32, 32, device=dev),
     1, 1),
    ("config 4 multi_blob(64)", lambda dev: scenes.multi_blob(64, device=dev),
     8, 1),
    ("config 3 self_colliding_cloth(100000)",
     lambda dev: scenes.self_colliding_cloth(100_000, device=dev), 2, 0),
)
# config 1 on the card against the CPU: tests/test_step_vs_oracle.py's
# tolerances (the collision sums' order differs)
GENERAL_ATOL = {"pos": 2e-3, "vel": 4e-3}

# the runtime phase: frames of each of the fused engine's four windows,
# after 2 warm frames: stepping alone, polled, polled, alone (frames 2-10;
# the order cancels the frames' drift in cost, which grows as far pairs
# appear); past frame ~12 the crumpling sheet's candidate pairs outgrow
# the bench far field's 16384
RUNTIME_FRAMES = 2

# K1 and K4 against their plain versions: edge planes bit-exact,
# particle planes within the port's parity tolerances
# (tests/test_torch_substep.py); K2's flags and K3's deltas bit-exact
# (K3: NaN where the plain version has NaN)
K1_ATOL = {"pos": 1e-4, "vel": 1e-3, "acc": 1e-2, "obs": 1e-5}
# the shapes K1 and K4 are held at: the bench lattice, and shapes whose
# sides are multiples of neither tile side (16 rows x 32 lanes), one a
# single lane wide; and the stencil radii
K14_SHAPES = ((1000, 1000), (97, 61), (33, 1000), (64, 1))
K14_STENCILS = (0, 1, 2, 3)
# K3 is held at stencils 1-3, at 64x64, 1M and this ragged shape
K3_STENCILS = (1, 2, 3)
K3_RAGGED = (97, 61)

# the planified phase: scripts/bench_config3.py:46-50 settles the 100k
# cloth 4 frames on the general engine before embedding it, then runs it
# planified and far-armed (its :53-107; 1 warm + 8 timed frames here)
PLANIFIED_N = 100_000
PLANIFIED_SETTLE = 4
PLANIFIED_FRAMES = 8
# config 4 behind the engine: frames polled (after the first), then the
# fused backend on the bench scene with and without the activation
# schedule (frames 8-10, the end of phase 6's window: far pairs appear
# from about frame 7 in phases 6 and 11) and the directed engine at
# config 3 (2 frames)
PLANIFIED_ENGINE_FRAMES = 4
ACTIVATION_WARM, ACTIVATION_FRAMES = 7, 3
DIRECTED_FRAMES = 2
# one substep with K3 (full offsets) against the half-offset sum:
# tests/test_pallas.py's tolerances (the collision sums' order)
K3_VS_HALF_TOL = dict(rtol=1e-5, atol=1e-3)

# the CLI phase (13): the verbs a user runs first, at their defaults and
# full size (the 1M tearing cloth; the 100k self-colliding cloth
# planified and far-armed), each called in this process with the launch
# counts from 0; the renderer held card vs CPU on a stirred 48 x 48
# cloth; the far apply's fixed order on the stirred 40 x 40 cloth
CLI_FRAMES = 3
CLI_LATTICE_N = 1_000_000
CLI_PLANIFIED_N = 100_000
CLI_PLAY_S = (8.0, 3.0)
CLI_EDITOR_SIDE = 32

# the parallel phase (14), every shard on this card: path A in 4 slabs
# (frames 1-3), path B in 4 slabs (frames 1-8), the bench scene far-armed
# in 2 slabs (frames 1-2 warm, 3-10 timed; W = 1000 gives 500-column
# slabs, a multiple of the far field's chunk 4) with a rebuild every 8
# substeps, and one frame from the single-device frame 9 held against its
# own frame 10; each profiled over a short step of 8 substeps.  That frame
# may differ from fused_frame4's only where a particle sums far
# contributions of several pairs in another order (the sharded apply's
# list order, each slab's own swept envelope), a float32 rounding that a
# frame of contacts grows: held to 1% of the lattice spacing (~0.98) in
# position and in one substep's displacement (velocity x dt, dt = 1/64),
# and to equal edge liveness.  A control frame with the far field off
# must break these limits, or they could not tell a dropped far apply
SHARD_FRAMES_A = 3
SHARD_FRAMES_B = 8
SHARD_BENCH = (2, 8)
SHARD_REBUILD = 8
SHARD_PARITY_FRAME = 9
SHARD_PROFILE_SUBSTEPS = 8
SHARD_GENERAL_N = 100_000
SHARD_BENCH_ATOL = {"pos": 1e-2, "vel": 0.64, "edges alive differ": 0}

# the card's peaks for the bound (NVIDIA's H100 SXM data sheet): device
# memory rate, and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _far_spec(spacing: float):
    # bench.py:104-107: K=16384, 256 tile pairs, skin 0.75 spacing,
    # cadence 8
    return FarFieldSpec(max_pairs=16384, max_tile_pairs=256,
                        skin=0.75 * spacing, horizon=8)


def _scene(n: int, dev):
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=n, device=dev, **SCENE_KW)
    spacing = 980.0 / (spec.width - 1)
    return state, spec, cfg, consts, spacing


def _stirred(state, spacing: float, seed: int):
    """The scene with noisy positions and velocities, so that springs
    yield and break and particles collide in the compared substep."""
    g = torch.Generator(device=state.pos.device).manual_seed(seed)
    dev = state.pos.device

    def noise(scale):
        return torch.randn(state.pos.shape, generator=g, device=dev) * scale

    return dataclasses.replace(state, pos=state.pos + noise(0.3 * spacing),
                               vel=state.vel + noise(6.0 * spacing))


def _timed_ms(fn, iters: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, warm: int = 1) -> float:
    """Device ms per call of ``fn`` (one kernel or one library call): the
    calls are queued behind a ``torch.cuda._sleep`` long enough for the
    host to enqueue them all, so the events between the first and the
    last time the device alone and not the host's launch rate (a call's
    host side, ~10-25 µs, is longer than a 12 µs copy).  Doubles the
    sleep until it outlasts the enqueueing; ``iters`` times the launches
    of one call must stay below the device's launch queue (~1000), where
    the host would block."""
    for _ in range(warm):
        fn()
    cycles = 20_000_000
    for _ in range(6):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 2
    raise AssertionError("the host did not get ahead of the device")


# ---------------------------------------------------------------------------
# kernel checks


def _k14_state(w: int, h: int, dev, seed: int):
    """A stirred ``w × h`` lattice for holding K1 and K4 against their
    plain versions: the tearing cloth's parameters at the spacing that
    spans the world, positions and velocities noisy enough that springs
    yield and break and particles collide, 5% of the particles and 10% of
    the edges dead.  Returns ``(state, cfg, consts, generator)``."""
    spacing = 980.0 / max(max(w, h) - 1, 1)
    state = make_lattice(w, h, spacing, spring=200.0, damp=10.0,
                         yield_strain=0.18, strain_limit=0.22, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    edges = tuple(dataclasses.replace(
        e, alive=e.alive & (torch.rand((w, h), generator=g, device=dev)
                            > 0.1)) for e in state.edges)
    state = dataclasses.replace(
        _stirred(state, spacing, seed), edges=edges,
        alive=torch.rand((w, h), generator=g, device=dev) > 0.05)
    cfg = tb.StaticConfig(subticks=64, collision_mode="allpairs",
                          particle_radius=spacing * 0.35)
    consts = tb.PhysicsConstants(gravity=(0.0, -0.05 * spacing))
    return state, cfg, consts, g


def _hold(label, got, ref, planes):
    """``got`` against ``ref`` on the particle planes (pos, vel, acc) and
    the named extra planes: the max |err| of each, raising above
    K1_ATOL."""
    errs = {
        "pos": (got[0:2] - ref[0:2]).abs().max().item(),
        "vel": (got[2:4] - ref[2:4]).abs().max().item(),
        "acc": (got[4:6] - ref[4:6]).abs().max().item(),
        **planes,
    }
    for k, e in errs.items():
        if not e <= K1_ATOL[k]:
            raise AssertionError(f"{label}: {k} max |err| {e} > "
                                 f"{K1_ATOL[k]}")
    return errs


def check_k1(w: int, h: int, dev) -> float:
    """K1 against its plain version on the card at ``w × h``, at stencils
    K14_STENCILS, quantized and float forces, with and without a far
    stack, hot and observing: edge planes bit-exact, particle planes
    (and obs on alive edges) within K1_ATOL."""
    state, cfg, consts, g = _k14_state(w, h, dev, SEED + w + h)
    hot, obs, immut, ec = pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    worst = {}
    for s, quantized, with_far, observe in itertools.product(
            K14_STENCILS, (True, False), (False, True), (False, True)):
        kw = dict(stencil=s, quantized=quantized,
                  far=far if with_far else None,
                  obs_in=obs if observe else None)
        label = (f"K1 {w}x{h} s={s} quantized={quantized} far={with_far} "
                 f"observe={observe}")
        ref = fused_substep2_plain(hot, immut, cvec, **kw)
        got = fused_substep2_call(hot, immut, cvec, **kw)
        torch.cuda.synchronize()
        ref_hot, ref_obs = ref if observe else (ref, None)
        got_hot, got_obs = got if observe else (got, None)
        if not torch.equal(got_hot[6:], ref_hot[6:]):
            n_bad = int((got_hot[6:] != ref_hot[6:]).sum())
            raise AssertionError(f"{label}: {n_bad} edge-plane values "
                                 "differ from the plain version")
        extra = {}
        if observe:
            live = torch.repeat_interleave(ref_hot[8::3] > 0, 2, dim=0)
            extra["obs"] = ((got_obs - ref_obs).abs() * live).max().item()
        for k, e in _hold(label, got_hot, ref_hot, extra).items():
            worst[k] = max(worst.get(k, 0.0), e)
    broke = int(((hot[8::3] > 0) & (ref_hot[8::3] == 0)).sum())
    log(f"K1 {w}x{h}: {len(K14_STENCILS) * 8} cases (stencils "
        f"{K14_STENCILS}, quantized/float, far on/off, observing on/off), "
        f"edge planes bit-exact, max |err| {worst} ({broke} edges broke in "
        "the last case)")
    return max(worst.values())


def _band_inputs(px, py, vx, vy, alive, cfg, ff, stencil):
    """K2's inputs as the rebuild forms them (ops/farfield.py)."""
    n = alive.sum().clamp(min=1).to(torch.float32)
    vbx = torch.where(alive, vx, 0.0).sum() / n
    vby = torch.where(alive, vy, 0.0).sum() / n
    t_band = float(np.float32(ff.horizon * cfg.dt))
    dev = torch.where(alive, sqrt32((vx - vbx) * (vx - vbx)
                                    + (vy - vby) * (vy - vby)) * t_band, 0.0)
    base = float(np.float32(2.0 * cfg.particle_radius + ff.skin))
    return (px.contiguous(), py.contiguous(), dev, base + dev,
            alive.contiguous(), ff.band_half_offsets(stencil))


def _differs(got, ref):
    """Where ``got`` differs from ``ref`` bit for bit, NaN against NaN
    counted equal (the payloads aside)."""
    both_nan = torch.isnan(got) & torch.isnan(ref)
    return (got.view(torch.int32) != ref.view(torch.int32)) & ~both_nan


def check_k2(label, state, spec, cfg, spacing) -> float:
    """K2 against its plain version on the card: flags bit-exact."""
    st = _stirred(state, spacing, SEED)
    *planes, offsets = _band_inputs(
        st.pos[..., 0], st.pos[..., 1], st.vel[..., 0], st.vel[..., 1],
        st.alive, cfg, _far_spec(spacing), spec.collision_stencil)
    _hold_k2(label, planes, offsets)
    return 0.0


def _hold_k2(label, planes, offsets) -> int:
    """K2 on ``planes`` against its plain version; raises unless the flags
    are bit-exact.  Returns the particles flagged."""
    ref = band_flags_plain(*planes, offsets)
    got = band_flag_call(*planes, offsets=offsets)
    torch.cuda.synchronize()
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"K2 {label}: {n_bad} flags differ from the "
                             "plain version")
    log(f"K2 {label}: flags bit-exact ({int(ref.sum())} of "
        f"{ref.numel()} particles flagged, {len(offsets)} offsets)")
    return int(ref.sum())


def _k3_hostile(state, g):
    """``state`` with what K3's skip of pairs apart must not hide:
    infinite and NaN velocities at three particles (their tiles take the
    full path), 0.5% of the particles dead holding garbage positions
    (NaN, ±inf, 1e30, −0.0 or a neighbour's position; NaN spreads from
    them to the deltas of their stencil) and an alive particle far out,
    whose squared distances overflow."""
    w, h = state.alive.shape
    dev = state.pos.device
    pos, vel = state.pos.clone(), state.vel.clone()
    vel[1, min(h - 1, 1), 0] = float("inf")
    vel[w // 2, h // 2, 1] = float("nan")
    vel[min(w - 1, w // 2 + 1), h // 2, 0] = float("-inf")
    dead = torch.rand((w, h), generator=g, device=dev) < 0.005
    garbage = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e30,
                            -0.0], device=dev)
    pick = torch.randint(0, len(garbage) + 1, (w, h, 2), generator=g,
                         device=dev)
    junk = torch.where(pick < len(garbage),
                       garbage[pick.clamp(max=len(garbage) - 1)],
                       torch.roll(pos, 1, dims=1))
    pos = torch.where(dead[..., None], junk, pos)
    alive = state.alive & ~dead
    far = (w // 2, min(h - 1, 3))
    pos[far] = torch.tensor([1e20, -1e20], device=dev)
    alive[far] = True
    return dataclasses.replace(state, pos=pos, vel=vel, alive=alive)


def check_k3(label, st, cfg, consts, g) -> float:
    """K3 against its plain version on the card at stencils K3_STENCILS,
    through its strided entry on the state's interleaved views (the
    wrapper, as path A calls it) and through its contiguous entry, on the
    stirred state ``st`` and on ``_k3_hostile(st)``: deltas bit-exact,
    NaN where the plain version has NaN."""
    err, n_nan, n_full = 0.0, 0, 0
    for case, s_ in (("stirred", st), ("non-finite, garbage",
                                       _k3_hostile(st, g))):
        views = (s_.pos[..., 0], s_.pos[..., 1], s_.vel[..., 0],
                 s_.vel[..., 1])
        planes = [v.contiguous() for v in views] + [s_.alive]
        for s in K3_STENCILS:
            kw = dict(radius=cfg.particle_radius, dt=cfg.dt,
                      ecoeff=consts.ecoeff, friction=consts.friction,
                      stencil=s)
            ref = torch.stack(collide_stencil_plain(*planes, **kw))
            got = {"strided": torch.stack(collide_stencil_call(
                       *views, s_.alive, **kw)),
                   "contiguous": _raw_k3(_lib.library(), planes, **kw)}
            torch.cuda.synchronize()
            for entry, out in got.items():
                bad = _differs(out, ref)
                n_bad = int(bad.sum())
                if n_bad:
                    where = bad.nonzero()[:4].tolist()
                    raise AssertionError(
                        f"K3 {label} {case} s={s} {entry} entry: {n_bad} "
                        "delta values differ from the plain version, e.g. "
                        + "; ".join(f"plane {k} at ({x}, {y}): "
                                    f"{out[k, x, y].item()!r} vs "
                                    f"{ref[k, x, y].item()!r}"
                                    for k, x, y in where))
                fin = torch.isfinite(ref)
                err = max(err, (out[fin] - ref[fin]).abs().max().item())
            n_nan = max(n_nan, int(torch.isnan(ref).any(0).sum()))
            if s == 2 and case == "stirred":
                n_full = _k3_pairs_near(*planes[:2], s, cfg.particle_radius)
    log(f"K3 {label}: deltas bit-exact at stencils {K3_STENCILS}, strided "
        f"and contiguous entries, stirred and with non-finite velocities "
        f"and garbage (up to {n_nan} particles with NaN deltas); s=2 "
        f"stirred: {n_full} of "
        f"{st.alive.numel() * len(collide_stencil.full_offsets(2))} pair "
        "evaluations "
        "within (2r)^2 * 1.00001")
    return err


def _k3_pairs_near(px, py, s: int, radius: float) -> int:
    """K3's pair evaluations (each particle, each of its full offsets) with
    d2 at most (2r)^2 * 1.00001 or not finite: those that take the full
    path when the block's velocities are finite."""
    two_r, _ = collide_stencil._scalars(radius, 1.0)
    thr = float(np.float32(two_r) * np.float32(two_r)
                * np.float32(1.00001))
    n = 0
    for dx, dy in collide_stencil.full_offsets(s):
        ddx = shifted(px, dx, dy) - px
        ddy = shifted(py, dx, dy) - py
        d2 = ddx * ddx + ddy * ddy
        n += int((~((d2 > thr) & (d2 <= 3.4028234663852886e38))).sum())
    return n


def check_k4(w: int, h: int, dev) -> float:
    """K4 against its plain version on the card at ``w × h`` with
    per-edge varied parameters (each edge's spring, damp, yield, limit
    and length times a factor in [0.5, 1.5)), at stencils K14_STENCILS,
    quantized and float forces, with and without a far stack: edge planes
    (target, last, strain, stress, alive) bit-exact, particle planes
    within K1_ATOL."""
    state, cfg, consts, g = _k14_state(w, h, dev, SEED + 3 + w + h)
    mut, immut = pack_lattice(state)
    immut[2:] *= 0.5 + torch.rand(immut[2:].shape, generator=g, device=dev)
    cvec = tb.consts_vector(consts, tb.UserInput(), cfg, h)
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    worst = {}
    for s, quantized, with_far in itertools.product(
            K14_STENCILS, (True, False), (False, True)):
        kw = dict(stencil=s, quantized=quantized,
                  far=far if with_far else None)
        label = f"K4 {w}x{h} s={s} quantized={quantized} far={with_far}"
        ref = fused_substep_plain(mut, immut, cvec, **kw)
        got = fused_substep_call(mut, immut, cvec, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[6:], ref[6:]):
            n_bad = int((got[6:] != ref[6:]).sum())
            raise AssertionError(f"{label}: {n_bad} edge-plane values "
                                 "differ from the plain version")
        for k, e in _hold(label, got, ref, {}).items():
            worst[k] = max(worst.get(k, 0.0), e)
    eal = slice(10, 26, 5)
    broke = int(((mut[eal] > 0) & (ref[eal] == 0)).sum())
    log(f"K4 {w}x{h}: {len(K14_STENCILS) * 4} cases (stencils "
        f"{K14_STENCILS}, quantized/float, far on/off), edge planes "
        f"bit-exact, max |err| {worst} ({broke} edges broke in the last "
        "case)")
    return max(worst.values())


def _probe_planes(g, w, h, dev):
    """Five random ``[w, h]`` planes (px py vx vy, alive as 0/1)."""
    planes = [torch.randn((w, h), generator=g, device=dev) for _ in range(4)]
    planes.append((torch.rand((w, h), generator=g, device=dev) > 0.1)
                  .to(torch.float32))
    return planes


def _record_relayout(planes, w_out, h_out):
    """The one PyTorch call that relays a padded ``[5, w_out, h_out]``
    stack into the record table (K7's library yardstick): a permute
    copy."""
    padded = torch.zeros((5, w_out, h_out), device=planes[0].device)
    padded[:, :planes[0].shape[0], :planes[0].shape[1]] = torch.stack(planes)
    view = padded.reshape(5, w_out // 4, 4, h_out // 32, 32).permute(
        3, 1, 0, 2, 4)
    return lambda: view.contiguous()


def run_probe(dev) -> dict:
    """The probe of scripts/probe_recmirror.py through the port's kernels,
    with the launch counts from 0: stage 1, the casts (K5) and their
    inverse (K6) at each of PROBE_CAST_ROWS; stage 2, the mirror table
    (K7) at each of PROBE_MIRRORS.  Then each result against its plain
    version (bit-exact: the kernels only move data), and each kernel
    timed at the 1M size beside its plain version and its library call
    (``clone`` for the casts, the permute copy for the mirror)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    recmirror.K5_LAUNCHES = recmirror.K6_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    casts = []
    for rows in PROBE_CAST_ROWS:
        x = torch.randn((rows, 128), generator=g, device=dev)
        y = recmirror.cast_rows_call(x)
        casts.append((x, y, recmirror.uncast_rows_call(y)))
    mirrors = []
    for w, h, w_out, h_out in PROBE_MIRRORS:
        planes = _probe_planes(g, w, h, dev)
        mirrors.append((planes, w_out, h_out, recmirror.mirror_records_call(
            planes, w_out=w_out, h_out=h_out)))
    torch.cuda.synchronize()
    launches = {"K5": recmirror.K5_LAUNCHES, "K6": recmirror.K6_LAUNCHES,
                "K7": recmirror.K7_LAUNCHES}
    want = {"K5": len(PROBE_CAST_ROWS), "K6": len(PROBE_CAST_ROWS),
            "K7": len(PROBE_MIRRORS)}
    if launches != want:
        raise AssertionError(f"probe: launches {launches}, want {want}")

    errs = {"K5": 0.0, "K6": 0.0, "K7": 0.0}

    def hold(k, label, got, ref):
        n_bad = int((got != ref).sum())
        if n_bad or got.shape != ref.shape:
            raise AssertionError(f"{k} {label}: {n_bad} values differ from "
                                 "the plain version")
        errs[k] = max(errs[k], (got - ref).abs().max().item())

    for x, y, back in casts:
        hold("K5", f"rows {x.shape[0]}", y, recmirror.cast_rows_plain(x))
        hold("K6", f"rows {x.shape[0]}", back, recmirror.uncast_rows_plain(y))
        hold("K6", f"rows {x.shape[0]} round trip", back, x)
    for planes, w_out, h_out, table in mirrors:
        hold("K7", f"{tuple(planes[0].shape)} -> [{w_out}, {h_out}]", table,
             recmirror.mirror_records_plain(planes, w_out=w_out,
                                            h_out=h_out))
    log(f"probe: K5, K6 bit-exact at rows {PROBE_CAST_ROWS}, K7 bit-exact "
        f"at {[m[:2] for m in PROBE_MIRRORS]}; launches {launches}")

    x, y, _ = casts[-1]
    planes, w_out, h_out, table = mirrors[-1]
    t = {
        "K5": _device_ms(lambda: recmirror.cast_rows_call(x), 200),
        "K5 plain": _timed_ms(lambda: recmirror.cast_rows_plain(x), 200),
        "K5 library": _device_ms(x.clone, 200),
        "K6": _device_ms(lambda: recmirror.uncast_rows_call(y), 200),
        "K6 plain": _timed_ms(lambda: recmirror.uncast_rows_plain(y), 200),
        "K6 library": _device_ms(y.clone, 200),
        "K7 probe": _device_ms(lambda: recmirror.mirror_records_call(
            planes, w_out=w_out, h_out=h_out), 200),
        "K7 probe library": _device_ms(_record_relayout(planes, w_out,
                                                         h_out), 200),
    }
    n_cast = x.numel() * 4
    bounds = {"K5": _bound(2 * n_cast, 0), "K6": _bound(2 * n_cast, 0),
              "K7 probe": _mirror_bound(planes, table)}
    log(f"probe at 1M ({x.shape[0]} rows; planes {tuple(planes[0].shape)} -> "
        f"table {tuple(table.shape)}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                                  for k, v in bounds.items()))
    return dict(launches=launches, errs=errs, t=t, bounds=bounds)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work, the larger
# of its bytes over the memory rate and its float32 operations over the
# float32 rate.  Bytes count each input read once and each output written
# once; operations are counted per particle from the kernels' sources
# (a square root or a division counts as one).


def _bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mirror_bound(planes, table):
    """K7: reads five planes, writes the table; no arithmetic."""
    return _bound(5 * planes[0].numel() * 4 + table.numel() * 4, 0)


def _substep_ops(n: int, s: int) -> float:
    """K1/K4: the work the inputs need, each spring and each unordered
    pair once.  Per particle: 4 classes × (one spring evaluation of 16
    ops, the int32 conversions and the -own + reaction sums 8, the edge
    update 11) + per half offset one pair evaluation of 38 ops and the 10
    sums that apply it at both ends + the integration's ~60."""
    return n * (4 * (16 + 8 + 11) + len(half_offsets(s)) * 48 + 60)


def _log_bound(k: str, n_bytes: float, n_ops: float) -> None:
    """Both sides of a bound: bytes over the memory rate and operations
    over the float32 rate."""
    t, by = _bound(n_bytes, n_ops)
    log(f"{k} bound: {n_bytes / 1e6:.1f} MB -> "
        f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms, {n_ops / 1e9:.3f} "
        f"Gop -> {n_ops / PEAK_F32_PER_S * 1e3:.4f} ms: {by}-bound, "
        f"{t:.4f} ms")


# ---------------------------------------------------------------------------
# the kernels of another checkout (``--parent``), launched through their C
# entries with the same arguments as this tree's wrappers, and timed in
# turns with this tree's on the same inputs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raw_k1(lib, hot, immut, cvec, stencil, quantized, far):
    out = torch.empty_like(hot)
    _lib.check(lib.sb_fused_substep2(
        hot.data_ptr(), immut.data_ptr(),
        None if far is None else far.data_ptr(), None, out.data_ptr(), None,
        cvec.data_ptr(), hot.shape[1], hot.shape[2], stencil,
        int(quantized), _stream()), "K1")
    return out


def _raw_k2(lib, planes, offsets):
    px = planes[0]
    out = torch.empty(tuple(px.shape), dtype=torch.bool, device=px.device)
    offs = np.ascontiguousarray(offsets, np.int32)
    _lib.check(lib.sb_band_flags(
        *(t.data_ptr() for t in planes), out.data_ptr(), offs.ctypes.data,
        len(offs), px.shape[0], px.shape[1], _stream()), "K2")
    return out


def _raw_k3(lib, planes, radius, dt, ecoeff, friction, stencil):
    px, py, vx, vy, alive = planes
    out = torch.empty((5,) + tuple(px.shape), device=px.device)
    two_r, inv_dt2 = collide_stencil._scalars(radius, dt)
    _lib.check(lib.sb_collide_stencil(
        px.data_ptr(), py.data_ptr(), vx.data_ptr(), vy.data_ptr(),
        alive.data_ptr(), out.data_ptr(), two_r, inv_dt2,
        float(np.float32(ecoeff)), float(np.float32(friction)),
        px.shape[0], px.shape[1], stencil, _stream()), "K3")
    return out


def _raw_k4(lib, mut, immut, cvec, stencil, quantized):
    out = torch.empty_like(mut)
    _lib.check(lib.sb_fused_substep(
        mut.data_ptr(), immut.data_ptr(), None, out.data_ptr(),
        cvec.data_ptr(), mut.shape[1], mut.shape[2], stencil,
        int(quantized), _stream()), "K4")
    return out


def _turns(parent, this, iters: int) -> dict:
    """Device ms per call of the parent's and this tree's kernel on the
    same inputs, in turns: parent, this, this, parent."""
    ms = {"parent": [], "this": []}
    for side, fn in (("parent", parent), ("this", this), ("this", this),
                     ("parent", parent)):
        ms[side].append(_device_ms(fn, iters))
    return ms


def _k3_ops(n: int, s: int) -> float:
    """K3: the work the inputs need, as ``_substep_ops`` counts K1's
    collisions: each unordered pair once (per half offset a pair
    evaluation of 38 ops and the 10 sums that apply it at both ends)."""
    return n * len(half_offsets(s)) * 48


def _band_pairs_evaluated(px, py, dev, bdev, alive, offsets) -> int:
    """The pairs K2 evaluates on these inputs: for each alive particle,
    its in-range alive partners in offset order up to the first hit (the
    kernel stops there)."""
    done = ~alive
    n = 0
    for dx, dy in offsets:
        ev = ~done & shifted(alive, dx, dy, False)
        n += int(ev.sum())
        ddx = shifted(px, dx, dy) - px
        ddy = shifted(py, dx, dy) - py
        reach = bdev + shifted(dev, dx, dy)
        done = done | (ev & (ddx * ddx + ddy * ddy < reach * reach))
    return n


# ---------------------------------------------------------------------------
# end to end


def _hairpin(dev):
    """A strip folded back on itself (tests/test_farfield.py::hairpin):
    index-distant layers in contact, the far field's job."""
    w, h, spacing, gap = 96, 4, 10.0, 6.0
    ls = make_lattice(w, h, spacing, spring=0.0, damp=0.0,
                      yield_strain=10.0, strain_limit=100.0, device=dev)
    half = w // 2
    pos = np.zeros((w, h, 2), np.float32)
    vel = np.zeros((w, h, 2), np.float32)
    for i in range(w):
        xi = i if i < half else w - 1 - i
        pos[i, :, 0] = 100.0 + xi * spacing + (0.0 if i < half else 5.0)
        pos[i, :, 1] = (300.0 if i < half else 300.0 + gap) + np.arange(h) * 30
        vel[i, :, 1] = 1.5 if i < half else -1.5
    return dataclasses.replace(ls, pos=torch.from_numpy(pos).to(dev),
                               vel=torch.from_numpy(vel).to(dev))


def _small_fold(dev) -> dict:
    """2 frames of the fold through ``FusedLatticeBackend`` (once through
    each far-apply route) and through
    ``LatticeBackend`` with ``use_pallas``, and one ``fused_frame_far``
    frame from a rebuilt list, on ``dev``: far stats and particle planes
    [2, 2, 96, 4] (pos, vel) of each, on the host."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    spec = LatticeSpec(96, 4)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    out = {}
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    # the far apply's two routes: a ladder of buckets <= 256 (narrow) and
    # the default ladder on a 512-pair list (the mirror table, K7)
    for route, max_pairs, buckets in (("narrow", 64, (16,)),
                                      ("mirror", 512, None)):
        fused = FusedLatticeBackend(spec, cfg, device=dev,
                                    far_buckets=buckets,
                                    farfield=dataclasses.replace(
                                        ff, max_pairs=max_pairs,
                                        max_tile_pairs=32))
        hot = fused.pack_state(_hairpin(dev))
        before = dict(farfield4.APPLY_ROUTES)
        for _ in range(2):
            hot = fused.step(hot, consts, uin)
        ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
        if ran[route] != 2 * cfg.subticks or sum(ran.values()) != ran[route]:
            raise AssertionError(f"small fold, fused backend: far applies "
                                 f"by route {ran}, want all {route}")
        out[f"fused backend, {route} route"] = (fused.far_stats(), hot[0][0:4])
    cfg = dataclasses.replace(cfg, use_pallas=True)
    dense = LatticeBackend(spec, cfg, farfield=ff, device=dev)
    st = _hairpin(dev)
    for _ in range(2):
        st = dense.step(st, consts, uin)
    out["path A"] = (dense.far_stats(),
                     torch.stack([st.pos, st.vel]).permute(0, 3, 1, 2))
    mut, immut = pack_lattice(_hairpin(dev))
    fl = rebuild_far_list_packed(mut, immut, s=2, ff=ff, radius=4.0)
    mut = fused_frame_far(mut, immut, fl, consts, uin, spec, cfg, ff)
    out["path B"] = ({"far_pairs": fl.counts()[0],
                      "far_overflow": fl.counts()[1]}, mut[0:4])
    return {k: (stats, planes.reshape(2, 2, 96, 4).cpu())
            for k, (stats, planes) in out.items()}


def check_small_fold() -> None:
    """The small fold on the card against the CPU (the plain versions):
    far stats equal and non-empty, positions and velocities within
    tests/test_torch_frame.py's tolerances (the far apply's scatter
    order differs on the card)."""
    cpu, gpu = _small_fold("cpu"), _small_fold("cuda")
    for k, (s_g, pv_g) in gpu.items():
        s_c, pv_c = cpu[k]
        if s_c != s_g or s_g["far_pairs"] == 0 or s_g["far_overflow"]:
            raise AssertionError(f"small fold, {k}: far stats cpu {s_c} vs "
                                 f"cuda {s_g}")
        dpos = (pv_g[0] - pv_c[0]).abs().max().item()
        dvel = (pv_g[1] - pv_c[1]).abs().max().item()
        if not (dpos <= 5e-3 and dvel <= 5e-2):
            raise AssertionError(f"small fold, {k}: cuda vs cpu |dpos| "
                                 f"{dpos} |dvel| {dvel}")
        log(f"small fold 96x4, {k}: cuda == cpu plain (far stats {s_g}; "
            f"max |dpos| {dpos:.3g}, |dvel| {dvel:.3g})")


def _frames(step, n_frames: int):
    """Run ``step`` n_frames times; per-frame ms (CUDA events)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_frames + 1)]
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(n_frames):
        step()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(n_frames)]


def profile_frame(label: str, step, frame_ms: float,
                  substeps: int) -> None:
    """One frame under ``torch.profiler``: device busy time (the sum of
    the kernels' durations; one stream, so they do not overlap), the
    device's idle share against ``frame_ms`` (the frame's time with the
    profiler off: the profiler itself slows the host many times over),
    the kernel launch count and the kernels that take most of the device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"{label} profile, one frame: device busy {busy_ms:.1f} ms of a "
        f"{frame_ms:.1f} ms frame (idle share {1.0 - busy_ms / frame_ms:.2f}"
        f"; host {wall_ms:.1f} ms with the profiler on), {len(kernels)} "
        f"kernel launches ({len(kernels) / substeps:.1f} per substep); top: "
        + "; ".join(f"{name[:90]} {ms:.1f} ms" for name, ms in top))


def run_path_a(dev) -> dict:
    """Path A at full width: ``play --path lattice --farfield`` on the 1M
    tearing cloth (default arguments, ``FarFieldSpec()``) with
    ``use_pallas``, through ``LatticeBackend.step``; then one more frame
    under the profiler."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    be = LatticeBackend(spec, cfg, farfield=FarFieldSpec(), device=dev)
    uin = tb.UserInput()
    n0, m0 = be.counts(state)
    box = [state]

    def step():
        box[0] = be.step(box[0], consts, uin)

    collide_stencil.K3_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    ms = _frames(step, PATH_A_FRAMES)
    k3, k2 = collide_stencil.K3_LAUNCHES, band_detect.K2_LAUNCHES
    state, stats = box[0], be.far_stats()
    substeps = PATH_A_FRAMES * cfg.subticks
    if k3 != substeps:
        raise AssertionError(f"path A: K3 launched {k3} times for "
                             f"{substeps} substeps")
    if stats["far_rebuilds"] < 1 or k2 != stats["far_rebuilds"]:
        raise AssertionError(f"path A: far stats {stats}, K2 launched {k2} "
                             "times")
    if stats["far_overflow"] != 0:
        raise AssertionError(f"path A: far_overflow {stats}")
    if not bool(torch.isfinite(torch.stack([state.pos, state.vel])).all()):
        raise AssertionError("path A: non-finite particle state")
    n1, m1 = be.counts(state)
    rate = substeps / (sum(ms) / 1000.0)
    log(f"path A: {spec.width}x{spec.height} lattice, {n1} particles, "
        f"alive beams {m0} -> {m1}; {PATH_A_FRAMES} frames = {substeps} "
        f"substeps, frame ms {[round(t, 1) for t in ms]} = {rate:.1f} "
        f"substeps/s; far stats {stats}, {be.far_chunks} chunks; K3 "
        f"launches {k3}, K2 launches {k2}; pos y range "
        f"[{state.pos[..., 1].min().item():.3f}, "
        f"{state.pos[..., 1].max().item():.3f}]")
    profile_frame("path A", step, sum(ms) / len(ms), cfg.subticks)
    return dict(state=box[0], cfg=cfg, consts=consts, spec=spec, k3=k3,
                rate=rate)


def run_path_b(dev) -> dict:
    """Path B at full width: bench.py's ``BENCH_PATH=fused_v1`` (the 1M
    tearing cloth, default arguments, r = 2, 64 substeps, no far field)
    through ``fused_frame``."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    mut, immut = pack_lattice(state)
    uin = tb.UserInput()
    eal = slice(10, 26, 5)
    m0 = int((mut[eal] > 0).sum())
    box = [mut]

    def step():
        box[0] = fused_frame(box[0], immut, consts, uin, spec, cfg)

    fused_substep.K4_LAUNCHES = 0
    ms = _frames(step, PATH_B_FRAMES)
    k4 = fused_substep.K4_LAUNCHES
    mut = box[0]
    substeps = PATH_B_FRAMES * cfg.subticks
    if k4 != substeps:
        raise AssertionError(f"path B: K4 launched {k4} times for "
                             f"{substeps} substeps")
    if not bool(torch.isfinite(mut).all()):
        raise AssertionError("path B: non-finite state")
    if tuple(mut.shape) != (26, spec.width, spec.height):
        raise AssertionError(f"path B: mut shape {tuple(mut.shape)}")
    m1 = int((mut[eal] > 0).sum())
    rate = substeps / (sum(ms) / 1000.0)
    log(f"path B: {spec.width}x{spec.height} lattice, alive beams {m0} -> "
        f"{m1}; {PATH_B_FRAMES} frames = {substeps} substeps, frame ms "
        f"{[round(t, 1) for t in ms]} = {rate:.1f} substeps/s; K4 launches "
        f"{k4}; pos y range [{mut[1].min().item():.3f}, "
        f"{mut[1].max().item():.3f}]")
    return dict(mut=mut, immut=immut, cfg=cfg, consts=consts, spec=spec,
                k4=k4, rate=rate)


def run_main_path(state, spec, cfg, consts, spacing) -> dict:
    """The bench scene through FusedLatticeBackend: a warm frame, then
    TIMED_FRAMES frames with the kernels' launch counts from zero."""
    be = FusedLatticeBackend(spec, cfg, farfield=_far_spec(spacing),
                             device="cuda")
    packed = be.pack_state(state)
    uin = tb.UserInput()
    n0, m0 = be.counts(packed)
    t0 = time.perf_counter()
    recmirror.K7_LAUNCHES = 0
    packed = be.step(packed, consts, uin)
    torch.cuda.synchronize()
    first = be.far_stats()
    log(f"main path: first frame {time.perf_counter() - t0:.2f} s, "
        f"far stats {first}, K7 launches {recmirror.K7_LAUNCHES}")
    if first["far_pairs"] == 0 and recmirror.K7_LAUNCHES:
        raise AssertionError("main path: K7 launched before far pairs "
                             "exist")
    for _ in range(WARM_FRAMES - 1):
        packed = be.step(packed, consts, uin)
    be.far_stats()  # reset the window

    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    routes0 = dict(farfield4.APPLY_ROUTES)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_FRAMES):
        packed = be.step(packed, consts, uin)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
    k7 = recmirror.K7_LAUNCHES
    routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
    stats = be.far_stats()

    substeps = TIMED_FRAMES * cfg.subticks
    hot = packed[0]
    if not bool(torch.isfinite(hot[:6]).all()):
        raise AssertionError("main path: non-finite particle state")
    if tuple(hot.shape) != (18, spec.width, spec.height):
        raise AssertionError(f"main path: hot shape {tuple(hot.shape)}")
    if stats["far_overflow"] != 0:
        raise AssertionError(f"main path: far_overflow {stats}")
    if k1 != substeps:
        raise AssertionError(f"main path: K1 launched {k1} times for "
                             f"{substeps} substeps")
    if k2 != stats["far_rebuilds"] or k2 == 0:
        raise AssertionError(f"main path: K2 launched {k2} times for "
                             f"{stats['far_rebuilds']} rebuilds")
    # the default ladder's smallest bucket is 1024 > 256: every substep
    # with pairs applies them through the mirror table, one K7 launch
    if k7 == 0 or k7 != routes["mirror"] or routes["narrow"]:
        raise AssertionError(f"main path: K7 launched {k7} times; far "
                             f"applies by route {routes}")
    n1, m1 = be.counts(packed)
    ms = start.elapsed_time(end)
    rate = substeps / (ms / 1000.0)
    pos = hot[0:2]
    log(f"main path: {spec.width}x{spec.height} lattice, {n1} particles, "
        f"alive beams {m0} -> {m1}; {TIMED_FRAMES} frames = {substeps} "
        f"substeps in {ms:.1f} ms (CUDA events; host {wall:.3f} s) = "
        f"{rate:.1f} substeps/s; far stats {stats}; K1 launches {k1}, "
        f"K2 launches {k2}, K7 launches {k7} ({k7} of {substeps} substeps "
        f"with far pairs); pos range [{pos.min().item():.2f}, "
        f"{pos.max().item():.2f}]")
    return dict(be=be, packed=packed, k1=k1, k2=k2, k7=k7, rate=rate,
                frame_ms=ms / TIMED_FRAMES, stats=stats)


def time_at_final_state(run, spec, cfg, consts, parent=None) -> dict:
    """At the main path's final state (CUDA events, ms per call): one
    rebuild; one far apply through the mirror route, its parts, and the
    windowed gather it replaced; and K1, K2 and K7 against their plain
    versions (K7 also against its library call) on the inputs the main
    path gives them, K2's flags held bit-exact there.  K1 also at stencil
    0 (streaming and springs without the collision arithmetic), and with
    ``parent`` (another checkout's kernel library) beside the parent's K1
    (stencils 2 and 0) and K2 in turns, into ``t["compare"]``."""
    be, (hot, _obs) = run["be"], run["packed"]
    ff, immut = be.ff, be._immut
    alive = immut[0] > 0
    s = spec.collision_stencil
    kw = dict(s=s, ff=ff, radius=cfg.particle_radius)

    def rebuild():
        return rebuild_far_list_planes(hot[PX], hot[PY], alive, vx=hot[VX],
                                       vy=hot[VY], dt=cfg.dt, **kw)

    fl = rebuild()
    n_pairs, _ = fl.counts()
    t = {"rebuild": _timed_ms(lambda: rebuild().counts(), 5)}

    pair_kw = dict(dt=cfg.dt, ecoeff=consts.ecoeff,
                   friction=consts.friction, **kw)

    def apply():
        return bucketed_far_delta_planes(hot, immut[0], fl, n_pairs,
                                         buckets=FAR_BUCKETS, **pair_kw)

    k = bucket_capacity(n_pairs, ff, FAR_BUCKETS)

    def apply_windowed():
        """The far apply before the mirror route: the windowed gather of
        ``farfield.far_collision_terms`` on the cropped list."""
        return torch.stack(far_collision_terms(
            hot[PX], hot[PY], hot[VX], hot[VY], alive, crop_far_list(fl, k),
            **pair_kw))

    far = apply()
    planes = (hot[PX], hot[PY], hot[VX], hot[VY], immut[0])
    _cwx, _cwy, wp, hp = _chunk_dims(*alive.shape, ff)
    table = mirror_table(planes, w=wp, h=hp)
    if n_pairs:
        err = (far - apply_windowed()).abs().max().item()
        t["apply"] = _timed_ms(apply, 20)
        t["apply windowed"] = _timed_ms(apply_windowed, 20)
        # the same with the host ahead: the device's own time per apply
        # (3 applies, ~300 launches: the device's launch queue holds ~1000)
        t["apply device"] = _device_ms(apply, 3)
        t["apply windowed device"] = _device_ms(apply_windowed, 3)
        # where the apply's device time goes (its scatter sums in list
        # order: a sort and an in-order sum per table row)
        profile_frame("far apply, mirror route", apply, t["apply"], 1)
        dtab = far_terms_from_mirror(table, crop_far_list(fl, k), w=wp,
                                     h=hp, **pair_kw)
        t["apply: pairs"] = _timed_ms(lambda: far_terms_from_mirror(
            table, crop_far_list(fl, k), w=wp, h=hp, **pair_kw), 20)
        t["apply: unmirror"] = _timed_ms(lambda: unmirror_table(
            dtab, w=wp, h=hp)[:, :alive.shape[0], :alive.shape[1]]
            .contiguous(), 20)
        log(f"far apply at the final state: bucket {k}, mirror route vs "
            f"the windowed gather max |err| {err:.3g}")
    t["K7"] = _device_ms(lambda: mirror_table(planes, w=wp, h=hp), 200)
    hm = -(-hp // 32) * 32
    t["K7 plain"] = _timed_ms(lambda: recmirror.mirror_records_plain(
        planes, w_out=wp, h_out=hm), 50)
    t["K7 library"] = _device_ms(_record_relayout(list(planes), wp, hm),
                                 200)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg,
                                       spec.height), be._edge_consts])
    k1kw = dict(stencil=s, quantized=True, far=far)
    t["K1"] = _device_ms(lambda: fused_substep2_call(hot, immut, cvec,
                                                     **k1kw), 50)
    t["K1 s0"] = _device_ms(lambda: fused_substep2_call(
        hot, immut, cvec, **dict(k1kw, stencil=0)), 50)
    t["compare"] = {}
    for st in (s, 0) if parent is not None else ():
        t["compare"][f"K1 s{st}"] = _turns(
            lambda: _raw_k1(parent, hot, immut, cvec, st, True, far),
            lambda: _raw_k1(_lib.library(), hot, immut, cvec, st, True, far),
            50)
    t["K1 plain"] = _timed_ms(lambda: fused_substep2_plain(hot, immut, cvec,
                                                           **k1kw), 5)
    planes5 = planes
    *planes, offsets = _band_inputs(hot[PX], hot[PY], hot[VX], hot[VY],
                                    alive, cfg, ff, s)
    flagged = _hold_k2("bench final state", planes, offsets)
    t["K2"] = _device_ms(lambda: band_flag_call(*planes, offsets=offsets),
                         50)
    # chunks past the TPU kernel's box: the kernel whose box is set at
    # launch, held bitwise at 8 and 16 and timed at 8 next to chunk 4
    wide = {}
    for chunk in (8, 16):
        *planes_c, offsets_c = _band_inputs(
            hot[PX], hot[PY], hot[VX], hot[VY], alive, cfg,
            dataclasses.replace(ff, chunk=chunk), s)
        _hold_k2(f"bench final state, chunk {chunk}", planes_c, offsets_c)
        wide[chunk] = (planes_c, offsets_c)
    planes8, offsets8 = wide[8]
    t["K2 chunk 8"] = _device_ms(
        lambda: band_flag_call(*planes8, offsets=offsets8), 50)
    if parent is not None:
        t["compare"]["K2"] = _turns(
            lambda: _raw_k2(parent, planes, offsets),
            lambda: _raw_k2(_lib.library(), planes, offsets), 50)
    t["K2 plain"] = _timed_ms(lambda: band_flags_plain(*planes, offsets), 5)
    n = hot.shape[1] * hot.shape[2]
    pairs8 = _band_pairs_evaluated(*planes8, offsets8)
    # K1: reads hot, immut and far, writes hot (the non-observing call)
    _log_bound("K1", (18 + 2 + 5 + 18) * 4 * n, _substep_ops(n, s))
    bounds = {"K1": _bound((18 + 2 + 5 + 18) * 4 * n, _substep_ops(n, s)),
              "K2": _bound(n * (4 * 4 + 1) + n,
                           7 * _band_pairs_evaluated(*planes, offsets)),
              "K7": _mirror_bound(planes5, table),
              "K2 chunk 8": _bound(n * (4 * 4 + 1) + n, 7 * pairs8)}
    _log_bound("K2 chunk 8", n * (4 * 4 + 1) + n, 7 * pairs8)
    log(f"K2 at chunk 8 ({len(offsets8)} offsets, {pairs8} pairs "
        f"evaluated): {t['K2 chunk 8']:.4f} ms; chunk 4 ({len(offsets)} "
        f"offsets) {t['K2']:.4f} ms")
    log(f"at the final state ({n_pairs} far pairs, {flagged} band-flagged "
        f"particles): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()
                                    if k != "compare")
        + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                                  for k, v in bounds.items()))
    return t, bounds


def time_paths_kernels(run_a, run_b, parent=None) -> dict:
    """K3 at path A's final state and K4 at path B's (CUDA events, ms per
    call), each against its plain version, with its bound; K4 also at
    stencil 0.  K3 is timed as path A calls it, on the state's interleaved
    views, and through its contiguous entry on contiguous copies.  With
    ``parent``, the parent's K3 and K4 (stencils 2 and 0) beside this
    tree's in turns, into ``t["compare"]``: K3 on contiguous planes, and
    on the views (the parent's wrapper copied them to contiguous planes
    first: its figure is the four copies and its kernel)."""
    st, cfg, consts = run_a["state"], run_a["cfg"], run_a["consts"]
    s = run_a["spec"].collision_stencil
    views = (st.pos[..., 0], st.pos[..., 1], st.vel[..., 0], st.vel[..., 1])
    planes = [v.contiguous() for v in views] + [st.alive]
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=s)
    t = {"K3": _device_ms(lambda: collide_stencil_call(*views, st.alive,
                                                       **kw), 50),
         "K3 contiguous": _device_ms(lambda: _raw_k3(_lib.library(), planes,
                                                     **kw), 50),
         "K3 plain": _timed_ms(lambda: collide_stencil_plain(
             *views, st.alive, **kw), 3), "compare": {}}
    if parent is not None:
        t["compare"]["K3 contiguous"] = _turns(
            lambda: _raw_k3(parent, planes, **kw),
            lambda: _raw_k3(_lib.library(), planes, **kw), 50)
        t["compare"]["K3 on the views"] = _turns(
            lambda: _raw_k3(parent, [v.contiguous() for v in views]
                            + [st.alive], **kw),
            lambda: collide_stencil_call(*views, st.alive, **kw), 50)
    n = planes[0].numel()
    near = _k3_pairs_near(views[0], views[1], s, cfg.particle_radius)
    n_pairs = n * len(collide_stencil.full_offsets(s))
    log(f"K3 at path A's final state: {near} of {n_pairs} pair evaluations "
        "within (2r)^2 * 1.00001 (the rest skip the pair math)")
    _log_bound("K3", n * (4 * 4 + 1) + 5 * 4 * n, _k3_ops(n, s))
    bounds = {"K3": _bound(n * (4 * 4 + 1) + 5 * 4 * n, _k3_ops(n, s))}

    mut, immut, cfg_b = run_b["mut"], run_b["immut"], run_b["cfg"]
    s_b = run_b["spec"].collision_stencil
    cvec = tb.consts_vector(run_b["consts"], tb.UserInput(), cfg_b,
                            run_b["spec"].height)
    kw4 = dict(stencil=s_b, quantized=cfg_b.force_mode == "quantized")
    t["K4"] = _device_ms(lambda: fused_substep_call(mut, immut, cvec,
                                                    **kw4), 50)
    t["K4 plain"] = _timed_ms(lambda: fused_substep_plain(mut, immut, cvec,
                                                          **kw4), 3)
    t["K4 s0"] = _device_ms(lambda: fused_substep_call(
        mut, immut, cvec, **dict(kw4, stencil=0)), 50)
    for st in (s_b, 0) if parent is not None else ():
        t["compare"][f"K4 s{st}"] = _turns(
            lambda: _raw_k4(parent, mut, immut, cvec, st, kw4["quantized"]),
            lambda: _raw_k4(_lib.library(), mut, immut, cvec, st,
                            kw4["quantized"]), 50)
    # K4: reads mut and immut, writes mut (path B has no far stack)
    _log_bound("K4", (26 + 22 + 26) * 4 * n, _substep_ops(n, s_b))
    bounds["K4"] = _bound((26 + 22 + 26) * 4 * n, _substep_ops(n, s_b))
    log("at paths A and B's final states: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()
                    if k != "compare")
        + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                                  for k, v in bounds.items()))
    return t, bounds


def _general_counts(st) -> tuple:
    """(live particles, live beams, finite), in one host read."""
    live = st.particle_alive
    finite = torch.isfinite(torch.cat([st.pos[live], st.vel[live]])).all()
    n, m, ok = torch.stack([st.particle_count, st.beam_count,
                            finite.to(torch.int64)]).tolist()
    return n, m, bool(ok)


def check_general_config1_cpu(dev) -> None:
    """BASELINE config 1 (the 32 x 32 cloth of ``__graft_entry__.entry``):
    one frame of the general engine on the card against the CPU."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    out = {}
    for d in ("cpu", dev):
        st, cfg = scenes.cloth(32, 32, device=d)
        out[str(d)] = sim_state_to_numpy(gstep.frame(st, consts, uin, cfg))
    got, ref = out[str(dev)], out["cpu"]
    errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in GENERAL_ATOL}
    if (any(not errs[k] <= GENERAL_ATOL[k] for k in errs)
            or not np.array_equal(got["beam_alive"], ref["beam_alive"])):
        raise AssertionError(f"general config 1: cuda vs cpu max |err| "
                             f"{errs} (limits {GENERAL_ATOL}), beams alive "
                             f"{int(got['beam_alive'].sum())} vs "
                             f"{int(ref['beam_alive'].sum())}")
    log(f"general config 1 cloth(32, 32): one frame on cuda == cpu (max "
        f"|err| {errs}, beams alive equal)")


def run_general(dev) -> list:
    """The general gather engine at BASELINE configs 1, 4 and 3 through
    ``ops/step.frame`` on the card: per configuration its substeps/s
    (CUDA events over the timed frames), broad-phase overflow, live
    particles and beams, and a finite state; one more frame of config 4
    under the profiler."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    rates = []
    for label, build, frames, warm in GENERAL_CONFIGS:
        st, cfg = build(dev)
        n0, m0, _ = _general_counts(st)
        box = [st]

        def step():
            box[0] = gstep.frame(box[0], consts, uin, cfg)

        for _ in range(warm):
            step()
        ms = _frames(step, frames)
        st = box[0]
        n1, m1, finite = _general_counts(st)
        if not finite:
            raise AssertionError(f"general {label}: non-finite state")
        overflow = int(broad_phase_overflow(st.pos, st.particle_alive, cfg))
        rate = frames * cfg.subticks / (sum(ms) / 1000.0)
        rates.append((label, rate))
        log(f"general {label}: {n1} of {st.max_particles} particles alive, "
            f"beams {m0} -> {m1}, {cfg.collision_mode} broad phase "
            f"(overflow {overflow}); {warm} + {frames} frames, timed frame "
            f"ms {[round(t, 1) for t in ms]} = {rate:.1f} substeps/s")
        if label.startswith("config 4"):
            profile_frame(f"general {label}", step, sum(ms) / len(ms),
                          cfg.subticks)
    return rates


# ---------------------------------------------------------------------------
# the runtime: the engines a user drives, on the worker thread


def _wait_frames(eng, n: int, far: dict, timeout: float = 120.0,
                 every: float = 0.01):
    """Poll ``eng.stats()`` every ``every`` s until frame ``n``; every
    read's far stats are folded into ``far`` (the fused backend's window
    resets on read): pairs and overflow as maxima.  Raises on a worker
    error."""
    t_end = time.monotonic() + timeout
    while True:
        st = eng.stats()
        far["far_pairs"] = max(far.get("far_pairs", 0), st.far_pairs)
        far["far_overflow"] = max(far.get("far_overflow", 0),
                                  st.far_overflow)
        far["far_active"] = max(far.get("far_active", 0), st.far_active)
        if st.frame_index >= n:
            return st
        if eng.error is not None or time.monotonic() > t_end:
            raise AssertionError(f"engine stopped at frame {st.frame_index}"
                                 f" (error {eng.error!r})")
        time.sleep(every)


def _pause(eng, far: dict) -> int:
    """Hide the engine (no frame steps after the acked read) and return
    its frame index."""
    eng.set_hidden(True)
    return _wait_frames(eng, 0, far).frame_index


def _witness(eng) -> dict:
    """Wrap the engine's ``backend.extract`` so that each frame's extract
    also keeps an independent clone of its positions (same stream, after
    the extract), by frame index: what a packet of that frame must hold,
    whatever the allocator did with the extracted copy since."""
    worker = eng._worker
    extract = worker.backend.extract
    kept = {}

    def wrapped(state):
        ex = extract(state)
        kept[worker._frame_index] = ex.tensors[0].clone()
        for old in [k for k in kept if k < worker._frame_index - 64]:
            del kept[old]
        return ex

    worker.backend.extract = wrapped
    return kept


def run_runtime_fused(dev, card: str) -> dict:
    """The fused engine at 1M: ``LatticeEngine(fused=True)`` on the bench
    scene with the bench far field, stepping flat-out on its worker
    thread.  Frames/s without and with ``render_packet()`` polled
    flat-out from this thread, in windows of RUNTIME_FRAMES frames
    (alone, polled, polled, alone; frames 2-10), packet latency, packets
    bitwise equal to
    the frame they name (an independent clone kept at extract), K1 64 and
    K2 8 launches per frame, K7 once far pairs exist, ``far_overflow`` 0
    over every stats read.  Then, paused, the L1 snapshot round trip
    (save → load → save byte-equal, timed), three ``corrupt_buffers``
    with stepping going on, and ``recreate(subticks=32)``."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         bounds_size=cfg.bounds_size,
                         collision_mode=cfg.collision_mode,
                         force_mode=cfg.force_mode, target_fps=None)
    far = {}
    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    eng = LatticeEngine(state, spec, consts, opts, farfield=_far_spec(spacing),
                        fused=True, device=dev)
    del state
    out = {}
    try:
        kept = _witness(eng)
        f = _wait_frames(eng, 2, far).frame_index
        packets, lat, seen = {}, [], [f]
        spent = {"alone": [0, 0.0], "polled": [0, 0.0]}  # frames, seconds
        for kind in ("alone", "polled", "polled", "alone"):
            t0 = time.perf_counter()
            if kind == "alone":  # this thread reads the stats every 50 ms
                f1 = _wait_frames(eng, f + RUNTIME_FRAMES, far,
                                  every=0.05).frame_index
            else:                # this thread polls packets flat-out
                while seen[-1] < f + RUNTIME_FRAMES:
                    ta = time.perf_counter()
                    pkt = eng.render_packet()
                    lat.append((time.perf_counter() - ta) * 1e3)
                    seen.append(pkt.frame_index)
                    if pkt.frame_index not in packets and len(packets) < 8:
                        packets[pkt.frame_index] = pkt.pos
                    if ta > t0 + 120.0 or eng.error is not None:
                        raise AssertionError(f"runtime: polled engine at "
                                             f"frame {seen[-1]} "
                                             f"({eng.error!r})")
                f1 = seen[-1]
            spent[kind][0] += f1 - f
            spent[kind][1] += time.perf_counter() - t0
            f = f1
        fps_alone = spent["alone"][0] / spent["alone"][1]
        fps_polled = spent["polled"][0] / spent["polled"][1]
        frames = _pause(eng, far)
        k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
        k7 = recmirror.K7_LAUNCHES
        if seen != sorted(seen):
            raise AssertionError("runtime: packet frame indices not "
                                 "monotonic")
        torch.cuda.synchronize()
        for idx, pos in packets.items():
            ref = kept[idx].cpu().numpy()
            if pos.tobytes() != ref.tobytes():
                raise AssertionError(f"runtime: the packet of frame {idx} "
                                     "differs from that frame's positions")
        if k1 != cfg.subticks * frames or k2 != 8 * frames:
            raise AssertionError(f"runtime: {frames} frames launched K1 {k1}"
                                 f", K2 {k2} times")
        if far["far_overflow"] or (far["far_pairs"] > 0) != (k7 > 0):
            raise AssertionError(f"runtime: far stats {far}, K7 {k7}")
        lat_ms = sorted(lat)
        out.update(fps_alone=fps_alone, fps_polled=fps_polled,
                   lat_median=lat_ms[len(lat_ms) // 2], lat_max=lat_ms[-1],
                   frames=frames, k1=k1, k2=k2, k7=k7, far=dict(far))
        log(f"runtime, fused engine 1M: {frames} frames on the worker "
            f"thread, {fps_alone:.3f} frames/s alone ({spent['alone'][0]} "
            f"frames), {fps_polled:.3f} frames/s with render_packet() "
            f"polled flat-out ({spent['polled'][0]} frames, {len(lat)} "
            f"packets, latency median {out['lat_median']:.1f} ms, max "
            f"{out['lat_max']:.1f} ms; frame indices monotonic; "
            f"{len(packets)} packets bitwise equal to their frame's "
            f"positions); K1 {k1} = {cfg.subticks} x {frames}, K2 {k2} = 8 "
            f"x {frames}, K7 {k7}; far stats over the reads {far} on {card}")

        # the L1 round trip, paused
        ta = time.perf_counter()
        buf = eng.save_snapshot()
        tb_ = time.perf_counter()
        if not eng.load_snapshot(buf):
            raise AssertionError("runtime: the engine refused its own L1 "
                                 "snapshot")
        tc = time.perf_counter()
        if eng.save_snapshot() != buf:
            raise AssertionError("runtime: L1 save -> load -> save differs")
        out.update(save_ms=(tb_ - ta) * 1e3, load_ms=(tc - tb_) * 1e3,
                   snapshot_mb=len(buf) / 1e6)
        log(f"runtime, L1 snapshot 1M: {len(buf)} bytes, save "
            f"{out['save_ms']:.1f} ms, load {out['load_ms']:.1f} ms, save -> "
            f"load -> save byte-equal on {card}")
        del buf
        for _ in range(3):
            eng.corrupt_buffers()
        eng.set_hidden(False)
        _wait_frames(eng, frames + 2, {})
        if eng.error is not None:
            raise AssertionError(f"runtime: corruption killed the engine: "
                                 f"{eng.error!r}")
        new = eng.recreate(subticks=32)
    finally:
        eng.destroy()
    try:
        st = _wait_frames(new, 1, {})
        if new.error is not None or st.particle_count != N_PARTICLES:
            raise AssertionError(f"runtime: recreated engine {st}, error "
                                 f"{new.error!r}")
        log(f"runtime: 3 corrupt_buffers, stepping went on; recreate("
            f"subticks=32) stepped {st.frame_index} frame(s)")
    finally:
        new.destroy()
    return out


def run_runtime_dense(dev) -> int:
    """Path A behind the engine: ``LatticeEngine(fused=False)`` with
    ``use_pallas`` and ``FarFieldSpec()`` on the 1M tearing cloth, 2
    frames; K3 launches 64 per frame.  Returns K3's launches."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         use_pallas=True, target_fps=None)
    collide_stencil.K3_LAUNCHES = 0
    with LatticeEngine(state, spec, consts, opts, farfield=FarFieldSpec(),
                       device=dev) as eng:
        del state
        far = {}
        _wait_frames(eng, 2, far)
        frames = _pause(eng, far)
        k3 = collide_stencil.K3_LAUNCHES
        if k3 != cfg.subticks * frames or far["far_overflow"]:
            raise AssertionError(f"runtime, dense engine: {frames} frames, "
                                 f"K3 {k3}, far {far}")
        if eng.error is not None:
            raise AssertionError(f"runtime, dense engine: {eng.error!r}")
    log(f"runtime, dense engine 1M (use_pallas, FarFieldSpec()): {frames} "
        f"frames, K3 {k3} = {cfg.subticks} x {frames}, far stats {far}")
    return k3


def run_runtime_general(dev) -> None:
    """The general engine on the card: one ``SimBackend`` frame of config
    1 (``cloth(32, 32)``) against the CPU's (phase 10's tolerances), then
    ``Engine`` stepping it for 5 frames on the worker thread, and a v0
    snapshot of ``cloth(16, 16)`` (within v0's 1638 beams) written from
    the card byte-equal to the one written from the CPU."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    out = {}
    for d in ("cpu", dev):
        st, cfg = scenes.cloth(32, 32, device=d)
        be = SimBackend(cfg, device=d)
        out[str(d)] = sim_state_to_numpy(be.step(st, consts, uin))
    errs = {k: float(np.abs(out[str(dev)][k] - out["cpu"][k]).max())
            for k in GENERAL_ATOL}
    if any(not errs[k] <= GENERAL_ATOL[k] for k in errs):
        raise AssertionError(f"runtime, general backend: cuda vs cpu {errs}")
    st, cfg = scenes.cloth(32, 32, device=dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         collision_mode=cfg.collision_mode, target_fps=None)
    with Engine(st, consts, opts, device=dev) as eng:
        far = {}
        _wait_frames(eng, 5, far)
        frames = _pause(eng, far)
        pkt = eng.render_packet()
        if eng.error is not None or not np.isfinite(pkt.pos).all():
            raise AssertionError(f"runtime, general engine: {eng.error!r}")
    bufs = [save_snapshot(scenes.cloth(16, 16, device=d)[0], consts,
                          format="v0") for d in ("cpu", dev)]
    if bufs[0] != bufs[1]:
        raise AssertionError("runtime: v0 snapshots from cuda and cpu "
                             "differ")
    log(f"runtime, general engine cloth(32, 32): one backend frame cuda == "
        f"cpu (max |err| {errs}), {frames} engine frames; v0 snapshot of "
        f"cloth(16, 16) from cuda == from cpu ({len(bufs[0])} bytes)")


def check_wide_k2_and_skip_flag(dev) -> None:
    """K2 on a stirred 97 × 61 lattice at chunks 1, 2, 8 and 16 (none, the
    compile-time box, the box set at launch), bitwise; and K1/K4 with
    dt = 1e-19, where clip overflows and the skip of pairs apart is off,
    against their plain versions, NaN-aware and bitwise."""
    st, cfg, consts, g = _k14_state(*K3_RAGGED, dev, SEED + 6)
    for chunk in (1, 2, 8, 16):
        ff = dataclasses.replace(_far_spec(980.0 / 96), chunk=chunk)
        *planes, offsets = _band_inputs(
            st.pos[..., 0], st.pos[..., 1], st.vel[..., 0], st.vel[..., 1],
            st.alive, cfg, ff, 2)
        _hold_k2(f"{K3_RAGGED[0]}x{K3_RAGGED[1]} chunk {chunk}", planes,
                 offsets)
    w, h = K3_RAGGED
    hot, _obs, immut, ec = pack_lattice2(st)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    cvec[1] = 1e-19
    mut, immut4 = pack_lattice(st)
    for k, call, plain, args in (
            ("K1", fused_substep2_call, fused_substep2_plain,
             (hot, immut, cvec)),
            ("K4", fused_substep_call, fused_substep_plain,
             (mut, immut4, cvec[:20].clone()))):
        for s in (1, 2):
            kw = dict(stencil=s, quantized=True)
            ref = plain(*args, **kw)
            got = call(*args, **kw)
            torch.cuda.synchronize()
            n_bad = int(_differs(got, ref).sum())
            n_nan = int(torch.isnan(ref).any(0).sum())
            if n_bad or not n_nan:
                raise AssertionError(f"{k} dt=1e-19 s={s}: {n_bad} values "
                                     f"differ ({n_nan} NaN particles)")
    log(f"K1/K4 at {w}x{h} with dt = 1e-19 (clip overflows, no skip): "
        "bitwise equal to the plain versions, NaN included, stencils 1, 2")


# ---------------------------------------------------------------------------
# the planified path: general topologies on the dense stencil path


def _clone(obj):
    """An independent device copy of a state (tensors, tuples and
    dataclasses of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(_clone(o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _close(label, got, ref, rtol, atol) -> float:
    """Raises unless ``|got − ref| ≤ atol + rtol·|ref|`` everywhere;
    returns the max abs difference."""
    bad = ~((got - ref).abs() <= atol + rtol * ref.abs())
    if int(bad.sum()):
        raise AssertionError(f"{label}: {int(bad.sum())} values outside "
                             f"rtol {rtol} / atol {atol}")
    return (got - ref).abs().max().item()


def check_planified_k3_vs_half(ps, spec, cfg, consts) -> None:
    """The first substep of the packed config-3 state with its collisions
    through K3 (full offsets) against the JAX default (``use_pallas``
    off: the half-offset sum), the far delta left out of both: they
    differ only in the collision sum's order."""
    uin = tb.UserInput()
    a = planify.planified_substep(ps, consts, uin, spec, cfg)
    b = planify.planified_substep(ps, consts, uin, spec,
                                  dataclasses.replace(cfg, use_pallas=False))
    errs = {k: _close(f"planified config 3, K3 vs the half-offset sum, {k}",
                      getattr(a.lat, k), getattr(b.lat, k), **K3_VS_HALF_TOL)
            for k in ("pos", "vel", "acc")}
    log(f"planified config 3, one substep: K3 (use_pallas) vs the "
        f"half-offset sum within rtol {K3_VS_HALF_TOL['rtol']} / atol "
        f"{K3_VS_HALF_TOL['atol']} (max |diff| {errs})")


def _planified_kernels(ps, spec, cfg, consts, ff) -> tuple:
    """K3 and K2 at the planified path's final state on its plane, held
    bit-exact against their plain versions and timed by device time
    beside their bounds (``_bound``, ``_k3_ops``)."""
    lat = ps.lat
    s = spec.collision_stencil
    views = (lat.pos[..., 0], lat.pos[..., 1], lat.vel[..., 0],
             lat.vel[..., 1])
    planes = [v.contiguous() for v in views] + [lat.alive]
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=s)
    ref = torch.stack(collide_stencil_plain(*planes, **kw))
    got = torch.stack(collide_stencil_call(*views, lat.alive, **kw))
    torch.cuda.synchronize()
    n_bad = int(_differs(got, ref).sum())
    if n_bad:
        raise AssertionError(f"K3 planified config 3 final state: {n_bad} "
                             "delta values differ from the plain version")
    *bplanes, offsets = _band_inputs(*views, lat.alive, cfg, ff, s)
    flagged = _hold_k2("planified config 3 final state", bplanes, offsets)
    n = lat.alive.numel()
    t = {"K3": _device_ms(lambda: collide_stencil_call(*views, lat.alive,
                                                       **kw), 50),
         "K3 plain": _timed_ms(lambda: collide_stencil_plain(*planes, **kw),
                               3),
         "K2": _device_ms(lambda: band_flag_call(*bplanes, offsets=offsets),
                          50),
         "K2 plain": _timed_ms(lambda: band_flags_plain(*bplanes, offsets),
                               3)}
    pairs = _band_pairs_evaluated(*bplanes, offsets)
    _log_bound("K3 planified", n * (4 * 4 + 1) + 5 * 4 * n, _k3_ops(n, s))
    _log_bound("K2 planified", n * (4 * 4 + 1) + n, 7 * pairs)
    bounds = {"K3": _bound(n * (4 * 4 + 1) + 5 * 4 * n, _k3_ops(n, s)),
              "K2": _bound(n * (4 * 4 + 1) + n, 7 * pairs)}
    log(f"K3 planified config 3 final state: deltas bit-exact (stencil "
        f"{s}, {spec.width}x{spec.height}); K2 {flagged} particles flagged, "
        f"{pairs} pairs evaluated; " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in t.items()) + "; bounds "
        + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                    for k, v in bounds.items()))
    return t, bounds


def run_directed_config3(flat, cfg, consts, uin, card) -> float:
    """The directed-CSR engine at config 3 from the settled flat state:
    its beam pass's force totals bit-exact against the flat pass
    (``ops/forces.py``, int32 sums at 2^16), then DIRECTED_FRAMES frames
    timed (CUDA events)."""
    t0 = time.perf_counter()
    ds, _slot_edge = build_directed(flat)
    t_build = time.perf_counter() - t0
    force, _upd = directed_beam_pass(ds, cfg)
    ref = accumulate_forces(flat, beam_forces(flat, cfg)[0], cfg)
    n_bad = int((force != ref).any(dim=1).sum())
    if n_bad:
        raise AssertionError(f"directed config 3: {n_bad} particles' beam "
                             "force totals differ from the flat pass")
    box = [ds]

    def step():
        box[0] = directed_frame(box[0], consts, uin, cfg)

    ms = _frames(step, DIRECTED_FRAMES)
    ds = box[0]
    live = ds.alive
    if not bool(torch.isfinite(torch.cat([ds.pos[live],
                                          ds.vel[live]])).all()):
        raise AssertionError("directed config 3: non-finite state")
    rate = DIRECTED_FRAMES * cfg.subticks / (sum(ms) / 1000.0)
    log(f"directed config 3: tables [{ds.n}, {ds.degree}] built in "
        f"{t_build:.1f} s; beam force totals bit-exact against the flat "
        f"pass; {DIRECTED_FRAMES} frames ({cfg.collision_mode} broad "
        f"phase), frame ms {[round(x, 1) for x in ms]} = {rate:.1f} "
        f"substeps/s on {card}")
    return rate


def run_planified_config3(dev, card) -> dict:
    """BASELINE config 3 on the planified path at full size
    (``scripts/bench_config3.py``'s ``planified`` mode with
    ``use_pallas``): the 100k cloth settled PLANIFIED_SETTLE frames on the
    general engine, embedded by ``PlanifiedBackend`` (stencil 3, far
    field K 16384, skin 3r, cadence 8), one warm frame, then
    PLANIFIED_FRAMES frames with the launch counts from 0: K3 64 and K2 8
    per frame, K7 once per substep whose bucket exceeds 256; finite state,
    ``far_overflow`` 0.  Then one profiled frame, K3 and K2 at the final
    state, and the directed engine from the same settled state."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    flat, cfg0 = scenes.self_colliding_cloth(PLANIFIED_N, device=dev)
    t0 = time.perf_counter()
    for _ in range(PLANIFIED_SETTLE):
        flat = gstep.frame(flat, consts, uin, cfg0)
    torch.cuda.synchronize()
    t_settle = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg0, collision_mode="allpairs",
                              use_pallas=True)
    ff = FarFieldSpec(max_pairs=16384, max_tile_pairs=256,
                      skin=3.0 * cfg0.particle_radius, horizon=8)
    be = PlanifiedBackend(cfg, collision_stencil=3, farfield=ff, device=dev)
    t0 = time.perf_counter()
    ps = be.pack_state(flat)
    t_embed = time.perf_counter() - t0
    spec, aux = be.spec, be.aux
    n0, m0 = be.counts(ps)
    log(f"planified config 3: settled {PLANIFIED_SETTLE} frames in "
        f"{t_settle:.1f} s, embedded in {t_embed:.1f} s: plane "
        f"{spec.width}x{spec.height} ({spec.width * spec.height} cells, "
        f"{n0} particles alive, {m0} beams), {len(spec.edge_offsets)} "
        f"offset classes {list(spec.edge_offsets)}, {aux.n_exceptions} "
        f"exception beams (capacity {ps.x.capacity})")
    check_planified_k3_vs_half(ps, spec, cfg, consts)

    box = [ps]

    def step():
        box[0] = be.step(box[0], consts, uin)

    step()
    warm = be.far_stats()
    collide_stencil.K3_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    routes0 = dict(farfield4.APPLY_ROUTES)
    ms = _frames(step, PLANIFIED_FRAMES)
    k3, k2 = collide_stencil.K3_LAUNCHES, band_detect.K2_LAUNCHES
    k7 = recmirror.K7_LAUNCHES
    routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
    stats = be.far_stats()
    ps = box[0]
    substeps = PLANIFIED_FRAMES * cfg.subticks
    if not bool(torch.isfinite(torch.stack([ps.lat.pos, ps.lat.vel])).all()):
        raise AssertionError("planified config 3: non-finite state")
    if stats["far_overflow"] != 0:
        raise AssertionError(f"planified config 3: far stats {stats}")
    if k3 != substeps:
        raise AssertionError(f"planified config 3: K3 launched {k3} times "
                             f"for {substeps} substeps")
    if k2 != 8 * PLANIFIED_FRAMES or k2 != stats["far_rebuilds"]:
        raise AssertionError(f"planified config 3: K2 launched {k2} times, "
                             f"far stats {stats}")
    # the apply ladder is (1024, 4096, 16384): every substep with active
    # pairs takes a bucket above 256, the mirror route, one K7 launch
    if k7 != routes["mirror"] or routes["narrow"]:
        raise AssertionError(f"planified config 3: K7 launched {k7} times; "
                             f"far applies by route {routes}")
    n1, m1 = be.counts(ps)
    rate = substeps / (sum(ms) / 1000.0)
    log(f"planified config 3: {PLANIFIED_FRAMES} frames = {substeps} "
        f"substeps, frame ms {[round(x, 1) for x in ms]} = {rate:.1f} "
        f"substeps/s ({rate * n1:.4g} particle-substeps/s); alive beams "
        f"{m0} -> {m1}; far stats warm frame {warm}, timed {stats}; K3 "
        f"{k3} = {cfg.subticks} x {PLANIFIED_FRAMES}, K2 {k2} = 8 x "
        f"{PLANIFIED_FRAMES}, K7 {k7} ({'on' if k7 else 'none of'} the "
        f"substeps with active pairs: {routes['mirror']} mirror-route "
        f"applies, bucket > 256) on {card}")
    profile_frame("planified config 3", step, sum(ms) / len(ms),
                  cfg.subticks)
    t, bounds = _planified_kernels(box[0], spec, cfg, consts, ff)
    directed_rate = run_directed_config3(flat, cfg0, consts, uin, card)
    return dict(k2=k2, k3=k3, k7=k7, rate=rate, t=t, bounds=bounds,
                stats=stats, directed_rate=directed_rate)


def _config4_backend(dev, collide: bool = True) -> tuple:
    """BASELINE config 4 (``multi_blob(64)``) and a far-armed
    ``PlanifiedBackend`` for it with ``use_pallas`` (the CLI's ``play
    --path planified --farfield`` far field: skin 3r, cadence 8)."""
    flat, cfg4 = scenes.multi_blob(64, device=dev)
    cfg = tb.StaticConfig(subticks=cfg4.subticks,
                          particle_radius=cfg4.particle_radius,
                          collision_mode=(cfg4.collision_mode if collide
                                          else "none"),
                          use_pallas=True)
    ff = FarFieldSpec(skin=3.0 * cfg4.particle_radius, horizon=8)
    return flat, cfg, PlanifiedBackend(cfg, farfield=ff, device=dev)


def check_planified_config4_cpu(dev) -> None:
    """One backend frame of config 4 on the card against the CPU: with
    collisions off, edge and exception state bit-exact (quantized
    forces); with them on, particle planes within GENERAL_ATOL."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    for collide in (False, True):
        out = {}
        for d in ("cpu", dev):
            flat, _cfg, be = _config4_backend(d, collide)
            ps = be.step(be.pack_state(flat), consts, uin)
            out[str(d)] = (planified_state_to_numpy(ps), be.far_stats())
        (got, st_g), (ref, st_c) = out[str(dev)], out["cpu"]
        errs = {k: float(np.abs(got["lat"][k] - ref["lat"][k]).max())
                for k in GENERAL_ATOL}
        if any(not errs[k] <= GENERAL_ATOL[k] for k in errs):
            raise AssertionError(f"planified config 4 (collisions "
                                 f"{collide}): cuda vs cpu {errs}")
        same = all(np.array_equal(eg[k], er[k])
                   for eg, er in zip(got["lat"]["edges"], ref["lat"]["edges"])
                   for k in ("target_length", "last_length", "alive")) and \
            all(np.array_equal(got["x"][k], ref["x"][k])
                for k in ("target_length", "last_length", "alive"))
        if not collide and not same:
            raise AssertionError("planified config 4, collisions off: edge "
                                 "or exception state differs cuda vs cpu")
        log(f"planified config 4, one backend frame, collisions "
            f"{'on' if collide else 'off'}: cuda vs cpu max |err| {errs}, "
            f"edge and exception state {'bit-exact' if same else 'differ'}"
            f", far stats cuda {st_g} / cpu {st_c}")


def run_planified_engine(dev, card) -> None:
    """Config 4 planified behind ``Engine`` on the card: frames on the
    worker thread with ``render_packet()`` polled every 5 ms, each packet
    bitwise
    equal to ``unplanify`` of an independent clone of its frame (kept at
    extract), K3 64 per frame, K7 once per mirror-route apply; then the v1 snapshot round trip, three
    ``corrupt_buffers`` with stepping going on, and ``recreate()`` (which,
    as in the JAX package, comes back on the default ``SimBackend``)."""
    consts = tb.PhysicsConstants()
    flat, cfg, be = _config4_backend(dev)
    ps = be.pack_state(flat)
    spec, aux = be.spec, be.aux
    if aux.n_exceptions == 0:
        raise AssertionError("planified config 4: no exception beams")
    # the backend alone first: two frames timed, one profiled
    box = [ps]

    def step():
        box[0] = be.step(box[0], consts, tb.UserInput())

    ms = _frames(step, 2)
    profile_frame("planified config 4", step, sum(ms) / len(ms),
                  cfg.subticks)
    log(f"planified config 4 backend alone: frame ms "
        f"{[round(x, 1) for x in ms]} = "
        f"{2 * cfg.subticks / (sum(ms) / 1000.0):.1f} substeps/s, far stats "
        f"{be.far_stats()}")
    ps = be.pack_state(flat)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         collision_mode=cfg.collision_mode, use_pallas=True,
                         target_fps=None)
    collide_stencil.K3_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    routes0 = dict(farfield4.APPLY_ROUTES)
    eng = Engine(ps, consts, opts, backend=be)
    try:
        worker = eng._worker
        extract, kept = be.extract, {}

        def witness(state):
            ex = extract(state)
            kept[worker._frame_index] = _clone(state)
            for old in [k for k in kept if k < worker._frame_index - 16]:
                del kept[old]
            return ex

        be.extract = witness
        far, packets, seen = {}, {}, []
        t0 = time.perf_counter()
        while len(packets) < PLANIFIED_ENGINE_FRAMES:
            pkt = eng.render_packet()
            if pkt is not None and pkt.frame_index not in packets:
                packets[pkt.frame_index] = pkt
                seen.append((time.perf_counter(), pkt.frame_index))
            if eng.error is not None or time.perf_counter() > t0 + 120.0:
                raise AssertionError(f"planified engine: {eng.error!r}, "
                                     f"{len(packets)} packets")
            time.sleep(0.005)
        frames = _pause(eng, far)
        k3, k7 = collide_stencil.K3_LAUNCHES, recmirror.K7_LAUNCHES
        routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
        if k3 != cfg.subticks * frames:
            raise AssertionError(f"planified engine: {frames} frames "
                                 f"launched K3 {k3} times")
        # the ladder is (1024, 4096): every substep with active pairs
        # takes a bucket above 256, the mirror route, one K7 launch
        if not k7 or k7 != routes["mirror"] or routes["narrow"]:
            raise AssertionError(f"planified engine: K7 launched {k7} "
                                 f"times, far applies by route {routes}")
        torch.cuda.synchronize()
        names = ("pos", "particle_alive", "beam_a", "beam_b", "beam_alive",
                 "beam_strain", "beam_stress")
        for idx, pkt in packets.items():
            ref = sim_state_to_numpy(planify.unplanify(kept[idx], flat, aux))
            for name in names:
                a, b = np.asarray(getattr(pkt, name)), ref[name]
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise AssertionError(f"planified engine: the packet of "
                                         f"frame {idx} differs from "
                                         f"unplanify in {name}")
        fps = (seen[-1][1] - seen[0][1]) / (seen[-1][0] - seen[0][0])
        log(f"planified engine, config 4 multi_blob(64): plane "
            f"{spec.width}x{spec.height}, {len(spec.edge_offsets)} offset "
            f"classes, {aux.n_exceptions} exception beams; {frames} frames "
            f"on the worker thread, {fps:.2f} frames/s with render_packet() "
            f"polled every 5 ms; {len(packets)} packets bitwise equal to "
            f"unplanify of their frame; K3 {k3} = {cfg.subticks} x {frames},"
            f" K7 {k7} (one per mirror-route apply: {routes['mirror']} of "
            f"{cfg.subticks * frames} substeps); far stats over the reads "
            f"{far} on {card}")
        buf = eng.save_snapshot()
        if buf[:4] == b"SBL1" or not eng.load_snapshot(buf):
            raise AssertionError("planified engine: its v1 snapshot refused")
        if eng.save_snapshot() != buf:
            raise AssertionError("planified engine: save -> load -> save "
                                 "differs")
        for _ in range(3):
            eng.corrupt_buffers()
        eng.set_hidden(False)
        _wait_frames(eng, frames + 2, {})
        new = eng.recreate()
    finally:
        eng.destroy()
    try:
        st = _wait_frames(new, 1, {})
        log(f"planified engine: v1 snapshot ({len(buf)} bytes) save -> load "
            f"-> save byte-equal; 3 corrupt_buffers, stepping went on; "
            f"recreate() stepped {st.frame_index} frame(s) on "
            f"{type(new._worker.backend).__name__}")
    finally:
        new.destroy()


def _fold_strip(dev):
    """The strip of tests/test_planify.py:203-260 (24 × 2, spacing 12)
    embedded flat, its planes then moved to the fold (its left third
    over its right third, approaching): ``(PlanifiedState, spec)``."""
    nx, ny, sp = 24, 2, 12.0
    pos = np.array([[100.0 + i * sp, 500.0 + j * sp]
                    for i in range(nx) for j in range(ny)], np.float32)
    beams = np.array([[i * ny + j, i * ny + j + d] for i in range(nx)
                      for j in range(ny) for d in (ny, 1)
                      if (d == ny and i + 1 < nx) or (d == 1 and j + 1 < ny)],
                     np.int32)
    lengths = np.linalg.norm(pos[beams[:, 0]] - pos[beams[:, 1]],
                             axis=1).astype(np.float32)
    m = len(beams)
    props = {"spring": np.full(m, 50.0, np.float32),
             "damp": np.full(m, 5.0, np.float32),
             "yield_strain": np.full(m, 10.0, np.float32),
             "strain_limit": np.full(m, 10.0, np.float32)}
    flat = scenes._build(pos, beams, lengths, props, device="cpu")
    ps, spec, aux = planify.planify(flat, collision_stencil=3,
                                    chunk_multiple=16)
    pos2, vel2 = pos.copy(), np.zeros_like(pos)
    for i in range(nx // 3):
        for j in range(ny):
            p = i * ny + j
            pos2[p] = (pos[(nx - 1 - i) * ny + j, 0], 500.0 + j * sp + 16.0)
            vel2[p, 1] = -40.0

    def planes(flat_xy):
        out = np.zeros((aux.width * aux.height, 2), np.float32)
        out[aux.cell_of] = flat_xy
        return out.reshape(aux.width, aux.height, 2)

    fields = planified_state_to_numpy(ps)
    fields["lat"]["pos"], fields["lat"]["vel"] = planes(pos2), planes(vel2)
    return planified_state_from_numpy(**fields, device=dev), spec


def check_planified_fold(dev) -> None:
    """The fold through ``planified_frame_far`` on the card against the
    CPU, once through the narrow route (a 256-pair list) and once through
    the mirror route (512 pairs: bucket 512 > 256, K7 once per substep
    on the card): far stats equal and non-empty, positions and
    velocities within check_small_fold's tolerances."""
    cfg = tb.StaticConfig(subticks=4, particle_radius=4.0)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    for route, max_pairs in (("narrow", 256), ("mirror", 512)):
        ff = FarFieldSpec(max_pairs=max_pairs, max_tile_pairs=64, skin=18.0,
                          horizon=2)
        out = {}
        for d in ("cpu", dev):
            ps, spec = _fold_strip(d)
            before = dict(farfield4.APPLY_ROUTES)
            k7 = recmirror.K7_LAUNCHES
            ps, st = planify.planified_frame_far(ps, consts, uin, spec, cfg,
                                                 ff)
            k7 = recmirror.K7_LAUNCHES - k7
            ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
            if ran[route] != cfg.subticks or sum(ran.values()) != ran[route]:
                raise AssertionError(f"planified fold on {d}: applies by "
                                     f"route {ran}, want all {route}")
            # K7 once per mirror-route apply on the card; the CPU runs its
            # plain version
            if k7 != (ran["mirror"] if d == dev else 0):
                raise AssertionError(f"planified fold on {d}: K7 launched "
                                     f"{k7} times, applies by route {ran}")
            out[str(d)] = (st.tolist(), ps.lat.pos.cpu(), ps.lat.vel.cpu())
        (st_g, pos_g, vel_g), (st_c, pos_c, vel_c) = out[str(dev)], out["cpu"]
        dpos = (pos_g - pos_c).abs().max().item()
        dvel = (vel_g - vel_c).abs().max().item()
        if st_g != st_c or st_g[1] == 0 or st_g[2] or not (
                dpos <= 5e-3 and dvel <= 5e-2):
            raise AssertionError(f"planified fold, {route} route: stats cuda "
                                 f"{st_g} cpu {st_c}, |dpos| {dpos}, |dvel| "
                                 f"{dvel}")
        log(f"planified fold {spec.width}x{spec.height}, {route} route: cuda "
            f"== cpu plain (stats {st_g}; max |dpos| {dpos:.3g}, |dvel| "
            f"{dvel:.3g}); K7 {k7} on the card")


def run_fused_activation(dev, bench_rate: float, card: str) -> dict:
    """``FusedLatticeBackend`` on the bench scene with the activation
    schedule off, then on, over the same frames: ACTIVATION_WARM frames,
    then frames 8-10 with the launch counts from 0 (K1 64 per frame, K2
    once per rebuild, K7 once per mirror-route apply; far pairs present,
    ``far_active ≤ far_pairs``, ``far_overflow`` 0), then one profiled
    frame."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    uin = tb.UserInput()
    substeps = ACTIVATION_FRAMES * cfg.subticks
    rates = {}
    for act in (False, True):
        be = FusedLatticeBackend(spec, cfg, farfield=_far_spec(spacing),
                                 far_activation=act, device=dev)
        box = [be.pack_state(state)]

        def step():
            box[0] = be.step(box[0], consts, uin)

        for _ in range(ACTIVATION_WARM):
            step()
        be.far_stats()
        fused_substep2.K1_LAUNCHES = 0
        band_detect.K2_LAUNCHES = 0
        recmirror.K7_LAUNCHES = 0
        routes0 = dict(farfield4.APPLY_ROUTES)
        ms = _frames(step, ACTIVATION_FRAMES)
        k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
        k7 = recmirror.K7_LAUNCHES
        routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
        stats = be.far_stats()
        label = f"fused backend, far_activation={act}"
        if not bool(torch.isfinite(box[0][0][:6]).all()):
            raise AssertionError(f"{label}: non-finite state")
        if (stats["far_overflow"] or stats["far_active"] > stats["far_pairs"]
                or not stats["far_active"] or k1 != substeps
                or k2 != stats["far_rebuilds"] or not k7
                or k7 != routes["mirror"] or routes["narrow"]):
            raise AssertionError(f"{label}: far stats {stats}, K1 {k1}, K2 "
                                 f"{k2}, K7 {k7}, routes {routes}")
        rates[act] = substeps / (sum(ms) / 1000.0)
        profile_frame(label, step, sum(ms) / len(ms), cfg.subticks)
        log(f"{label}, bench scene frames {ACTIVATION_WARM + 1}-"
            f"{ACTIVATION_WARM + ACTIVATION_FRAMES}: frame ms "
            f"{[round(x, 1) for x in ms]} = {rates[act]:.1f} substeps/s; far "
            f"stats {stats} (the profiled frame after them: "
            f"{be.far_stats()}); K1 {k1}, K2 {k2}, K7 {k7} on {card}")
        del be, box
    log(f"fused backend on the bench scene, frames {ACTIVATION_WARM + 1}-"
        f"{ACTIVATION_WARM + ACTIVATION_FRAMES}: {rates[True]:.1f} substeps/s "
        f"with far_activation, {rates[False]:.1f} without (phase 6 over "
        f"frames 3-10: {bench_rate:.1f}) on {card}")
    return dict(rate=rates[True], rate_off=rates[False])


def _cli(argv, dev) -> tuple:
    """``softbody_tpu_torch.cli.main(argv + ["--device", dev])`` in this
    process (so the launch counters see its kernels), its standard output
    captured; returns (output, its last line as JSON or None, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv) + ["--device", str(dev)])
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    text = out.getvalue()
    last = text.strip().splitlines()[-1] if text.strip() else ""
    try:
        parsed = json.loads(last)
    except json.JSONDecodeError:
        parsed = None
    return text, parsed, secs


def _launches() -> dict:
    return {"K1": fused_substep2.K1_LAUNCHES, "K2": band_detect.K2_LAUNCHES,
            "K3": collide_stencil.K3_LAUNCHES,
            "K4": fused_substep.K4_LAUNCHES, "K7": recmirror.K7_LAUNCHES}


def _zero_launches() -> None:
    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    collide_stencil.K3_LAUNCHES = 0
    fused_substep.K4_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0


def _engine_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "softbody-engine-worker" and t.is_alive()]


def _play(argv, dev, card) -> dict:
    """``play`` headless: standard input a buffer (not a terminal), the
    frames drawn into the captured output; the engine destroyed after."""
    stdin = sys.stdin
    sys.stdin = io.StringIO()
    _zero_launches()
    try:
        text, _, secs = _cli(["play"] + argv, dev)
    finally:
        sys.stdin = stdin
    k = _launches()
    frames = text.count("\x1b[H")
    hud = [line for line in text.split("\x1b[H")[-1].splitlines()
           if "substeps/s |" in line]
    if not frames or not hud:
        raise AssertionError(f"play {argv}: {frames} frames drawn, HUD "
                             f"{hud}")
    if _engine_threads():
        raise AssertionError(f"play {argv}: engine worker left alive")
    log(f"cli play {' '.join(argv)}: {frames} frames drawn in {secs:.1f} s, "
        f"launches {k}; last HUD: {hud[-1].strip()[:110]!r} on {card}")
    return k


def check_render_card_vs_cpu(dev) -> None:
    """The rasterizer on the card against the CPU's, as uint8, on a
    stirred 48 x 48 cloth (several beam and particle chunks) with a fifth
    of its beams dead and random stresses."""
    state, spec, cfg, _consts, spacing = _scene(48 * 48, "cpu")
    state = _stirred(state, spacing, SEED + 13)
    sim = lattice_to_simstate(state, build_incidence=False, device="cpu")
    g = torch.Generator().manual_seed(SEED + 13)
    sim.beam_alive &= torch.rand(sim.beam_alive.shape, generator=g) > 0.2
    sim.beam_stress = torch.randn(sim.beam_stress.shape, generator=g)
    imgs = []
    for d in ("cpu", dev):
        on_d = dataclasses.replace(sim, **{
            f.name: getattr(sim, f.name).to(d)
            for f in dataclasses.fields(sim) if getattr(sim, f.name) is not None})
        img = viz.render_state(on_d, cfg, resolution=512)
        imgs.append(torch.round(img * 255).to(torch.uint8).cpu())
    drawn = int((imgs[0].sum(-1) > 0).sum())
    if not torch.equal(imgs[0], imgs[1]) or drawn < 10_000:
        raise AssertionError(f"render card vs CPU: {drawn} pixels drawn, "
                             f"{int((imgs[0] != imgs[1]).sum())} differ")
    log(f"render_frame card == CPU as uint8 (48x48 stirred cloth, "
        f"{int(sim.beam_alive.sum())} beams alive, {drawn} pixels drawn)")


def check_far_order(dev) -> None:
    """Repair 0 on the card: the stirred 40 x 40 cloth's frame with the
    activation schedule off and on, twice on the card without torch's
    deterministic algorithms: the runs are bit-identical and equal the
    CPU's frame bit for bit (the far apply sums in list order)."""
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("deterministic algorithms are on")
    # tests/test_torch_cuda.py::test_stirred_cloth_activation_matches_cpu
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=40 * 40, fall_speed=2.5, slits=2, strain_limit=0.22,
        yield_strain=0.18, device="cpu")
    spacing = 980.0 / (spec.width - 1)
    g = torch.Generator().manual_seed(6)

    def noise(scale):
        return torch.randn(state.pos.shape, generator=g) * scale

    state = dataclasses.replace(state, pos=state.pos + noise(0.3 * spacing),
                                vel=state.vel + noise(6.0 * spacing))
    ff = FarFieldSpec(max_pairs=1024, max_tile_pairs=64,
                      skin=0.75 * spacing, horizon=8)
    routes0 = dict(farfield4.APPLY_ROUTES)
    out = {}
    for d, runs in (("cpu", 1), (dev, 2)):
        st = lattice_state_from_numpy(**lattice_state_to_numpy(state),
                                      device=d)
        for act in (False, True):
            for run in range(runs):
                hot, obs, immut, ec = pack_lattice2(st)
                hot, obs, stats = fused_substep2.fused_frame4(
                    hot, obs, immut, ec, consts, tb.UserInput(), spec, cfg,
                    ff, activation=act)
                out[str(d), act, run] = (hot[0:6].cpu(), stats.tolist())
    routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
    for act in (False, True):
        cpu = out["cpu", act, 0]
        g0, g1 = out[str(dev), act, 0], out[str(dev), act, 1]
        same = torch.equal(g0[0], g1[0]) and g0[1] == g1[1]
        equal = torch.equal(g0[0], cpu[0]) and g0[1] == cpu[1]
        if not (same and equal) or cpu[1][1] == 0:
            raise AssertionError(
                f"far order, schedule {act}: card runs identical {same}, "
                f"card == CPU {equal}; far stats {g0[1]} / {cpu[1]}; max "
                f"|dpos| card-card {(g0[0] - g1[0]).abs().max().item():.4g},"
                f" card-CPU {(g0[0] - cpu[0]).abs().max().item():.4g}")
    log(f"far apply order (stirred 40x40 cloth, one frame, schedule off and "
        f"on, far stats {out['cpu', True, 0][1]}, applies by route "
        f"{routes}): two card runs bit-identical and equal to the CPU, "
        f"deterministic algorithms off")


def run_cli(dev, card: str) -> dict:
    """Phase 13: the CLI's verbs in this process at full size, each with
    the launch counts from 0: ``run`` of the 1M tearing cloth on the
    lattice path and of the 100k cloth planified and far-armed (K2 at
    every rebuild), ``render`` of the 1M cloth, ``play`` of the 1M cloth
    far-armed (K2) and of the default scene, ``snapshot create`` and
    ``info`` of the 1M general scene, the editor, and the far apply's
    fixed order card vs CPU."""
    parts = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    launches_cli = {"K2": 0, "K7": 0}

    def add(k):
        for key in launches_cli:
            launches_cli[key] += k[key]

    _zero_launches()
    _, out, secs = _cli(["run", "--scene", "tearing_cloth", "--path",
                         "lattice", "--n", str(CLI_LATTICE_N), "--frames",
                         str(CLI_FRAMES)], dev)
    k = _launches()
    add(k)
    if not out or not out["finite"]:
        raise AssertionError(f"cli run lattice: {out}")
    log(f"cli run --scene tearing_cloth --path lattice ({CLI_LATTICE_N} "
        f"particles, {CLI_FRAMES} frames): beams_alive {out['beams_alive']}, "
        f"{out['substeps_per_sec']} substeps/s, finite; {secs:.1f} s; "
        f"launches {k} on {card}")
    lap("run lattice")

    _zero_launches()
    _, out, secs = _cli(["run", "--scene", "self_colliding_cloth", "--n",
                         str(CLI_PLANIFIED_N), "--path", "planified",
                         "--farfield", "--frames", str(CLI_FRAMES)], dev)
    k = _launches()
    add(k)
    if not out or not out["finite"] or k["K2"] == 0:
        raise AssertionError(f"cli run planified --farfield: {out}, "
                             f"launches {k}")
    log(f"cli run --scene self_colliding_cloth --n {CLI_PLANIFIED_N} --path "
        f"planified --farfield ({CLI_FRAMES} frames): beams_alive "
        f"{out['beams_alive']}, {out['substeps_per_sec']} substeps/s, "
        f"finite; {secs:.1f} s; K2 {k['K2']}, K7 {k['K7']} launches "
        f"({k}) on {card}")
    lap("run planified")

    with tempfile.TemporaryDirectory() as tmp:
        _zero_launches()
        _, out, secs = _cli(["render", "--scene", "tearing_cloth", "--path",
                             "lattice", "--n", str(CLI_LATTICE_N),
                             "--frames", "1", "--resolution", "512",
                             "--out", tmp], dev)
        pngs = sorted(Path(tmp).glob("*.png"))
        if not out or out["frames_written"] != 1 or len(pngs) != 1:
            raise AssertionError(f"cli render: {out}, {pngs}")
        log(f"cli render --scene tearing_cloth --path lattice --frames 1 "
            f"--resolution 512: {pngs[0].name}, {pngs[0].stat().st_size} "
            f"bytes, verb {secs:.1f} s; launches {_launches()}")
    lstate, _spec, lcfg, _ = tearing_cloth_lattice(n_particles=CLI_LATTICE_N,
                                                   device=dev)
    sim = lattice_to_simstate(lstate, build_incidence=False, device=dev)
    del lstate
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = viz.render_state(sim, lcfg, resolution=512)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    if tuple(img.shape) != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"render at 1M: {tuple(img.shape)}")
    log(f"render_state of the {int(sim.particle_count)}-particle, "
        f"{int(sim.beam_count)}-beam cloth at 512 px: ms "
        f"{[round(x, 1) for x in ms]} (host clock around a sync) on {card}")
    del sim, img
    check_render_card_vs_cpu(dev)
    lap("render")

    add(_play(["--scene", "tearing_cloth", "--path", "lattice", "--farfield",
               "--n", str(CLI_LATTICE_N), "--duration",
               str(CLI_PLAY_S[0])], dev, card))
    if launches_cli["K2"] == 0:
        raise AssertionError("cli play --farfield: K2 not launched")
    _play(["--scene", "default", "--duration", str(CLI_PLAY_S[1])], dev, card)
    lap("play")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tearing_cloth.sbt")
        _, created, secs_c = _cli(["snapshot", "create", path, "--scene",
                                   "tearing_cloth", "--n",
                                   str(CLI_LATTICE_N)], dev)
        _, info, secs_i = _cli(["snapshot", "info", path], dev)
        with open(path, "rb") as f:
            head = f.read(12)
        n_p, n_b = struct.unpack("<II", head[4:12])
        if (head[:4] != b"SBT1" or info["format"] != "v1"
                or (info["particles"], info["beams"]) != (n_p, n_b)
                or n_p != math.isqrt(CLI_LATTICE_N) ** 2):
            raise AssertionError(f"cli snapshot: {created}, {info}, header "
                                 f"{head[:4]!r} {n_p} {n_b}")
        log(f"cli snapshot create/info of tearing_cloth: {created['bytes']} "
            f"bytes in {secs_c:.1f} s; info {n_p} particles, {n_b} beams in "
            f"{secs_i:.1f} s")
    lap("snapshot")

    reg = SceneRegistry()
    add_rectangle(reg, 200.0, 300.0, 12.0, CLI_EDITOR_SIDE, CLI_EDITOR_SIDE,
                  60.0, 2.0, 0.3, 0.6)
    ed = SoftbodyEditor(reg, device=dev)
    st, consts = load_snapshot(ed.save(), device=dev)
    eng = Engine(st, consts, EngineOptions(target_fps=None), device=dev)
    try:
        t1 = time.perf_counter()
        while eng.stats().frame_index < 2:
            if time.perf_counter() - t1 > 120:
                raise AssertionError("editor scene: no 2 frames in 120 s")
            time.sleep(0.01)
        pkt = eng.render_packet()
    finally:
        eng.destroy()
    img = ed.render(resolution=512, overlay=True)
    if (img.dtype != np.uint8 or img.shape != (512, 512, 3)
            or not np.isfinite(pkt.pos).all() or _engine_threads()):
        raise AssertionError(f"editor: image {img.dtype} {img.shape}")
    log(f"editor: {reg.particle_count} particles, {reg.beam_count} beams "
        f"saved, loaded on {dev}, 2 engine frames, render {img.shape} "
        f"uint8")
    lap("editor")

    check_far_order(dev)
    lap("far order")
    log(f"phase 13 cli parts (s): {parts}")
    return launches_cli


# ---------------------------------------------------------------------------
# phase 14: the parallel layer (softbody_tpu_torch/parallel), every shard on
# this card: a mesh of devices=[cuda] * n, single-controller


def _shard_mesh(dev, n: int, dp: int = 1):
    """A dp × (n/dp) mesh whose every shard is ``dev``."""
    return make_mesh(n, dp=dp, devices=[torch.device(dev)] * n)


def _short(cfg, n: int = SHARD_PROFILE_SUBSTEPS):
    """``cfg`` with ``n`` substeps a frame: the profiled step (its dt
    differs; the launches per substep and the host's pace do not)."""
    return dataclasses.replace(cfg, subticks=n)


def _idle_and_launches(step, substeps: int) -> tuple:
    """``step`` (``substeps`` substeps of a path already run) once timed by
    CUDA events and once under ``torch.profiler``: (device idle share
    against the unprofiled time, kernel launches per substep)."""
    from torch.profiler import ProfilerActivity, profile

    ms = _frames(step, 1)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return 1.0 - busy_ms / ms, len(kernels) / substeps


def _log_sharded(label: str, rate: float, rate_one: float, idle: float,
                 per_substep: float, card: str, extra: str = "") -> None:
    log(f"phase 14 {label}: {rate:.1f} substeps/s sharded, {rate_one:.1f} "
        f"unsharded in this run; {per_substep:.1f} launches per substep, "
        f"device idle share {idle:.2f} (one profiled step of "
        f"{SHARD_PROFILE_SUBSTEPS} substeps){extra} on {card}")


def _tensors_differ(pairs) -> list:
    """``[(name, max |a − b|)]`` of the pairs not bit-equal (NaN equal to
    NaN)."""
    out = []
    for name, a, b in pairs:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if \
            a.dtype.is_floating_point else a == b
        if not bool(same.all()):
            d = (a.to(torch.float32) - b.to(torch.float32)).abs()
            out.append((name, torch.nan_to_num(d, nan=float("inf")).max()
                        .item()))
    return out


def _lattice_pairs(a, b):
    pairs = [(k, getattr(a, k), getattr(b, k))
             for k in ("pos", "vel", "acc", "alive", "pinned")]
    for c, (ea, eb) in enumerate(zip(a.edges, b.edges)):
        pairs += [(f"edge{c} {f.name}", getattr(ea, f.name),
                   getattr(eb, f.name)) for f in dataclasses.fields(ea)]
    return pairs


def run_sharded_path_a(dev, card: str) -> dict:
    """Path A in 4 slabs: ``lattice_spatial`` over a 1×4 mesh on the
    default 1M cloth with ``use_pallas`` (K3 on each slab every substep),
    frames 1-3, bit for bit against the single-device ``lattice_frame``
    over the same frames."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    uin = tb.UserInput()
    one = [state]

    def step_one():
        one[0] = lattice_frame(one[0], consts, uin, spec, cfg)

    ms_one = _frames(step_one, SHARD_FRAMES_A)
    mesh = _shard_mesh(dev, 4)
    fn = lattice_spatial_frame_fn(spec, cfg, mesh)
    box = [shard_lattice(state, mesh)]

    def step():
        box[0] = fn(box[0], consts, uin)

    collide_stencil.K3_LAUNCHES = 0
    ms = _frames(step, SHARD_FRAMES_A)
    k3 = collide_stencil.K3_LAUNCHES
    substeps = SHARD_FRAMES_A * cfg.subticks
    if k3 != 4 * substeps:
        raise AssertionError(f"path A in slabs: K3 launched {k3} times for "
                             f"{substeps} substeps on 4 slabs")
    got = unshard_lattice(box[0])
    diff = _tensors_differ(_lattice_pairs(got, one[0]))
    if diff:
        raise AssertionError(f"path A in slabs differs from lattice_frame: "
                             f"{diff}")
    fn_s = lattice_spatial_frame_fn(spec, _short(cfg), mesh)
    idle, per = _idle_and_launches(lambda: fn_s(box[0], consts, uin),
                                   SHARD_PROFILE_SUBSTEPS)
    rate = substeps / (sum(ms) / 1e3)
    rate_one = substeps / (sum(ms_one) / 1e3)
    _log_sharded(f"path A in 4 slabs ({spec.width}x{spec.height}, frames "
                 f"1-{SHARD_FRAMES_A}, K3 {k3} launches = 4 per substep, "
                 "equal to lattice_frame bit for bit)", rate, rate_one,
                 idle, per, card)
    return dict(k3=k3, rate=rate, rate_one=rate_one)


def run_sharded_path_b(dev, card: str) -> dict:
    """Path B in 4 slabs: ``fused_spatial`` over 1×4 on the default scene
    (K4 on each slab every substep, a ghost ring of the stencil's reach),
    frames 1-8, bit for bit against the single-device ``fused_frame``;
    then K4's device time per substep on the 4 slabs against the whole
    lattice's."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    uin = tb.UserInput()
    mut, immut = pack_lattice(state)
    one = [mut]

    def step_one():
        one[0] = fused_frame(one[0], immut, consts, uin, spec, cfg)

    ms_one = _frames(step_one, SHARD_FRAMES_B)
    mesh = _shard_mesh(dev, 4)
    ring = ghost_width(spec)
    m, im, w_loc = pack_lattice_sharded(state, 4, ghost=ring)
    m, im = shard_stacks(m, im, mesh)
    fn = fused_spatial_frame_fn(spec, cfg, mesh)
    box = [m]

    def step():
        box[0] = fn(box[0], im, consts, uin)

    fused_substep.K4_LAUNCHES = 0
    ms = _frames(step, SHARD_FRAMES_B)
    k4 = fused_substep.K4_LAUNCHES
    substeps = SHARD_FRAMES_B * cfg.subticks
    if k4 != 4 * substeps:
        raise AssertionError(f"path B in slabs: K4 launched {k4} times for "
                             f"{substeps} substeps on 4 slabs")
    got = interiors(box[0], w_loc, dev)
    diff = _tensors_differ([("mut", got, one[0])])
    if diff:
        raise AssertionError(f"path B in slabs differs from fused_frame: "
                             f"{diff}")
    cvec = tb.consts_vector(consts, uin, cfg, spec.height)
    kw = dict(stencil=spec.collision_stencil,
              quantized=cfg.force_mode == "quantized")
    k4_one = _device_ms(lambda: fused_substep_call(one[0], immut, cvec,
                                                   **kw), 50)
    k4_slabs = _device_ms(lambda: [fused_substep_call(a, b, cvec, **kw)
                                   for a, b in zip(box[0], im)], 50)
    fn_s = fused_spatial_frame_fn(spec, _short(cfg), mesh)
    idle, per = _idle_and_launches(lambda: fn_s(box[0], im, consts, uin),
                                   SHARD_PROFILE_SUBSTEPS)
    rate = substeps / (sum(ms) / 1e3)
    rate_one = substeps / (sum(ms_one) / 1e3)
    _log_sharded(f"path B in 4 slabs ({spec.width}x{spec.height}, slabs of "
                 f"{w_loc} + 2x{ring} ghost columns, frames "
                 f"1-{SHARD_FRAMES_B}, K4 {k4} launches = 4 per substep, "
                 "equal to fused_frame bit for bit)", rate, rate_one, idle,
                 per, card, extra=f"; K4 device ms per substep: 4 slabs "
                 f"{k4_slabs:.4f}, whole lattice {k4_one:.4f} (ratio "
                 f"{k4_slabs / k4_one:.3f})")
    return dict(k4=k4, rate=rate, rate_one=rate_one, k4_slabs=k4_slabs,
                k4_one=k4_one)


def _bench_sharded_frame(hot, obs, spec, cfg, consts, ff, n: int,
                         template) -> tuple:
    """One frame of the bench scene in ``n`` slabs from the single-device
    stacks ``hot``/``obs``, far-armed unless ``ff`` is None: the frame's
    hot stack (the slabs' interiors) and its far record."""
    ls = unpack_lattice2(hot, obs, template)
    h, o, im, ec, w_loc = pack_lattice2_sharded(ls, n,
                                                ghost=ghost_width(spec, ff))
    mesh = _shard_mesh(hot.device, n)
    h, o, im = shard_stacks2(h, o, im, mesh)
    fn = fused_spatial2_frame_fn(spec, cfg, mesh, ffspec=ff,
                                 rebuild_every=SHARD_REBUILD)
    far_stats()
    h, o = fn(h, o, im, ec, consts, tb.UserInput())
    return interiors(h, w_loc, hot.device), far_stats()


def run_sharded_bench(dev, card: str, bench_rate: float) -> dict:
    """The bench scene far-armed in 2 slabs (``fused_spatial2``, the bench
    far spec, a rebuild every 8 substeps: K1 on each slab every substep,
    K2 on each slab every rebuild): frames 1-2 warm, frames 3-10 timed and
    counted; a finite state, far_overflow 0 and far pairs.  Then one frame
    from the single-device ``fused_frame4``'s frame 9 in 1 and in 2 slabs
    against its own frame 10."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    ff = _far_spec(spacing)
    uin = tb.UserInput()
    mesh = _shard_mesh(dev, 2)
    h, o, im, ec, w_loc = pack_lattice2_sharded(state, 2,
                                                ghost=ghost_width(spec, ff))
    h, o, im = shard_stacks2(h, o, im, mesh)
    fn = fused_spatial2_frame_fn(spec, cfg, mesh, ffspec=ff,
                                 rebuild_every=SHARD_REBUILD)
    box = [(h, o)]

    def step():
        box[0] = fn(*box[0], im, ec, consts, uin)

    warm, timed = SHARD_BENCH
    for _ in range(warm):
        step()
    far_stats()
    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    ms = _frames(step, timed)
    k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
    stats = far_stats()
    substeps = timed * cfg.subticks
    rebuilds = substeps // SHARD_REBUILD
    hot = interiors(box[0][0], w_loc, dev)
    if not bool(torch.isfinite(hot[:6]).all()):
        raise AssertionError("bench in slabs: non-finite particle state")
    if k1 != 2 * substeps or k2 != 2 * rebuilds or \
            stats["rebuilds"] != rebuilds:
        raise AssertionError(f"bench in slabs: K1 {k1}, K2 {k2} launches, "
                             f"far record {stats}, for {substeps} substeps "
                             f"and {rebuilds} rebuilds on 2 slabs")
    if stats["max_overflow"] != 0 or stats["max_pairs"] == 0:
        raise AssertionError(f"bench in slabs: far record {stats}")
    fn_s = fused_spatial2_frame_fn(spec, _short(cfg), mesh, ffspec=ff,
                                   rebuild_every=SHARD_REBUILD)
    idle, per = _idle_and_launches(
        lambda: fn_s(box[0][0], box[0][1], im, ec, consts, uin),
        SHARD_PROFILE_SUBSTEPS)
    far_stats()
    rate = substeps / (sum(ms) / 1e3)

    # parity on one frame: frame 9 of the single-device fused_frame4
    hot1, obs1, imm1, ec1 = pack_lattice2(state)
    one = [(hot1, obs1)]

    def step_one():
        h_, o_, _st = fused_frame4(*one[0], imm1, ec1, consts, uin, spec,
                                   cfg, ff, buckets=FAR_BUCKETS)
        one[0] = (h_, o_)

    ms_one = _frames(step_one, SHARD_PARITY_FRAME)
    hot9, obs9 = one[0]
    step_one()
    ref10 = one[0][0]
    got = {n: _bench_sharded_frame(hot9, obs9, spec, cfg, consts, ff, n,
                                   state) for n in (1, 2)}
    errs = {}
    for n, (g, st) in got.items():
        if not bool(torch.isfinite(g[:6]).all()) or st["max_overflow"]:
            raise AssertionError(f"bench frame 10 in {n} slab(s): far "
                                 f"record {st}")
        errs[n] = _bench_errs(g, ref10)
        if not _within_bench_atol(errs[n]):
            raise AssertionError(f"bench frame 10 in {n} slab(s) against "
                                 f"fused_frame4: max |err| {errs[n]} "
                                 f"(limits {SHARD_BENCH_ATOL})")
    # the control: the same frame in 2 slabs with the far field off
    ctl = _bench_errs(_bench_sharded_frame(hot9, obs9, spec, cfg, consts,
                                           None, 2, state)[0], ref10)
    if _within_bench_atol(ctl):
        raise AssertionError(f"bench frame 10 in 2 slabs with the far field "
                             f"off is within the limits {SHARD_BENCH_ATOL} "
                             f"(max |err| {ctl}): they cannot tell a "
                             "dropped far apply")
    same_1_2 = not _tensors_differ([("hot", got[1][0], got[2][0])])
    rate_one = SHARD_PARITY_FRAME * cfg.subticks / (sum(ms_one) / 1e3)
    _log_sharded(
        f"bench scene far-armed in 2 slabs (frames 3-{warm + timed}, K1 "
        f"{k1} launches = 2 per substep, K2 {k2} = 2 per rebuild, far "
        f"record {stats})", rate, rate_one, idle, per, card,
        extra=f"; the bench path (phase 6) {bench_rate:.1f} substeps/s; "
        f"frame {SHARD_PARITY_FRAME + 1} from fused_frame4's frame "
        f"{SHARD_PARITY_FRAME} against its own: 1 slab {errs[1]}, 2 slabs "
        f"{errs[2]} (limits {SHARD_BENCH_ATOL}), the control with the far "
        f"field off {ctl}; 1 and 2 slabs "
        f"{'bit-identical' if same_1_2 else 'not bit-identical'}")
    return dict(k1=k1, k2=k2, rate=rate, rate_one=rate_one, errs=errs,
                ctl=ctl, same_1_2=same_1_2, stats=stats)


def _bench_errs(g, ref) -> dict:
    """Max |difference| of two hot stacks in position and velocity, and
    the count of edges alive in one and not the other."""
    errs = {k: (g[sl] - ref[sl]).abs().max().item()
            for k, sl in (("pos", slice(0, 2)), ("vel", slice(2, 4)))}
    errs["edges alive differ"] = sum(
        int(((g[6 + 3 * c + 2] > 0) != (ref[6 + 3 * c + 2] > 0)).sum())
        for c in range(4))
    return errs


def _within_bench_atol(errs: dict) -> bool:
    return all(errs[k] <= lim for k, lim in SHARD_BENCH_ATOL.items())


def _general_errs(got, ref) -> dict:
    g, r = sim_state_to_numpy(got), sim_state_to_numpy(ref)
    errs = {k: float(np.abs(g[k] - r[k]).max()) for k in GENERAL_ATOL}
    errs["beams alive differ"] = int((g["beam_alive"]
                                      != r["beam_alive"]).sum())
    return errs


def _hold_general(label: str, errs: dict) -> None:
    if (any(not errs[k] <= GENERAL_ATOL[k] for k in GENERAL_ATOL)
            or errs["beams alive differ"]):
        raise AssertionError(f"{label}: max |err| {errs} against the "
                             f"single-device frame (limits {GENERAL_ATOL}, "
                             "beams alive equal)")


def _stirred_world(st, seed: int):
    """``st`` with velocity noise from ``seed`` (worlds of a batch
    differ)."""
    g = torch.Generator(device=st.pos.device).manual_seed(seed)
    return dataclasses.replace(st, vel=st.vel + torch.randn(
        st.vel.shape, generator=g, device=st.pos.device) * 5.0)


def run_sharded_general(dev, card: str) -> dict:
    """The general engine sharded: config 3 (the 100k self-colliding
    cloth, grid) over sp = 4, one frame against the single-device frame;
    config 1 ``cloth(32, 32)`` × 2 worlds over a 2×4 dp×sp mesh; and
    ``batched_frame_fn`` on ``multi_blob(64)`` × 4 worlds over dp = 4,
    each world bit for bit its own single-device frame."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    st, cfg = scenes.self_colliding_cloth(SHARD_GENERAL_N, device=dev)
    st = pad_state_for_mesh(st, 4)
    one = [st]

    def step_one():
        one[0] = gstep.frame(one[0], consts, uin, cfg)

    ms_one = _frames(step_one, 1)
    mesh = _shard_mesh(dev, 4)
    fn = spatial_frame_fn(cfg, mesh)
    box = [shard_state(st, mesh)]

    def step():
        box[0] = fn(box[0], consts, uin)

    ms = _frames(step, 1)
    errs3 = _general_errs(unshard_state(box[0]), one[0])
    _hold_general("config 3 over sp = 4", errs3)
    fn_s = spatial_frame_fn(_short(cfg), mesh)
    idle, per = _idle_and_launches(lambda: fn_s(box[0], consts, uin),
                                   SHARD_PROFILE_SUBSTEPS)
    rate = cfg.subticks / (sum(ms) / 1e3)
    rate_one = cfg.subticks / (sum(ms_one) / 1e3)

    # config 1 x 2 worlds over dp x sp = 2 x 4
    w1, cfg1 = scenes.cloth(32, 32, device=dev)
    worlds = [pad_state_for_mesh(w, 4) for w in (w1, _stirred_world(w1, 1))]
    mesh8 = _shard_mesh(dev, 8, dp=2)
    out = unstack_states(unshard_state(spatial_frame_fn(
        cfg1, mesh8, dp_axis="dp")(shard_state(stack_states(worlds), mesh8,
                                               dp_axis="dp"), consts, uin)))
    errs1 = [_general_errs(g, gstep.frame(w, consts, uin, cfg1))
             for g, w in zip(out, worlds)]
    for e in errs1:
        _hold_general("config 1 x 2 worlds over 2x4", e)

    # multi_blob(64) x 4 worlds over dp = 4
    w4, cfg4 = scenes.multi_blob(64, device=dev)
    worlds4 = [_stirred_world(w4, s) for s in range(4)]
    mesh4 = _shard_mesh(dev, 4, dp=4)
    t0 = time.perf_counter()
    outs = unstack_states(batched_frame_fn(cfg4, mesh4)(
        device_put_batched(stack_states(worlds4), mesh4), consts, uin))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(outs, worlds4)):
        r = gstep.frame(w, consts, uin, cfg4)
        diff = _tensors_differ([(k, getattr(g, k), getattr(r, k)) for k in
                                ("pos", "vel", "acc", "beam_alive",
                                 "beam_target_length")])
        if diff:
            raise AssertionError(f"multi_blob(64) world {i} of the batch "
                                 f"differs from its own frame: {diff}")
    _log_sharded(
        f"general engine config 3 over sp = 4 (one frame, max |err| "
        f"{errs3} against the single-device frame)", rate, rate_one, idle,
        per, card, extra=f"; config 1 x 2 worlds over dp x sp = 2x4: max "
        f"|err| {errs1}; multi_blob(64) x 4 worlds over dp = 4: each world "
        f"equal to its own frame bit for bit, "
        f"{4 * cfg4.subticks / batch_s:.1f} substeps/s over the batch "
        "(host clock)")
    return dict(rate=rate, rate_one=rate_one)


def run_sharded_dryrun(dev, card: str) -> dict:
    """The JAX package's multi-chip dryrun (``__graft_entry__.py:93-206``)
    at its tiny shapes on an 8-shard mesh, each path against its
    single-device port path: the general engine over dp×sp = 2×4, the
    lattice halo exchange, K4 in slabs, and K1 in slabs with the far
    field (rebuild every 2 substeps) on a strip folded across every slab
    boundary, where the dryrun's flat cloth has no far pair."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    n, dp = 8, 2
    sp = n // dp
    cfg = tb.StaticConfig(subticks=4, collision_mode="grid",
                          particle_radius=8.0, force_mode="quantized")
    # the dryrun's batch: dp copies of the 6 x 6 cloth
    worlds = [pad_state_for_mesh(scenes.cloth(w=6, h=6, spacing=20.0,
                                              device=dev)[0], sp)
              for _ in range(dp)]
    mesh = _shard_mesh(dev, n, dp=dp)
    fn = spatial_frame_fn(cfg, mesh, dp_axis="dp")
    sh = shard_state(stack_states(worlds), mesh, dp_axis="dp")
    ms = _frames(lambda: fn(sh, consts, uin), 1)
    out = unstack_states(unshard_state(fn(sh, consts, uin)))
    ms_one = _frames(lambda: gstep.frame(worlds[0], consts, uin, cfg), 1)
    errs = [_general_errs(g, gstep.frame(w, consts, uin, cfg))
            for g, w in zip(out, worlds)]
    for e in errs:
        _hold_general("dryrun general dp x sp", e)
    idle, per = _idle_and_launches(lambda: fn(sh, consts, uin),
                                   cfg.subticks * dp)
    rate = dp * cfg.subticks / (sum(ms) / 1e3)
    rate_one = cfg.subticks / (sum(ms_one) / 1e3)

    lat = tb.StaticConfig(subticks=4, particle_radius=5.0)
    w, h = 8 * n, 8
    ls, _, _ = cloth_lattice(w=w, h=h, spacing=12.0, device=dev)
    spec = LatticeSpec(w, h, collision_stencil=2)
    lmesh = _shard_mesh(dev, n)
    got = unshard_lattice(lattice_spatial_frame_fn(spec, lat, lmesh)(
        shard_lattice(ls, lmesh), consts, uin))
    diff = _tensors_differ(_lattice_pairs(
        got, lattice_frame(ls, consts, uin, spec, lat)))
    if diff:
        raise AssertionError(f"dryrun lattice halo exchange: {diff}")

    mut, immut = pack_lattice(ls)
    m, im, w_loc = pack_lattice_sharded(ls, n, ghost=ghost_width(spec))
    m, im = shard_stacks(m, im, lmesh)
    got4 = interiors(fused_spatial_frame_fn(spec, lat, lmesh)(
        m, im, consts, uin), w_loc, dev)
    diff = _tensors_differ([("mut", got4, fused_frame(
        mut, immut, consts, uin, spec, lat))])
    if diff:
        raise AssertionError(f"dryrun K4 in slabs: {diff}")

    # the dryrun's far spec on the strip folded at its shape (its flat
    # cloth gives the far field no pair): contacts across every boundary,
    # more candidates than the dryrun's list of 64 holds, so 128
    ff = FarFieldSpec(skin=8.0, horizon=4, max_pairs=128, max_tile_pairs=32)
    ls = folded_strip_lattice(w, h, device=dev)
    h2, o2, i2, ec, w_loc2 = pack_lattice2_sharded(
        ls, n, ghost=ghost_width(spec, ff))
    h2, o2, i2 = shard_stacks2(h2, o2, i2, lmesh)
    far_stats()
    h2, o2 = fused_spatial2_frame_fn(spec, lat, lmesh, ffspec=ff,
                                     rebuild_every=2)(h2, o2, i2, ec,
                                                      consts, uin)
    rec = far_stats()
    hot, obs, imm, ec1 = pack_lattice2(ls)
    ref, _o, _st = fused_frame4(hot, obs, imm, ec1, consts, uin, spec, lat,
                                ff)
    got2 = interiors(h2, w_loc2, dev)
    e2 = {k: (got2[sl] - ref[sl]).abs().max().item()
          for k, sl in (("pos", slice(0, 2)), ("vel", slice(2, 4)))}
    if (rec["rebuilds"] != 2 or rec["max_overflow"] or not rec["max_pairs"]
            or any(not e2[k] <= SHARD_BENCH_ATOL[k] for k in e2)):
        raise AssertionError(f"dryrun K1 in slabs with the far field: far "
                             f"record {rec}, max |err| {e2} against "
                             f"fused_frame4 (limits {SHARD_BENCH_ATOL})")
    exact2 = not _tensors_differ([("hot", got2, ref)])
    # the control: the fold in slabs with the far field off
    h0, o0, i0, ec0, _ = pack_lattice2_sharded(ls, n,
                                               ghost=ghost_width(spec))
    h0, o0, i0 = shard_stacks2(h0, o0, i0, lmesh)
    ctl = interiors(fused_spatial2_frame_fn(spec, lat, lmesh)(
        h0, o0, i0, ec0, consts, uin)[0], w_loc2, dev)
    e_ctl = {k: (ctl[sl] - ref[sl]).abs().max().item()
             for k, sl in (("pos", slice(0, 2)), ("vel", slice(2, 4)))}
    if all(e_ctl[k] <= SHARD_BENCH_ATOL[k] for k in e_ctl):
        raise AssertionError(f"dryrun fold with the far field off is within "
                             f"the limits {SHARD_BENCH_ATOL} (max |err| "
                             f"{e_ctl}): they cannot tell a dropped far "
                             "apply")
    _log_sharded(
        f"dryrun paths on 8 shards (general dp x sp = 2x4 max |err| "
        f"{errs}; lattice halo and K4 in slabs equal to one device bit for "
        f"bit; K1 in slabs with the far field on the folded strip: far "
        f"record {rec}, max |err| {e2} against fused_frame4, "
        f"{'bit-identical' if exact2 else 'not bit-identical'}; the "
        f"control with the far field off {e_ctl})", rate,
        rate_one, idle, per, card, extra=" (rates of the general dp x sp "
        "frame, both worlds, against one world's single-device frame)")
    return dict(rate=rate)


def run_sharded(dev, card: str, bench_rate: float) -> dict:
    """Phase 14: the sharded paths at full width, every shard on this
    card; the launches of K3, K4, K1 and K2 in sub-phases 1-3."""
    t = [time.perf_counter()]

    def lap():
        t.append(time.perf_counter())
        return round(t[-1] - t[-2], 1)

    a = run_sharded_path_a(dev, card)
    parts = {"path A": lap()}
    b = run_sharded_path_b(dev, card)
    parts["path B"] = lap()
    bench = run_sharded_bench(dev, card, bench_rate)
    parts["bench"] = lap()
    run_sharded_general(dev, card)
    parts["general"] = lap()
    run_sharded_dryrun(dev, card)
    parts["dryrun"] = lap()
    log(f"phase 14 parallel: {t[-1] - t[0]:.1f} s ({parts})")
    return {"K1": bench["k1"], "K2": bench["k2"], "K3": a["k3"],
            "K4": b["k4"]}


def _occupancy() -> None:
    """K1's, K4's and K3's residency per SM at the stencil radii they are
    held at, and K2's (registers, spills and shared memory from the
    loaded kernels)."""
    for k, kernel, stencils in (("K1", "fused_substep2", K14_STENCILS),
                                ("K4", "fused_substep", K14_STENCILS),
                                ("K3", "collide_stencil", K3_STENCILS),
                                ("K2", "band_flags", (2,))):
        occ = {s: _lib.occupancy(kernel, s) for s in stencils}
        log(f"  {k} residency by stencil: " + "; ".join(
            f"s={s} {o['blocks_per_sm']} blocks/SM of "
            f"{o['threads']} threads, {o['registers']} registers, "
            f"{o['local_bytes']} B local, {o['smem_bytes']} B shared"
            for s, o in occ.items()))


def _log_compare(compare: dict, card: str) -> None:
    """The parent's and this tree's kernel times from ``_turns``."""
    for k, ms in compare.items():
        p, c = ms["parent"], ms["this"]
        log(f"parent vs this tree, {k}: device ms parent {p[0]:.4f}, this "
            f"{c[0]:.4f}, this {c[1]:.4f}, parent {p[1]:.4f} (means "
            f"{sum(p) / 2:.4f} / {sum(c) / 2:.4f}, ratio "
            f"{sum(p) / sum(c):.3f}) on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout of this repo: its K1, "
                    "K2, K3 and K4 are built from its csrc/ and timed "
                    "beside this tree's, in turns, on the same inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on the card", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    card = _card()
    log(card)

    # phase 1: build
    path, secs, report = _lib.build()
    _lib.library()
    log(f"phase 1 build: {path.name} in {secs:.1f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line or "properties" in line:
            log(f"  ptxas: {line.strip()}")
    _occupancy()
    parent = None
    if args.parent is not None:
        ppath, psecs, preport = _lib.build(args.parent /
                                           "softbody_tpu_torch" / "csrc")
        parent = _lib.bind(ppath)
        log(f"parent kernels from {args.parent}: {ppath.name} in "
            f"{psecs:.1f} s")
        for line in preport.splitlines():
            if "Used" in line or "spill" in line or "properties" in line:
                log(f"  parent ptxas: {line.strip()}")

    # phases 2-3: kernels against their plain versions: K2 at 64x64 and
    # 1M (and at the bench final state, phase 7), K3 at 64x64, 1M and
    # K3_RAGGED, K1 and K4 at K14_SHAPES
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    scenes_1m = {}
    for n in (64 * 64, N_PARTICLES):
        state, spec, cfg, consts, spacing = _scene(n, dev)
        scenes_1m[n] = (state, spec, cfg, consts, spacing)
        label = f"{spec.width}x{spec.height}"
        errs["K2"] = max(errs["K2"], check_k2(label, state, spec, cfg,
                                              spacing))
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        errs["K3"] = max(errs["K3"], check_k3(
            label, _stirred(state, spacing, SEED + 2), cfg, consts, g))
    st, cfg_r, consts_r, g = _k14_state(*K3_RAGGED, dev, SEED + 4)
    errs["K3"] = max(errs["K3"], check_k3(
        "{}x{}".format(*K3_RAGGED), st, cfg_r, consts_r, g))
    for w, h in K14_SHAPES:
        errs["K1"] = max(errs["K1"], check_k1(w, h, dev))
        errs["K4"] = max(errs["K4"], check_k4(w, h, dev))
    log("phases 2-3 kernels vs plain: ok")

    # phase 4: the probe (K5-K7 at the probe's and the 1M sizes)
    probe = run_probe(dev)
    errs.update(probe["errs"])

    # phase 5: small end-to-end against the plain versions on the CPU
    check_small_fold()

    # phase 6: the bench path at full size
    state, spec, cfg, consts, spacing = scenes_1m[N_PARTICLES]
    run = run_main_path(state, spec, cfg, consts, spacing)
    del scenes_1m

    # phase 7: times at the bench path's final state, kernels against
    # their plain versions
    t, bounds = time_at_final_state(run, spec, cfg, consts, parent)
    del run["be"], run["packed"]
    t.update(probe["t"])
    bounds.update(probe["bounds"])

    # phases 8-9: paths A and B at full size, then K3 and K4 timed at
    # their final states
    run_a = run_path_a(dev)
    run_b = run_path_b(dev)
    t_ab, bounds_ab = time_paths_kernels(run_a, run_b, parent)
    t_ab["compare"] = {**t["compare"], **t_ab["compare"]}
    t.update(t_ab)
    bounds.update(bounds_ab)
    run_a_k3, rate_a = run_a["k3"], run_a["rate"]
    run_b_k4, rate_b = run_b["k4"], run_b["rate"]
    del run_a, run_b

    # phase 10: the general gather engine (configs 1, 4, 3)
    check_general_config1_cpu(dev)
    general = run_general(dev)

    # phase 11: the runtime, the engines a user drives, at full size
    # (each with the launch counts of its kernels from 0), then K2 past
    # chunk 4 and K1/K4 under constants that forbid their skip
    t11 = time.perf_counter()
    runtime = run_runtime_fused(dev, card)
    run_runtime_dense(dev)
    run_runtime_general(dev)
    check_wide_k2_and_skip_flag(dev)
    log(f"phase 11 runtime: {time.perf_counter() - t11:.1f} s")

    # phase 12: the planified general-topology path at full size (config
    # 3 far-armed with K3, K2 and K7, each counted from 0 over its timed
    # frames; the directed engine from the same settled state), config 4
    # behind the engine and card vs CPU, the fold through both far-apply
    # routes, and the activation schedule on the bench scene
    t12 = [time.perf_counter()]

    def lap():
        t12.append(time.perf_counter())
        return round(t12[-1] - t12[-2], 1)

    plan = run_planified_config3(dev, card)
    parts = {"config 3": lap()}
    run_planified_engine(dev, card)
    parts["config 4 engine"] = lap()
    check_planified_config4_cpu(dev)
    parts["config 4 vs cpu"] = lap()
    check_planified_fold(dev)
    parts["fold"] = lap()
    act = run_fused_activation(dev, run["rate"], card)
    parts["activation"] = lap()
    log(f"phase 12 planified: {t12[-1] - t12[0]:.1f} s ({parts})")

    # phase 13: the CLI's verbs at full size (K2 and K7 counted from 0 in
    # each), the editor, the renderer and the far apply's fixed order
    t13 = time.perf_counter()
    launches_cli = run_cli(dev, card)
    log(f"phase 13 cli: {time.perf_counter() - t13:.1f} s")

    # phase 14: the parallel layer at full width, every shard on this card
    # (K3, K4, K1 and K2 counted from 0 in sub-phases 1-3)
    launches_sharded = run_sharded(dev, card, run["rate"])

    pallas = "softbody_tpu/ops/pallas/"
    probe_src = "scripts/probe_recmirror.py"
    rows = (
        ("K1", "fused_substep2", "fused_substep2", pallas +
         "fused_substep2.py:195", run["k1"]),
        ("K2", "band_detect", "band_detect", pallas + "band_detect.py:65",
         run["k2"]),
        ("K3", "collide_stencil", "collide_stencil", pallas +
         "collide_stencil.py:41", run_a_k3),
        ("K4", "fused_substep", "fused_substep", pallas +
         "fused_substep.py:80", run_b_k4),
        ("K5", "cast_rows", "recmirror", probe_src + ":48",
         probe["launches"]["K5"]),
        ("K6", "uncast_rows", "recmirror", probe_src + ":68",
         probe["launches"]["K6"]),
        ("K7", "mirror_records", "recmirror", probe_src + ":92", run["k7"]),
    )
    kernels = [
        {"name": f"{k} {name}", "route": "cuda",
         "source": f"softbody_tpu_torch/csrc/{src}.cu", "replaces": tpu,
         "launches": launches, "max_abs_err": errs[k], "ms": t[k],
         "plain_ms": t[f"{k} plain"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": t.get(f"{k} library")}
        for k, name, src, tpu, launches in rows
    ]
    for row in kernels:
        k = row["name"].split()[0]
        if k in ("K2", "K3", "K7"):
            row["launches_planified"] = plan[k.lower()]
        if k in ("K2", "K7"):
            row["launches_cli"] = launches_cli[k]
        if k in launches_sharded:
            row["launches_sharded"] = launches_sharded[k]
    log(f"path A rate: {rate_a:.1f} substeps/s, path B rate: "
        f"{rate_b:.1f} substeps/s on {card}")
    log(f"bench path rate: {run['rate']:.1f} substeps/s; far apply at its "
        f"final state (fixed-order scatter): device "
        f"{t.get('apply device', float('nan')):.4f} ms per substep, "
        f"host-paced {t.get('apply', float('nan')):.4f} ms on {card}")
    log(f"planified config 3: {plan['rate']:.1f} substeps/s (general engine "
        f"at config 3: {dict(general).get(GENERAL_CONFIGS[2][0], 0.0):.1f}; "
        f"directed: {plan['directed_rate']:.1f}); K3 on its "
        f"{plan['t']['K3']:.4f} ms (bound {plan['bounds']['K3'][0]:.4f}), K2 "
        f"{plan['t']['K2']:.4f} ms (bound {plan['bounds']['K2'][0]:.4f}); "
        f"fused backend with far_activation {act['rate']:.1f} substeps/s "
        f"(without it, the same frames: {act['rate_off']:.1f}) "
        f"on {card}")
    log(f"K1 at stencil 0 {t['K1 s0']:.4f} ms (stencil 2 {t['K1']:.4f}), "
        f"K4 at stencil 0 {t['K4 s0']:.4f} ms (stencil 2 {t['K4']:.4f}) "
        f"on {card}")
    _log_compare(t["compare"], card)
    log(f"runtime: fused engine 1M {runtime['fps_alone']:.3f} frames/s "
        f"alone, {runtime['fps_polled']:.3f} polled; packet latency median "
        f"{runtime['lat_median']:.1f} ms, max {runtime['lat_max']:.1f} ms; "
        f"L1 snapshot {runtime['snapshot_mb']:.1f} MB save "
        f"{runtime['save_ms']:.1f} ms, load {runtime['load_ms']:.1f} ms on "
        f"{card}")
    log("general path rates: " + ", ".join(f"{k} {v:.1f} substeps/s"
                                           for k, v in general)
        + f" on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
