#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Builds the hand-written kernels from ``softbody_tpu_torch/csrc``, holds
each against its plain torch version on the card, drives the port's
paths at full size, checks the results, and times the kernels against
their plain versions.  The paths, each with the kernel launch counts set
to 0 just before it and read just after:

- the bench path: the 1M-particle tearing cloth with far-field
  self-collision through ``FusedLatticeBackend`` with its default kernel
  variants, bench.py's (K1 in its rsqrt+rollgroup instance, K2, K8),
  timed in turns with the same backend strict (``kernel_variants=()``,
  K1 strict); K1's four instances held against their plain versions;
- path A: the dense ``LatticeBackend`` with ``use_pallas`` on the 1M
  tearing cloth with default arguments and far field armed with
  ``FarFieldSpec()`` (``play --path lattice --farfield``; K3, K2);
- path B: the per-edge fused frame on the same scene, bench.py's
  ``BENCH_PATH=fused_v1`` (K4): ``fused_frame_jit`` (one captured graph
  a frame) in turns with ``fused_frame``, bit for bit, and one far-armed
  frame (``fused_frame_far_jit``);
- the probe of ``scripts/probe_recmirror.py``: the record casts (K5, K6)
  and the mirror table (K7) at the probe's and the bench path's sizes,
  K7 also at JAX's ``far_mb`` = 128 lane block (the bench path's far
  applies take K8, its pair step, which is held bit for bit against its
  plain versions and timed at the bench path's final state);
- the general gather engine (``ops/step.frame``, no kernel of its own) at
  BASELINE configs 1, 4 and 3: the 32×32 cloth, 64 blobs and the 100k
  self-colliding cloth;
- the runtime, as a user drives it: ``LatticeEngine(fused=True)`` on the
  bench scene stepping on its worker thread while this thread polls
  render packets (K1, K2, K8), its L1 snapshot round trip, fault
  injection and re-creation; ``LatticeEngine`` on path A (K3); ``Engine``
  on the general path;
- the planified general-topology path (phase 12): BASELINE config 3, the
  100k self-colliding cloth, embedded into planes by ``PlanifiedBackend``
  and stepped far-armed with ``use_pallas`` through its captured frames
  (K3 every substep, K2 every rebuild, K8 in every far apply with active
  pairs), then in turns with its eager twin, bit for bit; config 4
  planified likewise, then behind ``Engine``; the small fold through both far-apply routes, card
  against CPU; ``FusedLatticeBackend(far_activation=True)`` on the bench
  scene (K1, K2, K8); the directed-CSR engine at config 3;
- the fused backend's other far modes (phase 15): K1's trig, detect and
  knobs instances held against their plain versions; the bench scene
  through ``FusedLatticeBackend(far_detect="kernel")`` (K1 with its
  detect instance, K2, K8) in turns with xla detection, and in the
  triggered mode ``far_mode="v3"`` (K1's trig instances); the detect
  and trig instances timed at those runs' final states against their
  bounds, with their loss a frame (beside ``--parent``'s, in turns); the
  knobs on one far-off frame each; the fold card against CPU;
- the compiled frames (phase 16): ``frame_jit`` at configs 1, 4 and 3,
  a mouse drag (one capture), two states through one graph, path A
  through ``LatticeBackend``'s captured chunks (K3), the fold through
  ``lattice_frame_far_jit``, the compiled ``directed_frame`` at config 3,
  each held bit for bit against the same frames run op by op and timed
  in turns with them; ``Engine`` and ``LatticeEngine`` (path A) stepping
  captured frames on their worker threads while this thread polls;
- the compiled fused frames (phase 17): ``FusedLatticeBackend`` on the
  bench scene (its default variants and strict, kernel detection, v3)
  stepping whole-frame CUDA graphs whose far-apply bucket, rebuild
  trigger and K1 instance are IF nodes decided on the card
  (``fused_frame4_jit``, ``fused_frame3_auto_jit``), each in turns with
  its eager twin over frames 3-10: every frame and its stats bit for
  bit, launches equal, no host read in a frame, the first call's time
  and memory, the idle share; ``LatticeEngine(fused=True)`` alone and
  polled;
- the constants and the user input as device buffers (phase 18): K1's,
  K4's and K3's device-constants entries (the frames' route) bit for
  bit against their by-value entries at 1M and the edge shapes, at drag
  exponents 1.5, 2 and 3.3 and with the clip overflowing, their
  registers and local bytes, their device ms in turns; a mouse drag at
  1M through ``FusedLatticeBackend`` (one capture, the first frames bit
  for bit against an eager twin) and through ``LatticeEngine(fused=True)``
  fed ``Engine.mouse`` each frame, each against a twin left alone over
  the same frames;
- the parallel layer (phase 14), every shard on this card: path A and
  path B in 4 slabs, the bench scene far-armed in 2 slabs (K1, K2), the
  general engine's config 3 over sp = 4, config 1 × 2 over dp × sp =
  2 × 4, ``multi_blob(64)`` × 4 over dp = 4, each step a captured CUDA
  graph held bit for bit and launch for launch against its eager twin in
  turns (one capture, no host read); the bench scene's frame 10 with
  ``far_mb=128`` (K7 at 128 lanes); the JAX dryrun's paths;
- the CLI (phase 13), as a user first runs it, in this process:
  ``run`` of the 1M tearing cloth on the lattice path and of the 100k
  cloth planified and far-armed (K2, K8), ``render`` of the 1M cloth,
  ``play`` headless of the 1M cloth far-armed (K2) and of the default
  scene, ``snapshot create``/``info`` of the 1M scene, the editor; the
  renderer and the far apply's fixed order held card against CPU.

Every phase raises on failure.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: also build the kernels of the checkout at DIR (another
commit of this repo) and time its K1 (with its detect and trig
instances), K2, K3 and K4 beside this tree's, in turns, on the same
inputs.

Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, default
``/usr/local/cuda``); refuses to run without a device.  The last line
of standard output is one JSON object naming the device; the line
before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
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
from softbody_tpu_torch.config import N_CONSTS
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
from softbody_tpu_torch.ops import compiled, farfield4
from softbody_tpu_torch.ops import planify
from softbody_tpu_torch.ops import step as gstep
from softbody_tpu_torch.ops.collisions import broad_phase_overflow
from softbody_tpu_torch.ops.cuda import (
    _lib,
    band_detect,
    collide_stencil,
    far_apply,
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
    fused_frame_far_jit,
    fused_frame_jit,
    fused_substep_call,
    fused_substep_plain,
    pack_lattice,
    packed_far_motion,
    packed_far_motion_jit,
    rebuild_far_list_packed,
)
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    PX,
    PY,
    VX,
    VY,
    X_TBAND,
    X_VBX,
    X_VBY,
    fused_frame2_auto,
    fused_frame2_far,
    fused_frame4,
    fused_substep2_call,
    fused_substep2_plain,
    pack_lattice2,
    rebuild_far_list_packed2,
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
    empty_far_list,
    far_collision_terms,
    rebuild_far_list,
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
    host_decisions,
    lattice_frame,
    lattice_frame_far,
    lattice_frame_far_jit,
    lattice_frame_jit,
    lattice_substep_jit,
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
# the bench far field's 16384, and the engine stepping captured frames
# runs past the windows into them (~16 frames): ``far_overflow`` 0 is
# held over the reads up to RUNTIME_HELD_FRAMES, the later ones logged
RUNTIME_FRAMES = 2
RUNTIME_HELD_FRAMES = 12

# K4 against its plain version: edge planes bit-exact, particle planes
# within the port's parity tolerances (tests/test_torch_substep.py); K1
# (each instance) bit-exact in every plane; K2's flags and K3's deltas
# bit-exact (K3: NaN where the plain version has NaN)
K4_ATOL = {"pos": 1e-4, "vel": 1e-3, "acc": 1e-2}
# K1's instances (rsqrt, rollgroup flags) by name (fused_substep2.
# k1_instance), and the JAX kernel's own tolerance between its variants
# and strict (tests/test_fused2.py:217), for the bench frame and the
# small fold
K1_INSTANCES = {"strict": (False, False), "rsqrt": (True, False),
                "rollgroup": (False, True), "rsqrt+rollgroup": (True, True)}
VARIANT_ATOL = {"pos": 5e-2, "vel": 2e-1}
VARIANT_SUBSTEPS = 4
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
# own frame 10; each step captured, then in turns with its eager twin
# (SHARD_TURN_FRAMES).  That frame
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
# each sharded step (captured: one CUDA graph a frame, every shard on this
# card) in turns with its eager twin (eager, captured, captured, eager),
# frames per turn: the eager twins of path A and the general engine's
# take seconds a frame (and launch 10^5 kernels or more: those profile a
# twin of SHARD_PROFILE_SUBSTEPS substeps a frame)
SHARD_TURN_FRAMES = {"path A": 1, "path B": 4, "bench": 2, "config 3": 1,
                     "config 1": 1, "multi_blob": 1}
# the probe's K7 at JAX's far_mb lane block, and the far apply's lane
# block of the bench scene's frame 10 in phase 14
PROBE_MB = 128

# the far modes phase (15): K1's mode instances held against their plain
# versions at these shapes (the trig sums within TRIG_SUM_RTOL of the sum
# of |v|: their order differs); the bench scene with kernel detection and
# xla detection in turns (frames 3-10, as phase 6), and frame 10 of both
# from one frame 9 (the first VARIANT_SUBSTEPS substeps within
# VARIANT_ATOL); the bench scene in the triggered mode with bench.py's v3
# far field (bench.py:108-112: 512 pairs, 256 tile pairs, skin 1.5
# spacings, horizon 32), frames 3-10; the knobs' instances (not physics)
# on one frame of the bench scene without far field, as
# scripts/bench_sweep.py's nf_nospring / nf_void / nf_pipe run them
K1_MODE_SHAPES = ((1000, 1000), (97, 61))
TRIG_SUM_RTOL = 1e-5
V3_FF = dict(max_pairs=512, max_tile_pairs=256, horizon=32)
KNOB_RUNS = (("nospring", 2, ("nospring",)), ("void", 0, ("nospring",)),
             ("pipe", 0, ("nospring", "noint")))

# the compiled frames (phase 16): frames per turn (eager, captured,
# captured, eager) of configs 1, 4 and 3; the drag's frames, each with a
# new mouse position and velocity; path A's frames held card-captured
# against eager, then timed a frame a turn; the runtime's windows (alone,
# polled, polled, alone) behind Engine and behind LatticeEngine on path A
# (from frame 1; the worker runs frames ahead of the packets, into the
# frames where the default far field's 512 pairs overflow: its stats are
# logged, not held)
COMPILED_TURN_FRAMES = (2, 2, 1)
DRAG_FRAMES = 4
# phase 18: the drag at 1M (frames dragged, of which the first are held
# bit for bit against an eager twin; a twin left alone runs the same
# frames), and the drag exponents K1's and K4's device-constants entries
# are held at (1.5 and 3.3 take powf, 2 its fast path)
DRAG_1M_FRAMES = 30
DRAG_1M_HELD = 6
DEVC_DRAG_EXPS = (1.5, 2.0, 3.3)
COMPILED_PATH_A_FRAMES = 2
COMPILED_RUNTIME_FRAMES = {"general": 5, "path A": 1}
# the compiled fused frames (phase 17): frames per turn (eager, captured,
# captured, eager) over frames 3-10 of each fused path
FUSED_TURN_FRAMES = 4

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


def _hold(label, got, ref):
    """``got`` against ``ref`` on the particle planes (pos, vel, acc): the
    max |err| of each, raising above K4_ATOL."""
    errs = {
        "pos": (got[0:2] - ref[0:2]).abs().max().item(),
        "vel": (got[2:4] - ref[2:4]).abs().max().item(),
        "acc": (got[4:6] - ref[4:6]).abs().max().item(),
    }
    for k, e in errs.items():
        if not e <= K4_ATOL[k]:
            raise AssertionError(f"{label}: {k} max |err| {e} > "
                                 f"{K4_ATOL[k]}")
    return errs


def check_k1(w: int, h: int, dev) -> dict:
    """K1's four instances (strict and the JAX kernel's arithmetic
    variants) against the plain version with the same flags on the card
    at ``w × h``, stencils K14_STENCILS, quantized and float forces, far
    stack off and on, hot and observing, the mouse grabbing: every plane
    bit for bit (the plain version's ``torch.rsqrt`` runs the card's
    ``rsqrtf``).  Returns the largest |err| per instance (0.0)."""
    state, cfg, consts, g = _k14_state(w, h, dev, SEED + w + h)
    hot, obs, immut, ec = pack_lattice2(state)
    uin = tb.UserInput(mouse_active=True, mouse_pos=(490.0, 510.0),
                       mouse_vel=(3.0, -1.0))
    cvec = torch.cat([tb.consts_vector(consts, uin, cfg, h), ec])
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    worst = {}
    for name, (rsqrt, rollgroup) in K1_INSTANCES.items():
        worst[name] = 0.0
        for s, quantized, with_far, observe in itertools.product(
                K14_STENCILS, (True, False), (False, True), (False, True)):
            kw = dict(stencil=s, quantized=quantized,
                      far=far if with_far else None,
                      obs_in=obs if observe else None,
                      rsqrt=rsqrt, rollgroup=rollgroup)
            ref = fused_substep2_plain(hot, immut, cvec, **kw)
            got = fused_substep2_call(hot, immut, cvec, **kw)
            torch.cuda.synchronize()
            pairs = zip(got, ref) if observe else ((got, ref),)
            for a, b in pairs:
                n_bad = int(_differs(a, b).sum())
                err = (a - b).abs().max().item()
                if n_bad:
                    raise AssertionError(
                        f"K1 {name} {w}x{h} s={s} quantized={quantized} "
                        f"far={with_far} observe={observe}: {n_bad} values "
                        f"differ from the plain version (max |err| {err})")
                worst[name] = max(worst[name], err)
    broke = int(((hot[8::3] > 0) & (ref[0][8::3] == 0)).sum())
    log(f"K1 {w}x{h}: {', '.join(K1_INSTANCES)} x stencils {K14_STENCILS}"
        f" x quantized/float x far on/off x observing on/off, the mouse "
        f"grabbing: every plane bit-exact against the plain version "
        f"({broke} edges broke in the last case)")
    return worst


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
    within K4_ATOL."""
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
        for k, e in _hold(label, got, ref).items():
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

    # K7 at JAX's far_mb lane block on the 1M apply grid: the same bytes
    # in records of 128 lanes
    planes, w_out, h_out, table = mirrors[-1]
    k7 = recmirror.K7_LAUNCHES
    wide = recmirror.mirror_records_call(planes, w_out=w_out, h_out=h_out,
                                         mb=PROBE_MB)
    torch.cuda.synchronize()
    if recmirror.K7_LAUNCHES != k7 + 1:
        raise AssertionError(f"probe: K7 at mb={PROBE_MB} launched "
                             f"{recmirror.K7_LAUNCHES - k7} times")
    hold("K7", f"{tuple(planes[0].shape)} -> [{w_out}, {h_out}] at mb="
         f"{PROBE_MB}", wide, recmirror.mirror_records_plain(
             planes, w_out=w_out, h_out=h_out, mb=PROBE_MB))
    log(f"probe: K7 at mb={PROBE_MB} bit-exact at {tuple(planes[0].shape)}"
        f" -> table {tuple(wide.shape)}")

    x, y, _ = casts[-1]
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
        f"K7 probe mb{PROBE_MB}": _device_ms(
            lambda: recmirror.mirror_records_call(
                planes, w_out=w_out, h_out=h_out, mb=PROBE_MB), 200),
    }
    n_cast = x.numel() * 4
    bounds = {"K5": _bound(2 * n_cast, 0), "K6": _bound(2 * n_cast, 0),
              "K7 probe": _mirror_bound(planes, table),
              f"K7 probe mb{PROBE_MB}": _mirror_bound(planes, wide)}
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


def _k8_bound(n_pairs: int, n: int):
    """K8: each valid pair's two windows of 5 × 16 fields read once, its
    two side rows of 80 written and read back, the five delta planes of
    ``n`` cells written; ~45 operations for each of its 256 cell pairs."""
    return _bound((3 * 2 * n_pairs * 80 + 5 * n) * 4, n_pairs * 256 * 45)


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


def _raw_k1v(lib, hot, immut, cvec, stencil, quantized, far, rsqrt,
             rollgroup):
    out = torch.empty_like(hot)
    _lib.check(lib.sb_fused_substep2_variant(
        hot.data_ptr(), immut.data_ptr(),
        None if far is None else far.data_ptr(), None, out.data_ptr(), None,
        cvec.data_ptr(), hot.shape[1], hot.shape[2], stencil,
        int(quantized), int(rsqrt), int(rollgroup), _stream()), "K1")
    return out


def _raw_k1m(lib, hot, immut, cvec, stencil, far, refs, detect, rsqrt,
             rollgroup):
    """K1's mode entry (trig with ``refs``, ``detect``), quantized: ``(hot',
    stats [blocks, 4] or None, side or None)``."""
    w, h = hot.shape[1:]
    out = torch.empty_like(hot)
    stats = (None if refs is None else torch.empty(
        (-(-h // 32) * -(-w // 8), 4), device=hot.device))
    side = (torch.empty((9, -(-w // 4), h), device=hot.device) if detect
            else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _lib.check(lib.sb_fused_substep2_mode(
        hot.data_ptr(), immut.data_ptr(), ptr(far), None, ptr(refs),
        out.data_ptr(), None, ptr(stats), ptr(side), cvec.data_ptr(), w, h,
        stencil, 1, int(rsqrt), int(rollgroup), int(refs is not None),
        int(detect), 0, 0, _stream()), "K1 mode")
    return out, stats, side


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
    # the far apply's two routes, strict: a ladder of buckets <= 256
    # (narrow) and the default ladder on a 512-pair list (the mirror
    # table, K7); and the backend's default variants on a 64-pair list
    # (krec: the mirror table for every bucket); on the card each takes
    # K8 (the default record layout)
    for label, route, max_pairs, buckets, kw in (
            ("narrow route", "narrow", 64, (16,), {"kernel_variants": ()}),
            ("mirror route", "mirror", 512, None, {"kernel_variants": ()}),
            ("default variants", "mirror", 64, None, {})):
        fused = FusedLatticeBackend(spec, cfg, device=dev,
                                    far_buckets=buckets,
                                    farfield=dataclasses.replace(
                                        ff, max_pairs=max_pairs,
                                        max_tile_pairs=32), **kw)
        hot = fused.pack_state(_hairpin(dev))
        compiled.sync_counts()
        before = dict(farfield4.APPLY_ROUTES)
        for _ in range(2):
            hot = fused.step(hot, consts, uin)
        compiled.sync_counts()
        ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
        want = "kernel" if farfield4.kernel_route(dev) else route
        if ran[want] != 2 * cfg.subticks or sum(ran.values()) != ran[want]:
            raise AssertionError(f"small fold, fused backend: far applies "
                                 f"by route {ran}, want all {want}")
        out[f"fused backend, {label}"] = (fused.far_stats(), hot[0][0:4])
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
    order differs on the card); the default variants within
    VARIANT_ATOL (the card's ``rsqrtf`` is an approximation, the CPU's
    ``rsqrt`` is ``1/sqrt``)."""
    cpu, gpu = _small_fold("cpu"), _small_fold("cuda")
    for k, (s_g, pv_g) in gpu.items():
        s_c, pv_c = cpu[k]
        if s_c != s_g or s_g["far_pairs"] == 0 or s_g["far_overflow"]:
            raise AssertionError(f"small fold, {k}: far stats cpu {s_c} vs "
                                 f"cuda {s_g}")
        dpos = (pv_g[0] - pv_c[0]).abs().max().item()
        dvel = (pv_g[1] - pv_c[1]).abs().max().item()
        atol = ((VARIANT_ATOL["pos"], VARIANT_ATOL["vel"]) if "default" in k
                else (5e-3, 5e-2))
        if not (dpos <= atol[0] and dvel <= atol[1]):
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
                  substeps: int) -> dict:
    """One frame under ``torch.profiler``: device busy time (the sum of
    the kernels' durations; one stream, so they do not overlap), the
    device's idle share against ``frame_ms`` (the frame's time with the
    profiler off: the profiler itself slows the host), the kernel launch
    count (a replayed CUDA graph's kernels each count) and the kernels
    that take most of the device time.  Only the device's activity is
    recorded: the host's ops were unused here and cost seconds a frame
    to record and to read back.  Returns busy ms, idle share and
    launches per substep."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # within the profiled frame itself: the time some kernel ran (the
    # union of their intervals) over the span from the first kernel's
    # start to the last one's end (the profiler stretches each of
    # thousands of short kernels, so the sum can pass the unprofiled
    # frame's time)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    union, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            union, lo, hi = union + hi - lo, a, b
        else:
            hi = max(hi, b)
    union += hi - lo
    span = max(b for _a, b in spans) - spans[0][0]
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
    log(f"{label} profile: kernels ran {union / 1e3:.1f} ms of the "
        f"profiled frame's {span / 1e3:.1f} ms device span (idle share "
        f"within it {1.0 - union / span:.2f})")
    return {"busy_ms": busy_ms, "idle": 1.0 - busy_ms / frame_ms,
            "per_substep": len(kernels) / substeps,
            "idle_span": 1.0 - union / span, "union_ms": union / 1e3,
            "span_ms": span / 1e3}


def run_path_a(dev) -> dict:
    """Path A at full width: ``play --path lattice --farfield`` on the 1M
    tearing cloth (default arguments, ``FarFieldSpec()``) with
    ``use_pallas``, through ``LatticeBackend.step`` (its chunks captured
    CUDA graphs: the first frame captures); then a frame that only
    replays under the profiler."""
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
    rate_replayed = (len(ms) - 1) * cfg.subticks / (sum(ms[1:]) / 1000.0)
    log(f"path A: {spec.width}x{spec.height} lattice, {n1} particles, "
        f"alive beams {m0} -> {m1}; {PATH_A_FRAMES} frames = {substeps} "
        f"substeps, frame ms {[round(t, 1) for t in ms]} = {rate:.1f} "
        f"substeps/s (frames 2-{PATH_A_FRAMES}, past the first frame's "
        f"captures: {rate_replayed:.1f}); far stats {stats}, "
        f"{be.far_chunks} chunks; K3 "
        f"launches {k3}, K2 launches {k2}; pos y range "
        f"[{state.pos[..., 1].min().item():.3f}, "
        f"{state.pos[..., 1].max().item():.3f}]")
    _profile_replay("path A", step, sum(ms[1:]) / (len(ms) - 1),
                    cfg.subticks, (lattice_frame_jit, lattice_frame_far_jit))
    return dict(state=box[0], cfg=cfg, consts=consts, spec=spec, k3=k3,
                rate=rate)


def run_path_b(dev, card: str) -> dict:
    """Path B at full width: bench.py's ``BENCH_PATH=fused_v1`` (the 1M
    tearing cloth, default arguments, r = 2, 64 substeps, no far field):
    ``fused_frame_jit`` (one CUDA graph a frame, K4 reading the frame's
    constants from device memory) against ``fused_frame`` in turns
    (PATH_B_FRAMES frames in all after a first frame of each,
    ``_in_turns``: every frame bit for bit, no host read); then at the final state one far-armed frame through
    ``fused_frame_far_jit`` against ``fused_frame_far`` and the trigger's
    inputs through ``packed_far_motion_jit``, bit for bit."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    mut, immut = pack_lattice(state)
    uin = tb.UserInput()
    eal = slice(10, 26, 5)
    m0 = int((mut[eal] > 0).sum())
    fused_substep.K4_LAUNCHES = 0
    turns = _in_turns("path B", {
        "captured": lambda m: fused_frame_jit(m, immut, consts, uin, spec,
                                              cfg),
        "eager": lambda m: fused_frame(m, immut, consts, uin, spec, cfg)},
        mut, PATH_B_FRAMES // 4, cfg.subticks, card)
    k4 = fused_substep.K4_LAUNCHES
    mut = turns["state"]
    substeps = PATH_B_FRAMES * cfg.subticks
    if k4 != substeps + 4 * cfg.subticks:
        raise AssertionError(f"path B: K4 launched {k4} times for "
                             f"{substeps} substeps and 2 first and 2 "
                             "profiled frames")
    if not bool(torch.isfinite(mut).all()):
        raise AssertionError("path B: non-finite state")
    if tuple(mut.shape) != (26, spec.width, spec.height):
        raise AssertionError(f"path B: mut shape {tuple(mut.shape)}")
    m1 = int((mut[eal] > 0).sum())
    ff = _far_spec(980.0 / (spec.width - 1))
    fl = rebuild_far_list_packed(mut, immut, s=spec.collision_stencil, ff=ff,
                                 radius=cfg.particle_radius)
    reads0 = compiled.HOST_READS
    far_c = fused_frame_far_jit(mut, immut, fl, consts, uin, spec, cfg, ff)
    motion_c = packed_far_motion_jit(mut, immut, fl)
    reads = compiled.HOST_READS - reads0
    far_e = fused_frame_far(mut, immut, fl, consts, uin, spec, cfg, ff)
    motion_e = packed_far_motion(mut, immut, fl)
    if not (_same(far_c, far_e) and _same(motion_c, motion_e)) or reads:
        raise AssertionError(f"path B far: captured differs from eager "
                             f"(host reads {reads})")
    rate = turns["rate"]["captured"]
    log(f"path B: {spec.width}x{spec.height} lattice, alive beams {m0} -> "
        f"{m1}; far-armed frame at the final state ({fl.counts()[0]} far "
        f"pairs) captured == eager bit for bit, its trigger inputs too, 0 "
        f"host reads; K4 launches {k4} on {card}")
    return dict(mut=mut, immut=immut, cfg=cfg, consts=consts, spec=spec,
                k4=k4, rate=rate, turns=turns)


def _k8_launches() -> int:
    """K8's launches as pairs (K8a and K8b launch together, once an
    apply); raises where they part."""
    if far_apply.K8A_LAUNCHES != far_apply.K8B_LAUNCHES:
        raise AssertionError(f"K8a launched {far_apply.K8A_LAUNCHES} times, "
                             f"K8b {far_apply.K8B_LAUNCHES}")
    return far_apply.K8A_LAUNCHES


def _far_launches() -> int:
    """The far apply's kernel launches: K7 (the record table, under an
    explicit lane block) and K8 (the card's default layout), one an
    applying rung either way."""
    return recmirror.K7_LAUNCHES + _k8_launches()


def _zero_k1_k2_k7() -> None:
    # the launches that captured frames counted on the device (their
    # conditional bodies: K7 under a mirror rung, K1's detect and trig
    # instances under the trigger) are folded in before a counter is set
    # to 0 or read
    compiled.sync_counts()
    fused_substep2.K1_LAUNCHES = 0
    for k in fused_substep2.K1_INSTANCE_LAUNCHES:
        fused_substep2.K1_INSTANCE_LAUNCHES[k] = 0
    band_detect.K2_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    far_apply.K8A_LAUNCHES = 0
    far_apply.K8B_LAUNCHES = 0


def run_main_path(state, spec, cfg, consts, spacing) -> dict:
    """The bench scene through ``FusedLatticeBackend`` as bench.py runs
    it, with the default kernel variants (JAX's: K1 in its
    rsqrt+rollgroup instance), and the same backend strict
    (``kernel_variants=()``) from the same state: a first and a warm
    frame each, then TIMED_FRAMES frames each in turns (default, strict,
    strict, default; TIMED_FRAMES / 2 frames a turn), the kernels'
    launch counts from zero before each turn and summed per path."""
    uin = tb.UserInput()
    runs = {}
    for path, kvar in (("default", None), ("strict", ())):
        kw = {} if kvar is None else {"kernel_variants": kvar}
        be = FusedLatticeBackend(spec, cfg, farfield=_far_spec(spacing),
                                 device="cuda", **kw)
        packed = be.pack_state(state)
        n0, m0 = be.counts(packed)
        t0 = time.perf_counter()
        _zero_k1_k2_k7()
        packed = be.step(packed, consts, uin)
        torch.cuda.synchronize()
        compiled.sync_counts()
        first = be.far_stats()
        log(f"main path ({path}, kvar {be.kvar}): first frame "
            f"{time.perf_counter() - t0:.2f} s, far stats {first}, K8a "
            f"launches {far_apply.K8A_LAUNCHES}")
        if first["far_pairs"] == 0 and _far_launches():
            raise AssertionError("main path: K7 or K8 launched before far "
                                 "pairs exist")
        for _ in range(WARM_FRAMES - 1):
            packed = be.step(packed, consts, uin)
        be.far_stats()  # reset the window
        runs[path] = dict(be=be, packed=packed, n0=n0, m0=m0, ms=0.0,
                          wall=0.0, k1=0, k2=0, k7=0, k8=0, stats=None,
                          k1_instances=dict.fromkeys(
                              fused_substep2.K1_INSTANCE_LAUNCHES, 0),
                          routes=dict.fromkeys(farfield4.APPLY_ROUTES, 0))
    half = TIMED_FRAMES // 2
    for path in ("default", "strict", "strict", "default"):
        r = runs[path]
        _zero_k1_k2_k7()
        routes0 = dict(farfield4.APPLY_ROUTES)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(half):
            r["packed"] = r["be"].step(r["packed"], consts, uin)
        end.record()
        torch.cuda.synchronize()
        r["wall"] += time.perf_counter() - t0
        r["ms"] += start.elapsed_time(end)
        compiled.sync_counts()
        r["k1"] += fused_substep2.K1_LAUNCHES
        r["k2"] += band_detect.K2_LAUNCHES
        r["k7"] += recmirror.K7_LAUNCHES
        r["k8"] += _k8_launches()
        for k, v in fused_substep2.K1_INSTANCE_LAUNCHES.items():
            r["k1_instances"][k] += v
        for k, v in farfield4.APPLY_ROUTES.items():
            r["routes"][k] += v - routes0[k]
    substeps = TIMED_FRAMES * cfg.subticks
    for path, r in runs.items():
        be, hot = r["be"], r["packed"][0]
        stats = r["stats"] = be.far_stats()
        k1, k2, k8, routes = r["k1"], r["k2"], r["k8"], r["routes"]
        instance = "rsqrt+rollgroup" if path == "default" else "strict"
        if not bool(torch.isfinite(hot[:6]).all()):
            raise AssertionError(f"main path ({path}): non-finite particle "
                                 "state")
        if tuple(hot.shape) != (18, spec.width, spec.height):
            raise AssertionError(f"main path ({path}): hot shape "
                                 f"{tuple(hot.shape)}")
        if stats["far_overflow"] != 0 or stats["far_pairs"] == 0:
            raise AssertionError(f"main path ({path}): far stats {stats}")
        if k1 != substeps or r["k1_instances"][instance] != substeps:
            raise AssertionError(f"main path ({path}): K1 launched {k1} "
                                 f"times ({r['k1_instances']}) for "
                                 f"{substeps} substeps")
        if k2 != stats["far_rebuilds"] or k2 == 0:
            raise AssertionError(f"main path ({path}): K2 launched {k2} "
                                 f"times for {stats['far_rebuilds']} "
                                 "rebuilds")
        # the card's default record layout: every substep with pairs
        # applies them through K8 (K8a and K8b once each), never K7
        if (k8 == 0 or k8 != routes["kernel"] or routes["narrow"]
                or routes["mirror"] or r["k7"]):
            raise AssertionError(f"main path ({path}): K8 launched {k8} "
                                 f"times, K7 {r['k7']}; far applies by "
                                 f"route {routes}")
        n1, m1 = be.counts(r["packed"])
        r["rate"] = substeps / (r["ms"] / 1000.0)
        r["frame_ms"] = r["ms"] / TIMED_FRAMES
        pos = hot[0:2]
        log(f"main path ({path}): {spec.width}x{spec.height} lattice, {n1} "
            f"particles, alive beams {r['m0']} -> {m1}; {TIMED_FRAMES} "
            f"frames = {substeps} substeps in {r['ms']:.1f} ms (CUDA "
            f"events, in turns; host {r['wall']:.3f} s) = "
            f"{r['rate']:.1f} substeps/s; far stats {stats}; K1 launches "
            f"{k1} ({instance}), K2 launches {k2}, K8 launches {k8} ({k8} "
            f"of {substeps} substeps with far pairs); pos range "
            f"[{pos.min().item():.2f}, {pos.max().item():.2f}]")
    run = runs["default"]
    run["strict"] = runs["strict"]
    return run


def check_default_frame10(state, spec, cfg, consts, spacing) -> dict:
    """Frame 10 of the bench scene (the first in which the far field
    changes its state) from the strict path's frame 9, through the
    default backend, the strict one, and the strict one from frame 9
    with every vx one ulp up (the control).  The default's first
    VARIANT_SUBSTEPS substeps of frame 10 stay within VARIANT_ATOL of
    strict's, edge liveness equal (JAX's own variant test runs that many
    substeps); its whole frame is finite, with far pairs and no
    overflow.  Over a whole frame the tearing sheet turns any rounding
    difference into an O(1) one (the control shows how far), so frame
    10 as a whole is compared beside the control, not held to the
    tolerance.  Returns the largest differences by horizon."""
    uin = tb.UserInput()
    ff = _far_spec(spacing)
    strict = FusedLatticeBackend(spec, cfg, farfield=ff, device="cuda",
                                 kernel_variants=())
    default = FusedLatticeBackend(spec, cfg, farfield=ff, device="cuda")
    hot9, obs9 = strict.pack_state(state)
    for _ in range(9):
        hot9, obs9 = strict.step((hot9, obs9), consts, uin)
    ulp = hot9.clone()
    ulp[VX] = torch.nextafter(ulp[VX], torch.full_like(ulp[VX], math.inf))

    def frame(kvar, n_sub, hot=hot9):
        h, _o, st = fused_frame4(hot.clone(), obs9.clone(), strict._immut,
                                 strict._edge_consts, consts, uin, spec, cfg,
                                 ff, n_sub=n_sub, kvar=kvar)
        return h, dict(zip(("far_rebuilds", "far_pairs", "far_overflow",
                            "far_active"), st.tolist()))

    def diff(a, b):
        return {"pos": (a[0:2] - b[0:2]).abs().max().item(),
                "vel": (a[2:4] - b[2:4]).abs().max().item(),
                "edges alive differ": int((a[8::3] != b[8::3]).sum())}

    kvar = default._checked_kvar(consts)
    out = {}
    for n_sub in (VARIANT_SUBSTEPS, 16, cfg.subticks):
        ref, _st = frame((), n_sub)
        got, st = frame(kvar, n_sub)
        out[n_sub] = {"default": diff(got, ref),
                      "strict, vx one ulp up": diff(frame((), n_sub, ulp)[0],
                                                    ref)}
        if (not bool(torch.isfinite(got[:6]).all()) or st["far_overflow"]
                or not st["far_pairs"]):
            raise AssertionError(f"bench frame 10, default, {n_sub} "
                                 f"substeps: far stats {st}")
    errs = out[VARIANT_SUBSTEPS]["default"]
    if not (errs["pos"] <= VARIANT_ATOL["pos"]
            and errs["vel"] <= VARIANT_ATOL["vel"]
            and errs["edges alive differ"] == 0):
        raise AssertionError(
            f"bench frame 10, default vs strict from the same frame 9, "
            f"{VARIANT_SUBSTEPS} substeps: {errs} beyond {VARIANT_ATOL}")
    log(f"bench frame 10 from strict's frame 9, default {kvar} vs strict: "
        f"first {VARIANT_SUBSTEPS} substeps max |err| {errs} (within "
        f"{VARIANT_ATOL}; the one-ulp control "
        f"{out[VARIANT_SUBSTEPS]['strict, vx one ulp up']}); 16 substeps "
        f"{out[16]}; the whole frame {out[cfg.subticks]}")
    return out


def time_at_final_state(run, spec, cfg, consts, parent=None) -> dict:
    """At the main path's final state (CUDA events, ms per call): one
    rebuild; one far apply (K8 on the card's default layout), the
    record-table route's parts, and the windowed gather; and K1, K2, K7
    and K8 against their plain versions (K7 also against its library
    call) on the inputs the main path gives them, K2's flags and K8's
    planes held bit-exact there.  K1 also at stencil
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
        # where the apply's device time goes (K8: its order, K8a, K8b)
        profile_frame("far apply, K8", apply, t["apply"], 1)
        # the record-table route's pair step (an explicit lane block's)
        dtab = far_terms_from_mirror(table, crop_far_list(fl, k), w=wp,
                                     h=hp, **pair_kw)
        t["table route: pairs"] = _timed_ms(lambda: far_terms_from_mirror(
            table, crop_far_list(fl, k), w=wp, h=hp, **pair_kw), 20)
        t["table route: unmirror"] = _timed_ms(lambda: unmirror_table(
            dtab, w=wp, h=hp)[:, :alive.shape[0], :alive.shape[1]]
            .contiguous(), 20)
        log(f"far apply at the final state: bucket {k}, K8 vs the "
            f"windowed gather max |err| {err:.3g}")
        # K8 alone: its order built once (a block's first apply builds
        # it), K8a and K8b; its plain versions on the same tensors
        flk = crop_far_list(fl, k)
        dest = far_apply.dest_order(fl.ca, fl.cb, fl.valid,
                                    (wp // 4) * (hp // 4))
        out8 = torch.empty((5,) + tuple(alive.shape), device=hot.device)
        akw = dict(s=s, ff=ff, radius=cfg.particle_radius, dt=cfg.dt,
                   ecoeff=consts.ecoeff, friction=consts.friction, h=hp,
                   world_h=-(-hp // 32) * 32)

        def k8():
            rows = far_apply.far_pairs_call(planes, flk, **akw)
            return far_apply.far_accumulate_call(rows, dest, flk.valid,
                                                 out8, h=hp)

        def k8_plain():
            rows = far_apply.far_pairs_plain(planes, flk, **akw)
            return far_apply.far_accumulate_plain(
                rows, dest, flk.valid, torch.empty_like(out8), h=hp)

        got8, ref8 = k8().clone(), k8_plain()
        if not _same(got8, ref8):
            raise AssertionError("K8 at the final state differs from its "
                                 "plain versions")
        t["K8 err"] = (got8 - ref8).abs().max().item()
        t["K8"] = _device_ms(k8, 50)
        # ~20 launches a build (the sort's passes): 10 builds stay under
        # the device's launch queue
        t["K8 order"] = _device_ms(lambda: far_apply.dest_order(
            fl.ca, fl.cb, fl.valid, (wp // 4) * (hp // 4)), 10)
        t["K8 plain"] = _timed_ms(k8_plain, 5)
    t["K7"] = _device_ms(lambda: mirror_table(planes, w=wp, h=hp), 200)
    hm = -(-hp // 32) * 32
    t["K7 plain"] = _timed_ms(lambda: recmirror.mirror_records_plain(
        planes, w_out=wp, h_out=hm), 50)
    t["K7 library"] = _device_ms(_record_relayout(list(planes), wp, hm),
                                 200)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg,
                                       spec.height), be._edge_consts])
    k1kw = dict(stencil=s, quantized=True, far=far)
    # K1's instances, each timed on the bench path's inputs; the default
    # (rsqrt+rollgroup, the main path's) and strict in turns (strict,
    # default, default, strict)
    k1fn = {name: (lambda f=flags: fused_substep2_call(
        hot, immut, cvec, rsqrt=f[0], rollgroup=f[1], **k1kw))
        for name, flags in K1_INSTANCES.items()}
    turns = {"strict": [], "rsqrt+rollgroup": []}
    for name in ("strict", "rsqrt+rollgroup", "rsqrt+rollgroup", "strict"):
        turns[name].append(_device_ms(k1fn[name], 50))
    for name in K1_INSTANCES:
        t[f"K1 {name}"] = (sum(turns[name]) / 2 if name in turns
                           else _device_ms(k1fn[name], 50))
    t["K1"] = t["K1 rsqrt+rollgroup"]
    t["K1 s0"] = _device_ms(lambda: fused_substep2_call(
        hot, immut, cvec, **dict(k1kw, stencil=0)), 50)
    t["compare"] = {}
    for st in (s, 0) if parent is not None else ():
        t["compare"][f"K1 s{st}"] = _turns(
            lambda: _raw_k1(parent, hot, immut, cvec, st, True, far),
            lambda: _raw_k1(_lib.library(), hot, immut, cvec, st, True, far),
            50)
    if parent is not None and hasattr(parent, "sb_fused_substep2_variant"):
        # the bench path's instance (the default variants)
        t["compare"][f"K1 rsqrt+rollgroup s{s}"] = _turns(
            lambda: _raw_k1v(parent, hot, immut, cvec, s, True, far, 1, 1),
            lambda: _raw_k1v(_lib.library(), hot, immut, cvec, s, True, far,
                             1, 1), 50)
    for name, (rq, rg) in K1_INSTANCES.items():
        t[f"K1 {name} plain"] = _timed_ms(
            lambda: fused_substep2_plain(hot, immut, cvec, rsqrt=rq,
                                         rollgroup=rg, **k1kw), 5)
    t["K1 plain"] = t["K1 rsqrt+rollgroup plain"]
    log("K1 at the bench final state, device ms in turns: strict "
        f"{turns['strict'][0]:.4f}, default (rsqrt+rollgroup) "
        f"{turns['rsqrt+rollgroup'][0]:.4f}, default "
        f"{turns['rsqrt+rollgroup'][1]:.4f}, strict {turns['strict'][1]:.4f}"
        " (ratio default / strict "
        f"{t['K1 rsqrt+rollgroup'] / t['K1 strict']:.3f}); rsqrt "
        f"{t['K1 rsqrt']:.4f}, rollgroup {t['K1 rollgroup']:.4f}; plain "
        + ", ".join(f"{n} {t[f'K1 {n} plain']:.2f}" for n in K1_INSTANCES)
        + " ms")
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
              "K8": _k8_bound(n_pairs, n),
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
    resets on read): pairs and overflow as maxima, ``held_overflow``
    over the reads up to frame RUNTIME_HELD_FRAMES (a read covers the
    frames since the last one).  Raises on a worker error."""
    t_end = time.monotonic() + timeout
    while True:
        st = eng.stats()
        far["far_pairs"] = max(far.get("far_pairs", 0), st.far_pairs)
        far["far_overflow"] = max(far.get("far_overflow", 0),
                                  st.far_overflow)
        if st.frame_index <= RUNTIME_HELD_FRAMES:
            far["held_overflow"] = max(far.get("held_overflow", 0),
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


def _alone_and_polled(eng, f: int, frames: int, far: dict,
                      label: str) -> dict:
    """From frame ``f``, four windows of ``frames`` frames: alone (this
    thread reads the stats every 50 ms), polled (this thread calls
    ``render_packet()`` flat-out), polled, alone.  Returns frames/s of
    each kind, the packets' latencies (ms), up to 8 packets' positions
    by frame index and the frame indices seen."""
    packets, lat, seen = {}, [], [f]
    spent = {"alone": [0, 0.0], "polled": [0, 0.0]}  # frames, seconds
    for kind in ("alone", "polled", "polled", "alone"):
        t0 = time.perf_counter()
        if kind == "alone":
            f1 = _wait_frames(eng, f + frames, far, every=0.05).frame_index
        else:
            while seen[-1] < f + frames:
                ta = time.perf_counter()
                pkt = eng.render_packet()
                lat.append((time.perf_counter() - ta) * 1e3)
                seen.append(pkt.frame_index)
                if pkt.frame_index not in packets and len(packets) < 8:
                    packets[pkt.frame_index] = pkt.pos
                if ta > t0 + 120.0 or eng.error is not None:
                    raise AssertionError(f"{label}: polled engine at frame "
                                         f"{seen[-1]} ({eng.error!r})")
            f1 = seen[-1]
        spent[kind][0] += f1 - f
        spent[kind][1] += time.perf_counter() - t0
        f = f1
    return {"fps_alone": spent["alone"][0] / spent["alone"][1],
            "fps_polled": spent["polled"][0] / spent["polled"][1],
            "spent": spent, "lat": lat, "packets": packets, "seen": seen}


def _check_packets(packets: dict, kept: dict, seen: list, label: str) -> None:
    """Frame indices monotonic, and every packet bitwise equal to the
    clone of its frame's positions that ``_witness`` kept."""
    if seen != sorted(seen):
        raise AssertionError(f"{label}: packet frame indices not monotonic")
    torch.cuda.synchronize()
    for idx, pos in packets.items():
        ref = kept[idx].cpu().numpy()
        if pos.tobytes() != ref.tobytes():
            raise AssertionError(f"{label}: the packet of frame {idx} "
                                 "differs from that frame's positions")


def run_runtime_fused(dev, card: str) -> dict:
    """The fused engine at 1M: ``LatticeEngine(fused=True)`` on the bench
    scene with the bench far field, stepping flat-out on its worker
    thread.  Frames/s without and with ``render_packet()`` polled
    flat-out from this thread, in windows of RUNTIME_FRAMES frames
    (alone, polled, polled, alone; frames 2-10), packet latency, packets
    bitwise equal to
    the frame they name (an independent clone kept at extract), K1 64 and
    K2 8 launches per frame, K7 once far pairs exist, ``far_overflow`` 0
    over every stats read up to frame RUNTIME_HELD_FRAMES (logged after
    it).  Then, paused, the L1 snapshot round trip
    (save → load → save byte-equal, timed), three ``corrupt_buffers``
    with stepping going on, and ``recreate(subticks=32)``."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         bounds_size=cfg.bounds_size,
                         collision_mode=cfg.collision_mode,
                         force_mode=cfg.force_mode, target_fps=None)
    far = {}
    _zero_k1_k2_k7()
    eng = LatticeEngine(state, spec, consts, opts, farfield=_far_spec(spacing),
                        fused=True, device=dev)
    del state
    out = {}
    try:
        kept = _witness(eng)
        f = _wait_frames(eng, 2, far).frame_index
        win = _alone_and_polled(eng, f, RUNTIME_FRAMES, far, "runtime")
        spent, lat, packets = win["spent"], win["lat"], win["packets"]
        fps_alone, fps_polled = win["fps_alone"], win["fps_polled"]
        frames = _pause(eng, far)
        compiled.sync_counts()
        k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
        k8 = _k8_launches()
        _check_packets(packets, kept, win["seen"], "runtime")
        if k1 != cfg.subticks * frames or k2 != 8 * frames:
            raise AssertionError(f"runtime: {frames} frames launched K1 {k1}"
                                 f", K2 {k2} times")
        if (far.get("held_overflow", 1) or (far["far_pairs"] > 0)
                != (k8 > 0) or recmirror.K7_LAUNCHES):
            raise AssertionError(f"runtime: far stats {far}, K8 {k8}, K7 "
                                 f"{recmirror.K7_LAUNCHES}")
        lat_ms = sorted(lat)
        out.update(fps_alone=fps_alone, fps_polled=fps_polled,
                   lat_median=lat_ms[len(lat_ms) // 2], lat_max=lat_ms[-1],
                   frames=frames, k1=k1, k2=k2, k8=k8, far=dict(far))
        log(f"runtime, fused engine 1M: {frames} frames on the worker "
            f"thread, {fps_alone:.3f} frames/s alone ({spent['alone'][0]} "
            f"frames), {fps_polled:.3f} frames/s with render_packet() "
            f"polled flat-out ({spent['polled'][0]} frames, {len(lat)} "
            f"packets, latency median {out['lat_median']:.1f} ms, max "
            f"{out['lat_max']:.1f} ms; frame indices monotonic; "
            f"{len(packets)} packets bitwise equal to their frame's "
            f"positions); K1 {k1} = {cfg.subticks} x {frames}, K2 {k2} = 8 "
            f"x {frames}, K8 {k8}; far stats over the reads {far} on {card}")

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
    default = dict(rsqrt=True, rollgroup=True)
    for k, call, plain, args, flags in (
            ("K1", fused_substep2_call, fused_substep2_plain,
             (hot, immut, cvec), {}),
            ("K1 rsqrt+rollgroup", fused_substep2_call, fused_substep2_plain,
             (hot, immut, cvec), default),
            ("K4", fused_substep_call, fused_substep_plain,
             (mut, immut4, cvec[:20].clone()), {})):
        for s in (1, 2):
            kw = dict(stencil=s, quantized=True, **flags)
            ref = plain(*args, **kw)
            got = call(*args, **kw)
            torch.cuda.synchronize()
            n_bad = int(_differs(got, ref).sum())
            n_nan = int(torch.isnan(ref).any(0).sum())
            # strict: the terms of pairs apart are ±0 x inf = NaN, which
            # the skip must not hide; under rsqrt they are +0
            if n_bad or (not n_nan and not flags):
                raise AssertionError(f"{k} dt=1e-19 s={s}: {n_bad} values "
                                     f"differ ({n_nan} NaN particles)")
    log(f"K1/K4 at {w}x{h} with dt = 1e-19 (clip overflows, no skip; "
        "K1's rsqrt+rollgroup instance skips: its terms of a pair apart "
        "are +0 whatever clip is): bitwise equal to the plain versions, "
        "NaN included, stencils 1, 2")


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
    # the captured frames count their bodies' launches (K7, the far
    # apply's routes) on the device: folded in before a counter is set or
    # read
    compiled.sync_counts()
    collide_stencil.K3_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    far_apply.K8A_LAUNCHES = 0
    far_apply.K8B_LAUNCHES = 0
    routes0 = dict(farfield4.APPLY_ROUTES)
    reads0 = compiled.HOST_READS
    ms = _frames(step, PLANIFIED_FRAMES)
    compiled.sync_counts()
    reads = compiled.HOST_READS - reads0
    k3, k2 = collide_stencil.K3_LAUNCHES, band_detect.K2_LAUNCHES
    k7, k8 = recmirror.K7_LAUNCHES, _k8_launches()
    routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
    stats = be.far_stats()
    ps = box[0]
    substeps = PLANIFIED_FRAMES * cfg.subticks
    if not bool(torch.isfinite(torch.stack([ps.lat.pos, ps.lat.vel])).all()):
        raise AssertionError("planified config 3: non-finite state")
    if stats["far_overflow"] != 0 or reads:
        raise AssertionError(f"planified config 3: far stats {stats}, "
                             f"host reads {reads}")
    if k3 != substeps:
        raise AssertionError(f"planified config 3: K3 launched {k3} times "
                             f"for {substeps} substeps")
    if k2 != 8 * PLANIFIED_FRAMES or k2 != stats["far_rebuilds"]:
        raise AssertionError(f"planified config 3: K2 launched {k2} times, "
                             f"far stats {stats}")
    # the card's default record layout: every substep with active pairs
    # applies them through K8 (K8a and K8b once each), never K7
    if k8 != routes["kernel"] or routes["narrow"] or routes["mirror"] or k7:
        raise AssertionError(f"planified config 3: K8 launched {k8} times, "
                             f"K7 {k7}; far applies by route {routes}")
    n1, m1 = be.counts(ps)
    rate = substeps / (sum(ms) / 1000.0)
    log(f"planified config 3: {PLANIFIED_FRAMES} frames = {substeps} "
        f"substeps, frame ms {[round(x, 1) for x in ms]} = {rate:.1f} "
        f"substeps/s ({rate * n1:.4g} particle-substeps/s); alive beams "
        f"{m0} -> {m1}; far stats warm frame {warm}, timed {stats}; K3 "
        f"{k3} = {cfg.subticks} x {PLANIFIED_FRAMES}, K2 {k2} = 8 x "
        f"{PLANIFIED_FRAMES}, K8 {k8} ({'on' if k8 else 'none of'} the "
        f"substeps with active pairs: {routes['kernel']} K8 applies); the "
        f"backend steps the captured frames "
        f"(planified_frame_far_jit), 0 host reads on {card}")
    turns = _planified_turns("planified config 3", be, box[0], consts, uin,
                             cfg, card)
    t, bounds = _planified_kernels(box[0], spec, cfg, consts, ff)
    directed_rate = run_directed_config3(flat, cfg0, consts, uin, card)
    return dict(k2=k2, k3=k3, k7=k7, k8=k8, rate=rate, t=t, bounds=bounds,
                stats=stats, directed_rate=directed_rate, turns=turns)


def _planified_turns(label: str, be, ps, consts, uin, cfg, card) -> dict:
    """``be`` (stepping the captured planified frames) against its eager
    twin (the same embedding, the plain frames, decisions read on the
    host) from ``ps``, in turns of one frame (``_in_turns``): every
    frame's state and far stats accumulator bit for bit."""
    be.far_stats()
    twin = copy.copy(be)
    twin._frame = planify.planified_frame
    twin._frame_far = planify.planified_frame_far
    bes = {"captured": be, "eager": twin}
    out = _in_turns(label, {k: (lambda p, b=b: b.step(p, consts, uin))
                            for k, b in bes.items()}, ps, 1, cfg.subticks,
                    card, extra=lambda k: bes[k]._stats_acc)
    stats = {k: b.far_stats() for k, b in bes.items()}
    if stats["captured"] != stats["eager"]:
        raise AssertionError(f"{label}: far stats {stats}")
    out["stats"] = stats["captured"]
    return out


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


def run_planified_engine(dev, card) -> dict:
    """Config 4 planified: the backend's captured frames against their
    eager twin in turns (``_planified_turns``); then behind ``Engine`` on
    the card: frames on the
    worker thread with ``render_packet()`` polled every 5 ms, each packet
    bitwise
    equal to ``unplanify`` of an independent clone of its frame (kept at
    extract), K3 64 per frame, K8 once per apply with pairs; then the v1 snapshot round trip, three
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
    log(f"planified config 4 backend alone (captured frames): frame ms "
        f"{[round(x, 1) for x in ms]} = "
        f"{2 * cfg.subticks / (sum(ms) / 1000.0):.1f} substeps/s, far stats "
        f"{be.far_stats()}")
    turns = _planified_turns("planified config 4", be, box[0], consts,
                             tb.UserInput(), cfg, card)
    ps = be.pack_state(flat)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         collision_mode=cfg.collision_mode, use_pallas=True,
                         target_fps=None)
    compiled.sync_counts()
    collide_stencil.K3_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    far_apply.K8A_LAUNCHES = far_apply.K8B_LAUNCHES = 0
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
        compiled.sync_counts()
        k3, k8 = collide_stencil.K3_LAUNCHES, _k8_launches()
        routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
        if k3 != cfg.subticks * frames:
            raise AssertionError(f"planified engine: {frames} frames "
                                 f"launched K3 {k3} times")
        # the card's default record layout: every substep with active
        # pairs applies them through K8, never K7
        if (not k8 or k8 != routes["kernel"] or routes["narrow"]
                or routes["mirror"] or recmirror.K7_LAUNCHES):
            raise AssertionError(f"planified engine: K8 launched {k8} "
                                 f"times, K7 {recmirror.K7_LAUNCHES}, far "
                                 f"applies by route {routes}")
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
            f" K8 {k8} (one per apply with active pairs: {routes['kernel']}"
            f" of {cfg.subticks * frames} substeps); far stats over the reads "
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
    return turns


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
    """The fold through ``planified_frame_far`` on the card (K8 once per
    substep) against the CPU, once through the CPU's narrow route (a
    256-pair list) and once through its mirror route (512 pairs: bucket
    512 > 256): far stats equal and non-empty, positions and velocities
    within check_small_fold's tolerances."""
    cfg = tb.StaticConfig(subticks=4, particle_radius=4.0)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    for route, max_pairs in (("narrow", 256), ("mirror", 512)):
        ff = FarFieldSpec(max_pairs=max_pairs, max_tile_pairs=64, skin=18.0,
                          horizon=2)
        out = {}
        for d in ("cpu", dev):
            ps, spec = _fold_strip(d)
            before = dict(farfield4.APPLY_ROUTES)
            k7, k8 = recmirror.K7_LAUNCHES, _k8_launches()
            ps, st = planify.planified_frame_far(ps, consts, uin, spec, cfg,
                                                 ff)
            k7, k8 = recmirror.K7_LAUNCHES - k7, _k8_launches() - k8
            ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
            want = "kernel" if farfield4.kernel_route(d) else route
            if ran[want] != cfg.subticks or sum(ran.values()) != ran[want]:
                raise AssertionError(f"planified fold on {d}: applies by "
                                     f"route {ran}, want all {want}")
            # K8 once per apply on the card, K7 never; the CPU runs the
            # plain route
            if (k8, k7) != (ran["kernel"], 0):
                raise AssertionError(f"planified fold on {d}: K8 launched "
                                     f"{k8} times, K7 {k7}, applies by "
                                     f"route {ran}")
            out[str(d)] = (st.tolist(), ps.lat.pos.cpu(), ps.lat.vel.cpu())
        (st_g, pos_g, vel_g), (st_c, pos_c, vel_c) = out[str(dev)], out["cpu"]
        dpos = (pos_g - pos_c).abs().max().item()
        dvel = (vel_g - vel_c).abs().max().item()
        if st_g != st_c or st_g[1] == 0 or st_g[2] or not (
                dpos <= 5e-3 and dvel <= 5e-2):
            raise AssertionError(f"planified fold, {route} route: stats cuda "
                                 f"{st_g} cpu {st_c}, |dpos| {dpos}, |dvel| "
                                 f"{dvel}")
        log(f"planified fold {spec.width}x{spec.height}, K8 against the "
            f"CPU's {route} route: cuda == cpu plain (stats {st_g}; max "
            f"|dpos| {dpos:.3g}, |dvel| {dvel:.3g}); K8 {k8} on the card")


def run_fused_activation(dev, bench_rate: float, card: str) -> dict:
    """``FusedLatticeBackend`` on the bench scene with the activation
    schedule off, then on, over the same frames: ACTIVATION_WARM frames,
    then frames 8-10 with the launch counts from 0 (K1 64 per frame, K2
    once per rebuild, K8 once per apply with pairs; far pairs present,
    ``far_active ≤ far_pairs``, ``far_overflow`` 0), then one profiled
    frame."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    uin = tb.UserInput()
    substeps = ACTIVATION_FRAMES * cfg.subticks
    rates = {}
    for act in (False, True):
        be = FusedLatticeBackend(spec, cfg, farfield=_far_spec(spacing),
                                 far_activation=act, device=dev,
                                 kernel_variants=())
        box = [be.pack_state(state)]

        def step():
            box[0] = be.step(box[0], consts, uin)

        for _ in range(ACTIVATION_WARM):
            step()
        be.far_stats()
        _zero_k1_k2_k7()
        routes0 = dict(farfield4.APPLY_ROUTES)
        ms = _frames(step, ACTIVATION_FRAMES)
        compiled.sync_counts()
        k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
        k7, k8 = recmirror.K7_LAUNCHES, _k8_launches()
        routes = {k: v - routes0[k] for k, v in farfield4.APPLY_ROUTES.items()}
        stats = be.far_stats()
        label = f"fused backend, far_activation={act}"
        if not bool(torch.isfinite(box[0][0][:6]).all()):
            raise AssertionError(f"{label}: non-finite state")
        if (stats["far_overflow"] or stats["far_active"] > stats["far_pairs"]
                or not stats["far_active"] or k1 != substeps
                or k2 != stats["far_rebuilds"] or not k8 or k7
                or k8 != routes["kernel"] or routes["narrow"]
                or routes["mirror"]):
            raise AssertionError(f"{label}: far stats {stats}, K1 {k1}, K2 "
                                 f"{k2}, K8 {k8}, K7 {k7}, routes {routes}")
        rates[act] = substeps / (sum(ms) / 1000.0)
        profile_frame(label, step, sum(ms) / len(ms), cfg.subticks)
        log(f"{label}, bench scene frames {ACTIVATION_WARM + 1}-"
            f"{ACTIVATION_WARM + ACTIVATION_FRAMES}: frame ms "
            f"{[round(x, 1) for x in ms]} = {rates[act]:.1f} substeps/s; far "
            f"stats {stats} (the profiled frame after them: "
            f"{be.far_stats()}); K1 {k1}, K2 {k2}, K8 {k8} on {card}")
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
    compiled.sync_counts()
    return {"K1": fused_substep2.K1_LAUNCHES, "K2": band_detect.K2_LAUNCHES,
            "K3": collide_stencil.K3_LAUNCHES,
            "K4": fused_substep.K4_LAUNCHES, "K7": recmirror.K7_LAUNCHES,
            "K8": _k8_launches()}


def _zero_launches() -> None:
    compiled.sync_counts()
    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
    collide_stencil.K3_LAUNCHES = 0
    fused_substep.K4_LAUNCHES = 0
    recmirror.K7_LAUNCHES = 0
    far_apply.K8A_LAUNCHES = far_apply.K8B_LAUNCHES = 0


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
    CPU's frame bit for bit (the far apply sums in list order; the CPU's
    frame takes K8's plain versions here, the card's route, which the
    CPU otherwise leaves for its record-table routes)."""
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
    card_route = farfield4.kernel_route
    farfield4.kernel_route = (lambda device, mb=32, mb_out=None:
                              card_route("cuda", mb, mb_out))
    try:
        for d, runs in (("cpu", 1), (dev, 2)):
            st = lattice_state_from_numpy(**lattice_state_to_numpy(state),
                                          device=d)
            for act in (False, True):
                for run in range(runs):
                    hot, obs, immut, ec = pack_lattice2(st)
                    hot, obs, stats = fused_substep2.fused_frame4(
                        hot, obs, immut, ec, consts, tb.UserInput(), spec,
                        cfg, ff, activation=act)
                    out[str(d), act, run] = (hot[0:6].cpu(), stats.tolist())
    finally:
        farfield4.kernel_route = card_route
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

    launches_cli = {"K2": 0, "K7": 0, "K8": 0}

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
        f"finite; {secs:.1f} s; K2 {k['K2']}, K8 {k['K8']} launches "
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


def _sharded_in_turns(label: str, fn, state, call, substeps: int, n: int,
                      card: str, short=None) -> dict:
    """A parallel step ``fn`` (every shard on this card: a captured CUDA
    graph) in turns with its eager twin ``fn.eager`` from ``state``
    (``_in_turns``; ``call(run, state) → state`` steps a frame through
    ``run``; ``short``: ``(step, substeps)``, a twin of fewer substeps a
    frame to profile): every frame bit for bit, no host read captured,
    launches of the two kinds equal, one capture in all (the key met
    before the turns or in their first frame)."""
    def steps(f):
        return {"captured": lambda st: call(f, st),
                "eager": lambda st: call(f.eager, st)}

    turns = _in_turns(f"phase 14 {label}", steps(fn), state, n, substeps,
                      card, short=None if short is None
                      else (steps(short[0]), short[1]))
    counts = turns["counts"]
    if counts["captured"] != counts["eager"]:
        raise AssertionError(f"phase 14 {label}: launches captured "
                             f"{counts['captured']}, eager "
                             f"{counts['eager']}")
    stats = fn.stats()
    if stats["captures"] != 1 or stats["graphs"] != 1:
        raise AssertionError(f"phase 14 {label}: graph stats {stats}")
    return dict(turns, stats=stats)


def _log_sharded_turns(label: str, turns: dict, rate_one: float, card: str,
                       extra: str = "") -> None:
    r, p = turns["rate"], turns["prof"]
    log(f"phase 14 {label}: captured {r['captured']:.1f}, eager "
        f"{r['eager']:.1f} substeps/s in turns ({r['captured'] / r['eager']:.2f}"
        f"x), unsharded {rate_one:.1f} in this run; launches a substep "
        f"captured {p['captured']['per_substep']:.1f}, eager "
        f"{p['eager']['per_substep']:.1f}; device idle share captured "
        f"{p['captured']['idle']:.2f} (within the profiled span "
        f"{p['captured']['idle_span']:.2f}), eager {p['eager']['idle']:.2f};"
        f" graph stats {turns['stats']}, 0 host reads captured{extra} on "
        f"{card}")


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
    captured: frames 1-3 (the first captures), bit for bit against the
    single-device ``lattice_frame`` over the same frames; then in turns
    with its eager twin."""
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
    _frames(step, SHARD_FRAMES_A)
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
    turns = _sharded_in_turns(
        "path A in 4 slabs", fn, box[0], lambda run, st: run(st, consts, uin),
        cfg.subticks, SHARD_TURN_FRAMES["path A"], card,
        short=(lattice_spatial_frame_fn(spec, _short(cfg), mesh),
               SHARD_PROFILE_SUBSTEPS))
    rate_one = substeps / (sum(ms_one) / 1e3)
    _log_sharded_turns(f"path A in 4 slabs ({spec.width}x{spec.height}, "
                       f"frames 1-{SHARD_FRAMES_A} captured, K3 {k3} "
                       "launches = 4 per substep, equal to lattice_frame "
                       "bit for bit)", turns, rate_one, card)
    return dict(k3=k3, rate=turns["rate"]["captured"],
                rate_eager=turns["rate"]["eager"], rate_one=rate_one,
                turns=turns)


def run_sharded_path_b(dev, card: str) -> dict:
    """Path B in 4 slabs: ``fused_spatial`` over 1×4 on the default scene
    (K4 on each slab every substep, a ghost ring of the stencil's reach),
    captured: frames 1-8 (the first captures), bit for bit against the
    single-device ``fused_frame``; K4's device time per substep on the 4
    slabs against the whole lattice's; then in turns with its eager
    twin."""
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
    _frames(step, SHARD_FRAMES_B)
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
    turns = _sharded_in_turns("path B in 4 slabs", fn, box[0],
                              lambda run, st: run(st, im, consts, uin),
                              cfg.subticks, SHARD_TURN_FRAMES["path B"], card)
    rate_one = substeps / (sum(ms_one) / 1e3)
    _log_sharded_turns(
        f"path B in 4 slabs ({spec.width}x{spec.height}, slabs of {w_loc} + "
        f"2x{ring} ghost columns, frames 1-{SHARD_FRAMES_B} captured, K4 "
        f"{k4} launches = 4 per substep, equal to fused_frame bit for bit)",
        turns, rate_one, card, extra=f"; K4 device ms per substep: 4 slabs "
        f"{k4_slabs:.4f}, whole lattice {k4_one:.4f} (ratio "
        f"{k4_slabs / k4_one:.3f})")
    return dict(k4=k4, rate=turns["rate"]["captured"],
                rate_eager=turns["rate"]["eager"], rate_one=rate_one,
                k4_slabs=k4_slabs, k4_one=k4_one, turns=turns)


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
    # one frame op by op: the captured step is held to it in turns
    h, o = fn.eager(h, o, im, ec, consts, tb.UserInput())
    return interiors(h, w_loc, hot.device), far_stats()


def run_sharded_bench(dev, card: str, bench_rate: float) -> dict:
    """The bench scene far-armed in 2 slabs (``fused_spatial2``, the bench
    far spec, a rebuild every 8 substeps: K1 on each slab every substep,
    K2 on each slab every rebuild), captured: frames 1-2 warm (the first
    captures), frames 3-10 counted; a finite state, far_overflow 0 and
    far pairs; then in turns with its eager twin.  Then one frame from
    the single-device ``fused_frame4``'s frame 9 in 1 and in 2 slabs
    against its own frame 10, and that frame through the far apply's
    128-lane records (``far_mb=128``: K7 at 128 lanes) against 32."""
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
    turns = _sharded_in_turns(
        "bench scene far-armed in 2 slabs", fn, box[0],
        lambda run, st: run(st[0], st[1], im, ec, consts, uin),
        cfg.subticks, SHARD_TURN_FRAMES["bench"], card)
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
    mb = check_far_mb_frame10(hot9, obs9, state, spec, cfg, consts, ff,
                              card)
    rate_one = SHARD_PARITY_FRAME * cfg.subticks / (sum(ms_one) / 1e3)
    _log_sharded_turns(
        f"bench scene far-armed in 2 slabs (frames 3-{warm + timed} "
        f"captured, {rate:.1f} substeps/s; K1 {k1} launches = 2 per "
        f"substep, K2 {k2} = 2 per rebuild, far record {stats})", turns,
        rate_one, card,
        extra=f"; the bench path (phase 6) {bench_rate:.1f} substeps/s; "
        f"frame {SHARD_PARITY_FRAME + 1} from fused_frame4's frame "
        f"{SHARD_PARITY_FRAME} against its own: 1 slab {errs[1]}, 2 slabs "
        f"{errs[2]} (limits {SHARD_BENCH_ATOL}), the control with the far "
        f"field off {ctl}; 1 and 2 slabs "
        f"{'bit-identical' if same_1_2 else 'not bit-identical'}")
    return dict(k1=k1, k2=k2, rate=turns["rate"]["captured"],
                rate_eager=turns["rate"]["eager"], rate_one=rate_one,
                errs=errs, ctl=ctl, same_1_2=same_1_2, stats=stats,
                turns=turns, mb=mb)


def check_far_mb_frame10(hot9, obs9, state, spec, cfg, consts, ff,
                         card: str) -> dict:
    """Frame 10 of the bench scene from the single-device frame 9 through
    ``FusedLatticeBackend(far_mb=PROBE_MB)`` (JAX's default variants, its
    drop rule taking krec out) and ``far_mb=64``, op by op: finite,
    ``far_overflow`` 0, far pairs, K7 at 128 lanes launched once per
    mirror-route apply, the two frames equal bit for bit (the wider
    records only add +0.0 terms to each sum; ``far_mb=32``, the card's
    default layout, takes K8, which adds each side's terms in another
    order)."""
    uin = tb.UserInput()
    ls9 = unpack_lattice2(hot9, obs9, state)
    out, k7, routes, far = {}, {}, {}, {}
    for mb in (PROBE_MB, 64):
        be = _eager_twin(FusedLatticeBackend(spec, cfg, farfield=ff,
                                             far_buckets=FAR_BUCKETS,
                                             far_mb=mb, device=hot9.device))
        packed = be.pack_state(ls9)
        r0, n0 = dict(farfield4.APPLY_ROUTES), recmirror.K7_LAUNCHES
        out[mb] = be.step(packed, consts, uin)
        torch.cuda.synchronize()
        k7[mb] = recmirror.K7_LAUNCHES - n0
        routes[mb] = {k: v - r0[k] for k, v in farfield4.APPLY_ROUTES.items()}
        far[mb] = be.far_stats()
        if mb == PROBE_MB and "krec" in be.kvar:
            raise AssertionError(f"far_mb={mb}: kvar {be.kvar} keeps krec")
    hot = out[PROBE_MB][0]
    f = far[PROBE_MB]
    if (not bool(torch.isfinite(hot[:6]).all()) or f["far_overflow"]
            or not f["far_pairs"] or k7[PROBE_MB] != routes[PROBE_MB]["mirror"]
            or not k7[PROBE_MB]):
        raise AssertionError(f"far_mb={PROBE_MB} frame 10: far stats {f}, "
                             f"K7 {k7}, routes {routes}")
    same = _same(out[PROBE_MB], out[64])
    if not same:
        raise AssertionError(f"far_mb={PROBE_MB} frame 10 differs from "
                             "far_mb=64's")
    log(f"phase 14 far_mb={PROBE_MB}: bench frame 10 from frame 9 through "
        f"FusedLatticeBackend(far_mb={PROBE_MB}) op by op: finite, far "
        f"stats {f}, K7 {k7[PROBE_MB]} launches at {PROBE_MB} lanes (one per "
        f"mirror-route apply: {routes[PROBE_MB]}), equal to far_mb=64 bit "
        f"for bit on {card}")
    return dict(k7=k7[PROBE_MB], stats=f)


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
    """The general engine sharded, each step captured: config 3 (the 100k
    self-colliding cloth, grid) over sp = 4, one frame against the
    single-device frame; config 1 ``cloth(32, 32)`` × 2 worlds over a 2×4
    dp×sp mesh; and ``batched_frame_fn`` on ``multi_blob(64)`` × 4 worlds
    over dp = 4, each world bit for bit its own single-device frame; each
    then in turns with its eager twin."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    t = [time.perf_counter()]

    def lap():
        t.append(time.perf_counter())
        return round(t[-1] - t[-2], 1)

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

    _frames(step, 1)
    errs3 = _general_errs(unshard_state(box[0]), one[0])
    _hold_general("config 3 over sp = 4", errs3)
    turns3 = _sharded_in_turns(
        "general config 3 over sp = 4", fn, box[0],
        lambda run, s_: run(s_, consts, uin), cfg.subticks,
        SHARD_TURN_FRAMES["config 3"], card,
        short=(spatial_frame_fn(_short(cfg), mesh), SHARD_PROFILE_SUBSTEPS))
    rate_one = cfg.subticks / (sum(ms_one) / 1e3)
    _log_sharded_turns(f"general engine config 3 over sp = 4 (frame 1 "
                       f"captured, max |err| {errs3} against the "
                       "single-device frame)", turns3, rate_one, card)
    parts = {"config 3": lap()}

    # config 1 x 2 worlds over dp x sp = 2 x 4
    w1, cfg1 = scenes.cloth(32, 32, device=dev)
    worlds = [pad_state_for_mesh(w, 4) for w in (w1, _stirred_world(w1, 1))]
    mesh8 = _shard_mesh(dev, 8, dp=2)
    fn1 = spatial_frame_fn(cfg1, mesh8, dp_axis="dp")
    sh1 = fn1(shard_state(stack_states(worlds), mesh8, dp_axis="dp"),
              consts, uin)
    out = unstack_states(unshard_state(sh1))
    ms1, errs1 = [], []
    for g, w in zip(out, worlds):
        ref_box = [w]

        def step_w(ref_box=ref_box):
            ref_box[0] = gstep.frame(ref_box[0], consts, uin, cfg1)

        ms1 += _frames(step_w, 1)
        errs1.append(_general_errs(g, ref_box[0]))
    for e in errs1:
        _hold_general("config 1 x 2 worlds over 2x4", e)
    turns1 = _sharded_in_turns(
        "general config 1 x 2 worlds over dp x sp = 2x4", fn1, sh1,
        lambda run, s_: run(s_, consts, uin), cfg1.subticks,
        SHARD_TURN_FRAMES["config 1"], card,
        short=(spatial_frame_fn(_short(cfg1), mesh8, dp_axis="dp"),
               SHARD_PROFILE_SUBSTEPS))
    rate_one1 = cfg1.subticks / (sum(ms1) / len(ms1) / 1e3)
    _log_sharded_turns(f"general config 1 x 2 worlds over dp x sp = 2x4 "
                       f"(frame 1 captured, max |err| {errs1}; rates over "
                       "both worlds, unsharded one world)", turns1,
                       rate_one1, card)
    parts["config 1"] = lap()

    # multi_blob(64) x 4 worlds over dp = 4
    w4, cfg4 = scenes.multi_blob(64, device=dev)
    worlds4 = [_stirred_world(w4, s_) for s_ in range(4)]
    mesh4 = _shard_mesh(dev, 4, dp=4)
    fn4 = batched_frame_fn(cfg4, mesh4)
    b4 = fn4(device_put_batched(stack_states(worlds4), mesh4), consts, uin)
    outs = unstack_states(b4)
    ms4 = []
    for i, (g, w) in enumerate(zip(outs, worlds4)):
        ref_box = [w]

        def step_w(ref_box=ref_box):
            ref_box[0] = gstep.frame(ref_box[0], consts, uin, cfg4)

        ms4 += _frames(step_w, 1)
        r = ref_box[0]
        diff = _tensors_differ([(k, getattr(g, k), getattr(r, k)) for k in
                                ("pos", "vel", "acc", "beam_alive",
                                 "beam_target_length")])
        if diff:
            raise AssertionError(f"multi_blob(64) world {i} of the batch "
                                 f"differs from its own frame: {diff}")
    fn4_s = batched_frame_fn(_short(cfg4), mesh4)
    turns4 = _sharded_in_turns(
        "multi_blob(64) x 4 worlds over dp = 4", fn4, b4,
        lambda run, s_: run(s_, consts, uin), 4 * cfg4.subticks,
        SHARD_TURN_FRAMES["multi_blob"], card,
        short=(fn4_s, 4 * SHARD_PROFILE_SUBSTEPS))
    # frame 1, the turns' untimed frame and two captured turns: a replay
    # a device's batch each
    if fn4.stats()["replays"] != 4 * (2 + 2 * SHARD_TURN_FRAMES[
            "multi_blob"]):
        raise AssertionError(f"multi_blob batch: graph stats "
                             f"{fn4.stats()} (one graph, a replay a "
                             "device's batch)")
    rate_one4 = cfg4.subticks / (sum(ms4) / len(ms4) / 1e3)
    _log_sharded_turns("multi_blob(64) x 4 worlds over dp = 4 (frame 1 "
                       "captured, each world equal to its own frame bit for "
                       "bit; substeps over the 4 worlds, unsharded one "
                       "world)", turns4, rate_one4, card)
    parts["multi_blob"] = lap()
    log(f"phase 14 general parts (s): {parts}")
    return {"config 3": turns3, "config 1": turns1, "multi_blob": turns4}


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
    fn(sh, consts, uin)     # the capture; the frame timed replays
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
    general = run_sharded_general(dev, card)
    parts["general"] = lap()
    run_sharded_dryrun(dev, card)
    parts["dryrun"] = lap()
    log(f"phase 14 parallel: {t[-1] - t[0]:.1f} s ({parts})")
    turns = {"path A in 4 slabs": a["turns"], "path B in 4 slabs":
             b["turns"], "bench scene in 2 slabs": bench["turns"],
             "config 3 over sp = 4": general["config 3"],
             "config 1 x 2 over 2x4": general["config 1"],
             "multi_blob(64) x 4 over dp = 4": general["multi_blob"]}
    return {"launches": {"K1": bench["k1"], "K2": bench["k2"],
                         "K3": a["k3"], "K4": b["k4"]},
            "turns": turns, "mb": bench["mb"]}


# ---------------------------------------------------------------------------
# phase 15: the fused backend's other far modes (K1's trig, detect and
# knobs instances)


def _k1_mode_instances() -> tuple:
    """K1's mode instances by name (fused_substep2.k1_instance)."""
    return (("strict+trig", "strict+trig+detect")
            + tuple(f"{a}+detect" for a in K1_INSTANCES)
            + tuple(f"{a}+knobs" for a in K1_INSTANCES))


def _extras(hot, alive, radius: float, skin: float, dt: float, *,
            t_band: float, det: float = 1.0, tau: float = 0.0):
    """The far-field scalars of a K1 call with trig or detect (CPU
    float32 [8]): the band's mean velocity of ``hot``, T_band, the base
    reach 2r + skin."""
    n = alive.sum().clamp(min=1).to(torch.float32)
    vbar = torch.stack([torch.where(alive, hot[VX], 0.0).sum() / n,
                        torch.where(alive, hot[VY], 0.0).sum() / n]).tolist()
    return torch.tensor([tau, det, vbar[0], vbar[1], t_band,
                         2.0 * radius + skin, 2.0 * dt, 0.0],
                        dtype=torch.float32)


def _hold_trig(label, got, ref, vx, vy, alive) -> None:
    """The trig statistics: maxima bit for bit, sums within TRIG_SUM_RTOL
    of the sums of |v| (their order differs)."""
    if int(_differs(got[:2], ref[:2]).sum()):
        raise AssertionError(f"{label}: trig maxima {got[:2].tolist()} vs "
                             f"plain {ref[:2].tolist()}")
    scale = torch.stack([torch.where(alive, vx.abs(), 0.0).sum(),
                         torch.where(alive, vy.abs(), 0.0).sum()])
    if not bool(((got[2:] - ref[2:]).abs() <= TRIG_SUM_RTOL * scale).all()):
        raise AssertionError(f"{label}: trig sums {got[2:].tolist()} vs "
                             f"plain {ref[2:].tolist()} (scale "
                             f"{scale.tolist()})")


def check_k1_modes(w: int, h: int, dev) -> dict:
    """K1's mode instances against the plain version with the same flags
    at ``w × h`` on the stirred lattice: trig and trig+detect (strict) at
    stencils 1, 2 x quantized/float x observing on/off; detect in each
    arithmetic instance at stencils 1, 2 x quantized/float; the knobs in
    each (nospring, noint, both; stencil 2).  Every state and obs plane
    and the side planes bit for bit, the trig maxima too, the trig sums
    within TRIG_SUM_RTOL.  Returns the largest |err| per instance."""
    state, cfg, consts, g = _k14_state(w, h, dev, SEED + 7 + w + h)
    hot, obs, immut, ec = pack_lattice2(state)
    alive = immut[0] > 0
    spacing = 980.0 / max(max(w, h) - 1, 1)
    base = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    refs = (hot[:4] + torch.randn((4, w, h), generator=g, device=dev)
            * 0.1 * spacing).contiguous()
    worst = dict.fromkeys(_k1_mode_instances(), 0.0)
    cases = []
    for s, q, observe in itertools.product((1, 2), (True, False),
                                           (False, True)):
        for det in (False, True):
            cases.append(("strict+trig" + ("+detect" if det else ""),
                          dict(stencil=s, quantized=q, refs=refs,
                               detect=det, obs_in=obs if observe else None)))
    for (name, (rq, rg)), s, q in itertools.product(
            K1_INSTANCES.items(), (1, 2), (True, False)):
        cases.append((f"{name}+detect", dict(stencil=s, quantized=q,
                                              detect=True, rsqrt=rq,
                                              rollgroup=rg)))
    for (name, (rq, rg)), (ns, ni) in itertools.product(
            K1_INSTANCES.items(), ((True, False), (False, True),
                                   (True, True))):
        cases.append((f"{name}+knobs", dict(stencil=2, quantized=True,
                                             nospring=ns, noint=ni,
                                             obs_in=obs, rsqrt=rq,
                                             rollgroup=rg)))
    flagged = 0
    for name, kw in cases:
        modes = kw.get("refs") is not None or kw.get("detect", False)
        cvec = base
        if modes:
            cvec = torch.cat([base, _extras(
                hot, alive, cfg.particle_radius, 0.75 * spacing, cfg.dt,
                t_band=9 * cfg.dt, tau=cfg.dt)])
        kw = dict(far=far, **kw)
        ref = fused_substep2_plain(hot, immut, cvec, **kw)
        got = fused_substep2_call(hot, immut, cvec, **kw)
        torch.cuda.synchronize()
        ref = list(ref) if isinstance(ref, tuple) else [ref]
        got = list(got) if isinstance(got, tuple) else [got]
        label = f"K1 {name} {w}x{h} {kw['stencil']=} {kw['quantized']=}"
        if kw.get("refs") is not None:
            i = 2 if kw.get("obs_in") is not None else 1
            _hold_trig(label, got.pop(i), ref.pop(i), got[0][VX],
                       got[0][VY], alive)
        if kw.get("detect"):
            flagged += int(ref[-1][8].sum())
        for a, b in zip(got, ref):
            n_bad = int(_differs(a, b).sum())
            if n_bad:
                raise AssertionError(f"{label}: {n_bad} values differ from "
                                     "the plain version")
            worst[name] = max(worst[name], (a[torch.isfinite(b)] - b[
                torch.isfinite(b)]).abs().max().item() if b.numel() else 0.0)
    if not flagged:
        raise AssertionError(f"K1 detect {w}x{h}: no band flag set")
    log(f"K1 modes {w}x{h}: {len(cases)} cases ({', '.join(worst)}): state, "
        f"obs and side planes and trig maxima bit-exact, trig sums within "
        f"{TRIG_SUM_RTOL} of the sums of |v| ({flagged} band-flagged row "
        f"groups)")
    return worst


def _detect_bound(hot, immut, cvec, s: int, side_cells: int) -> tuple:
    """K1's detect instance: K1's bytes plus the side planes written;
    K1's operations plus 7 per band pair the data needs (up to each
    cell's first hit) and ~8 per cell for its deviation and row-group
    reduces."""
    alive = immut[0] > 0
    ex = cvec[40:].tolist()
    ddx, ddy = hot[VX] - ex[X_VBX], hot[VY] - ex[X_VBY]
    dev = torch.where(alive, sqrt32(ddx * ddx + ddy * ddy) * ex[X_TBAND],
                      0.0)
    n = alive.numel()
    pairs = _band_pairs_evaluated(hot[PX], hot[PY], dev, ex[5] + dev, alive,
                                  FarFieldSpec().band_half_offsets(s))
    n_bytes = (18 + 2 + 5 + 18) * 4 * n + 9 * 4 * side_cells
    return n_bytes, _substep_ops(n, s) + 7 * pairs + 8 * n


def _time_instance(label, fn, plain, bound) -> dict:
    """Device ms of ``fn`` (one K1 call), host-paced ms of its plain
    version, and its bound."""
    ms = _device_ms(fn, 50)
    plain_ms = _timed_ms(plain, 3)
    _log_bound(label, *bound)
    b = _bound(*bound)
    log(f"{label}: {ms:.4f} ms (plain {plain_ms:.2f} ms), bound "
        f"{b[0]:.4f} ms ({b[1]}), {b[0] / ms:.2f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1]}


def _gate_detect_run(mode: str, r: dict, k1: dict, want: dict) -> None:
    """A finite state, no overflow, K1 by instance as ``want``, K2 once a
    frame (kernel detection: block 0's side planes) or once a rebuild
    (xla), K8 in the far applies (K7 never)."""
    hot = r["box"][0][0]
    want_k2 = TIMED_FRAMES if mode == "kernel" else r["stats"]["far_rebuilds"]
    if (not bool(torch.isfinite(hot[:6]).all())
            or r["stats"]["far_overflow"] or k1 != want
            or r["k2"] != want_k2 or not r["k8"] or r["k7"]):
        raise AssertionError(f"kernel detect, {mode}: far stats "
                             f"{r['stats']}, K1 {k1} (want {want}), K2 "
                             f"{r['k2']} (want {want_k2}), K8 {r['k8']}, "
                             f"K7 {r['k7']}")


def run_kernel_detect(state, spec, cfg, consts, spacing, card,
                      parent=None) -> dict:
    """The bench scene through ``FusedLatticeBackend(far_detect=
    "kernel")`` (the default variants: K1 rsqrt+rollgroup, and its detect
    instance at each block's last substep but the frame's last; K2 once a
    frame for block 0's side planes; K8 per apply with pairs) and with
    xla detection, frames 3-10 in turns (xla, kernel, kernel, xla), the
    launch counts from 0 before each turn; then frame 10 of both from the
    xla path's frame 9; then the detect instance timed at the final
    state.  Gates: equal rebuilds, no overflow, finite state, the launch
    counts, and frame 10's first VARIANT_SUBSTEPS substeps within
    VARIANT_ATOL.  ``parent``: the default + detect instance also timed
    beside the parent's (``_turns``)."""
    uin = tb.UserInput()
    ff = _far_spec(spacing)
    runs = {}
    for mode in ("xla", "kernel"):
        be = FusedLatticeBackend(spec, cfg, farfield=ff, far_detect=mode,
                                 device=state.pos.device)
        box = [be.pack_state(state)]
        for _ in range(WARM_FRAMES):
            box[0] = be.step(box[0], consts, uin)
        be.far_stats()
        runs[mode] = dict(be=be, box=box, ms=0.0, reads=0,
                          k1=dict.fromkeys(
                              fused_substep2.K1_INSTANCE_LAUNCHES, 0),
                          k2=0, k7=0, k8=0)
    for mode in ("xla", "kernel", "kernel", "xla"):
        r = runs[mode]
        _zero_k1_k2_k7()
        reads0 = compiled.HOST_READS

        def step(r=r):
            r["box"][0] = r["be"].step(r["box"][0], consts, uin)

        r["ms"] += sum(_frames(step, TIMED_FRAMES // 2))
        r["reads"] += compiled.HOST_READS - reads0
        compiled.sync_counts()
        for k, v in fused_substep2.K1_INSTANCE_LAUNCHES.items():
            r["k1"][k] += v
        r["k2"] += band_detect.K2_LAUNCHES
        r["k7"] += recmirror.K7_LAUNCHES
        r["k8"] += _k8_launches()
    substeps = TIMED_FRAMES * cfg.subticks
    blocks = cfg.subticks // ff.horizon
    for mode, r in runs.items():
        r["stats"] = r["be"].far_stats()
        r["rate"] = substeps / (r["ms"] / 1000.0)
        n_det = TIMED_FRAMES * (blocks - 1) if mode == "kernel" else 0
        k1 = {k: v for k, v in r["k1"].items() if v}
        want = {"rsqrt+rollgroup": substeps - n_det}
        if n_det:
            want["rsqrt+rollgroup+detect"] = n_det
        _gate_detect_run(mode, r, k1, want)
        idle, per = _idle_and_launches(lambda r=r: r["box"].__setitem__(
            0, r["be"].step(r["box"][0], consts, uin)), cfg.subticks)
        r["idle"], r["launches_per_substep"] = idle, per
        log(f"phase 15 bench scene, {mode} detection: frames 3-10 "
            f"{r['rate']:.1f} substeps/s; far stats {r['stats']}; K1 {k1}, "
            f"K2 {r['k2']}, K8 {r['k8']}; {r['reads'] / substeps:.3f} host "
            f"reads and {per:.1f} launches per substep, device idle share "
            f"{idle:.2f} (one profiled frame) on {card}")
    if runs["kernel"]["stats"]["far_rebuilds"] != \
            runs["xla"]["stats"]["far_rebuilds"]:
        raise AssertionError(f"kernel detect: rebuilds "
                             f"{runs['kernel']['stats']} vs "
                             f"{runs['xla']['stats']}")

    # frame 10 of both from one frame 9 (frames 1-9 anew, xla detection),
    # in kernel detection's variants (krec dropped)
    be9 = FusedLatticeBackend(spec, cfg, farfield=ff, device=state.pos.device,
                              far_detect="kernel")
    hot9, obs9 = be9.pack_state(state)
    for _ in range(9):
        hot9, obs9 = fused_frame4(hot9, obs9, be9._immut, be9._edge_consts,
                                  consts, uin, spec, cfg, ff,
                                  kvar=be9.kvar)[:2]
    ulp = hot9.clone()
    ulp[VX] = torch.nextafter(ulp[VX], torch.full_like(ulp[VX], math.inf))

    def frame(mode, n_sub, hot=hot9):
        h, _o, st = fused_frame4(hot.clone(), obs9.clone(), be9._immut,
                                 be9._edge_consts, consts, uin, spec, cfg,
                                 ff, n_sub=n_sub, detect_mode=mode,
                                 kvar=be9.kvar)
        return h, st.tolist()

    def diff(a, b):
        return {"pos": (a[0:2] - b[0:2]).abs().max().item(),
                "vel": (a[2:4] - b[2:4]).abs().max().item(),
                "edges alive differ": int((a[8::3] != b[8::3]).sum())}

    out = {}
    for n_sub in (VARIANT_SUBSTEPS, 16, cfg.subticks):
        ref, st_x = frame("xla", n_sub)
        got, st_k = frame("kernel", n_sub)
        out[n_sub] = {"kernel": diff(got, ref), "stats": (st_k, st_x),
                      "xla, vx one ulp up": diff(frame("xla", n_sub,
                                                       ulp)[0], ref)}
        if not bool(torch.isfinite(got[:6]).all()) or st_k[2]:
            raise AssertionError(f"bench frame 10, kernel detect, {n_sub} "
                                 f"substeps: stats {st_k}")
    errs = out[VARIANT_SUBSTEPS]["kernel"]
    if not (errs["pos"] <= VARIANT_ATOL["pos"]
            and errs["vel"] <= VARIANT_ATOL["vel"]
            and errs["edges alive differ"] == 0):
        raise AssertionError(f"bench frame 10, kernel vs xla detection, "
                             f"{VARIANT_SUBSTEPS} substeps: {errs}")
    log(f"phase 15 bench frame 10 from one frame 9, kernel vs xla "
        f"detection (kvar {be9.kvar}): first {VARIANT_SUBSTEPS} substeps "
        f"{errs} (within {VARIANT_ATOL}); by substeps run {out}")

    # the detect instance at the kernel path's final state
    be = runs["kernel"]["be"]
    hot, _obs = runs["kernel"]["box"][0]
    immut = be._immut
    alive = immut[0] > 0
    s = spec.collision_stencil
    fl = rebuild_far_list_planes(hot[PX], hot[PY], alive, vx=hot[VX],
                                 vy=hot[VY], dt=cfg.dt, s=s, ff=ff,
                                 radius=cfg.particle_radius)
    far = bucketed_far_delta_planes(
        hot, immut[0], fl, fl.counts()[0], s=s, ff=ff,
        radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
        friction=consts.friction, buckets=FAR_BUCKETS)
    cvec = torch.cat([tb.consts_vector(consts, uin, cfg, spec.height),
                      be._edge_consts, _extras(
                          hot, alive, cfg.particle_radius, ff.skin, cfg.dt,
                          t_band=(ff.horizon + 1) * cfg.dt)])
    w4 = -(-spec.width // 4) * spec.height
    timing = {}
    for name, (rq, rg) in K1_INSTANCES.items():
        kw = dict(stencil=s, quantized=True, far=far, detect=True,
                  rsqrt=rq, rollgroup=rg)
        timing[f"{name}+detect"] = _time_instance(
            f"K1 {name}+detect at the kernel-detect final state",
            lambda kw=kw: fused_substep2_call(hot, immut, cvec, **kw),
            lambda kw=kw: fused_substep2_plain(hot, immut, cvec, **kw),
            _detect_bound(hot, immut, cvec, s, w4))
    if _has_mode_entry(parent):
        timing["rsqrt+rollgroup+detect"]["compare"] = _turns(
            lambda: _raw_k1m(parent, hot, immut, cvec, s, far, None, True,
                             1, 1),
            lambda: _raw_k1m(_lib.library(), hot, immut, cvec, s, far, None,
                             True, 1, 1), 50)
    return dict(rate=runs["kernel"]["rate"], rate_xla=runs["xla"]["rate"],
                k1=runs["kernel"]["k1"], k2=runs["kernel"]["k2"],
                k7=runs["kernel"]["k7"], k8=runs["kernel"]["k8"],
                timing=timing, frame10=out,
                reads=runs["kernel"]["reads"] / substeps,
                per_substep=runs["kernel"]["launches_per_substep"],
                idle=runs["kernel"]["idle"])


def run_v3(state, spec, cfg, consts, spacing, card, parent=None) -> dict:
    """The bench scene through ``FusedLatticeBackend(far_mode="v3")`` with
    bench.py's v3 far field: two frames, then frames 3-10 with the launch
    counts from 0 (K1 in its strict trig instances only, one per
    substep: JAX's triggered frame runs strict; K2 and K7 none, the
    carried side planes came from K2 in frame 1), the rebuilds per
    frame, host reads and launches per substep; then the trig instances
    timed at the final state (beside the parent's, ``_turns``, where
    ``parent`` is given).  Gate: a finite state."""
    uin = tb.UserInput()
    ff = FarFieldSpec(skin=1.5 * spacing, **V3_FF)
    be = FusedLatticeBackend(spec, cfg, farfield=ff, far_mode="v3",
                             device=state.pos.device)
    box = [be.pack_state(state)]

    def step():
        box[0] = be.step(box[0], consts, uin)

    for _ in range(WARM_FRAMES):
        step()
    first = be.far_stats()
    _zero_k1_k2_k7()
    reads0 = compiled.HOST_READS
    per_frame, ms = [], []
    for _ in range(TIMED_FRAMES):
        ms += _frames(step, 1)
        per_frame.append(be.far_stats())
    reads = compiled.HOST_READS - reads0
    compiled.sync_counts()
    substeps = TIMED_FRAMES * cfg.subticks
    k1 = {k: v for k, v in fused_substep2.K1_INSTANCE_LAUNCHES.items() if v}
    hot = box[0][0]
    if (not bool(torch.isfinite(hot[:6]).all())
            or sum(k1.values()) != substeps
            or set(k1) - {"strict+trig", "strict+trig+detect"}
            or band_detect.K2_LAUNCHES or _far_launches()):
        raise AssertionError(f"v3: K1 {k1}, K2 {band_detect.K2_LAUNCHES}, "
                             f"K7 or K8 {_far_launches()}")
    rate = substeps / (sum(ms) / 1000.0)
    idle, per = _idle_and_launches(step, cfg.subticks)
    log(f"phase 15 bench scene, far_mode v3 ({ff}): frames 1-2 {first}; "
        f"frames 3-10 {rate:.1f} substeps/s, frame ms "
        f"{[round(x, 1) for x in ms]}; per frame "
        f"{[(d['far_rebuilds'], d['far_pairs'], d['far_overflow']) for d in per_frame]}"
        f" (rebuilds, max pairs, overflow); K1 {k1}; {reads / substeps:.3f} "
        f"host reads and {per:.1f} launches per substep, device idle share "
        f"{idle:.2f} (one profiled frame) on {card}")
    # the trig instances at the final state, on the carried list's refs
    immut = be._immut
    alive = immut[0] > 0
    fl = be._far_list
    refs = torch.stack([fl.px_ref, fl.py_ref, fl.vx_ref, fl.vy_ref])
    cvec = torch.cat([tb.consts_vector(consts, uin, cfg, spec.height),
                      be._edge_consts, _extras(
                          hot, alive, cfg.particle_radius, ff.skin, cfg.dt,
                          t_band=(ff.horizon + 1) * cfg.dt, tau=cfg.dt)])
    s = spec.collision_stencil
    n = alive.numel()
    w4 = -(-spec.width // 4) * spec.height
    timing = {}
    for det in (False, True):
        name = "strict+trig" + ("+detect" if det else "")
        kw = dict(stencil=s, quantized=True, refs=refs, detect=det)
        nb, ops = (_detect_bound(hot, immut, cvec, s, w4) if det else
                   ((18 + 2 + 5 + 18) * 4 * n, _substep_ops(n, s)))
        # no far planes here (the far apply is timed elsewhere): minus 5
        # planes read; plus the refs read and ~12 operations per cell
        timing[name] = _time_instance(
            f"K1 {name} at the v3 final state",
            lambda kw=kw: fused_substep2_call(hot, immut, cvec, **kw),
            lambda kw=kw: fused_substep2_plain(hot, immut, cvec, **kw),
            (nb - 5 * 4 * n + 4 * 4 * n, ops + 12 * n))
        if _has_mode_entry(parent):
            timing[name]["compare"] = _turns(
                lambda det=det: _raw_k1m(parent, hot, immut, cvec, s, None,
                                         refs, det, 0, 0),
                lambda det=det: _raw_k1m(_lib.library(), hot, immut, cvec, s,
                                         None, refs, det, 0, 0), 50)
    return dict(rate=rate, k1=k1, timing=timing, reads=reads / substeps,
                per_substep=per, idle=idle, per_frame=per_frame)


def run_knobs(state, spec, cfg, consts, card) -> dict:
    """The knobs (not physics), as scripts/bench_sweep.py runs them: one
    frame of the bench scene without far field through
    ``FusedLatticeBackend(kernel_variants=knobs)`` per KNOB_RUNS entry,
    the launch counts from 0 (K1's strict knobs instance once per
    substep), then each timed at that frame's state beside strict K1 at
    the same stencil: the split of K1's time into springs, collisions
    and the bare pipe."""
    uin = tb.UserInput()
    timing = {}
    n = spec.width * spec.height
    for label, s, kvar in KNOB_RUNS:
        sp = dataclasses.replace(spec, collision_stencil=s)
        be = FusedLatticeBackend(sp, cfg, device=state.pos.device,
                                 kernel_variants=kvar)
        box = [be.pack_state(state)]
        _zero_k1_k2_k7()
        box[0] = be.step(box[0], consts, uin)
        compiled.sync_counts()
        k1 = {k: v for k, v in fused_substep2.K1_INSTANCE_LAUNCHES.items()
              if v}
        if k1 != {"strict+knobs": cfg.subticks}:
            raise AssertionError(f"knobs {label}: K1 {k1}")
        hot, _obs = box[0]
        cvec = torch.cat([tb.consts_vector(consts, uin, cfg, spec.height),
                          be._edge_consts])
        kw = dict(stencil=s, quantized=True, nospring="nospring" in kvar,
                  noint="noint" in kvar)
        t = _time_instance(
            f"K1 strict+knobs {label} (stencil {s}, {kvar})",
            lambda kw=kw: fused_substep2_call(hot, be._immut, cvec, **kw),
            lambda kw=kw: fused_substep2_plain(hot, be._immut, cvec, **kw),
            ((18 + 2 + 18) * 4 * n,
             _substep_ops(n, s) - (0 if "noint" not in kvar else 60 * n)
             - 4 * (16 + 8 + 11) * n))
        t["strict_ms"] = _device_ms(lambda: fused_substep2_call(
            hot, be._immut, cvec, stencil=s, quantized=True), 50)
        t["launches"] = k1["strict+knobs"]
        timing[label] = t
    log("phase 15 knobs, device ms at stencil 2 / 0: " + ", ".join(
        f"{k} {v['ms']:.4f} (strict {v['strict_ms']:.4f})"
        for k, v in timing.items()) + f" on {card}")
    return dict(timing=timing)


def _far_modes_fold(dev) -> dict:
    """The folded strip on ``dev``, strict: two frames of the backend in
    the triggered mode and with kernel detection, one
    ``fused_frame2_far`` frame from a rebuilt list, two
    ``fused_frame2_auto`` frames; far stats and (pos, vel) on the host."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    ff = FarFieldSpec(max_pairs=64, max_tile_pairs=32, skin=4.0, horizon=8)
    out = {}
    for label, kw in (("v3", dict(far_mode="v3")),
                      ("kernel detect", dict(far_detect="kernel"))):
        be = FusedLatticeBackend(spec, cfg, farfield=ff, device=dev,
                                 kernel_variants=(), **kw)
        st = be.pack_state(_hairpin(dev))
        for _ in range(2):
            st = be.step(st, consts, uin)
        out[label] = (be.far_stats(), st[0][0:4])
    hot, obs, immut, ec = pack_lattice2(_hairpin(dev))
    fl = rebuild_far_list_packed2(hot, immut, s=2, ff=ff, radius=4.0)
    h2, _o = fused_frame2_far(hot, obs, immut, ec, fl, consts, uin, spec,
                              cfg, ff, kvar=())
    out["fused_frame2_far"] = ({"far_pairs": fl.counts()[0]}, h2[0:4])
    fl = empty_far_list(96, 4, ff, device=dev)
    st3 = [0, 0, 0]
    for _ in range(2):
        hot, obs, fl, st = fused_frame2_auto(hot, obs, immut, ec, fl, consts,
                                             uin, spec, cfg, ff)
        st = st.tolist()
        st3 = [st3[0] + st[0], max(st3[1], st[1]), max(st3[2], st[2])]
    out["fused_frame2_auto"] = (dict(zip(("far_rebuilds", "far_pairs",
                                          "far_overflow"), st3)), hot[0:4])
    return {k: (s, p.reshape(2, 2, 96, 4).cpu()) for k, (s, p) in out.items()}


def check_far_modes_fold() -> None:
    """The folded strip on the card against the CPU (plain versions) in
    the triggered mode, with kernel detection, ``fused_frame2_far`` and
    ``fused_frame2_auto``: far pairs found, positions and velocities
    within 5e-3 / 5e-2 (the far apply's sum order and the band's mean
    velocity differ)."""
    cpu, gpu = _far_modes_fold("cpu"), _far_modes_fold("cuda")
    for k, (s_g, pv_g) in gpu.items():
        s_c, pv_c = cpu[k]
        dpos = (pv_g[0] - pv_c[0]).abs().max().item()
        dvel = (pv_g[1] - pv_c[1]).abs().max().item()
        if not s_g["far_pairs"] or not (dpos <= 5e-3 and dvel <= 5e-2):
            raise AssertionError(f"far modes fold, {k}: cuda {s_g} vs cpu "
                                 f"{s_c}, |dpos| {dpos} |dvel| {dvel}")
        log(f"phase 15 fold 96x4, {k}: cuda vs cpu plain, far stats cuda "
            f"{s_g} cpu {s_c}; max |dpos| {dpos:.3g}, |dvel| {dvel:.3g}")


def _has_mode_entry(parent) -> bool:
    return parent is not None and hasattr(parent, "sb_fused_substep2_mode")


# K1's mode instances whose detect pass (K2's band search) and trig
# reduction (warp shuffles) were redesigned for the H100
REDESIGNED = ("rsqrt+rollgroup+detect", "strict+trig", "strict+trig+detect")


def _log_redesigned(inst: dict, card: str) -> None:
    """The redesigned instances' device ms against their bounds and the
    loss a frame, (ms - bound) x launches a frame, of this tree and (in
    turns on the same inputs) of the parent."""
    for name in REDESIGNED:
        row = inst[name]
        per_frame = row["launches"] / TIMED_FRAMES
        msg = (f"phase 15 {name}: {row['ms']:.4f} ms against a bound of "
               f"{row['bound_ms']:.4f} ({row['bound_ms'] / row['ms']:.2f} of "
               f"it), {per_frame:.2f} launches a frame, loss a frame "
               f"{(row['ms'] - row['bound_ms']) * per_frame:.3f} ms")
        if "compare" in row:
            p, c = row["compare"]["parent"], row["compare"]["this"]
            pm, cm = sum(p) / 2, sum(c) / 2
            msg += (f"; in turns parent {p[0]:.4f}, this {c[0]:.4f}, this "
                    f"{c[1]:.4f}, parent {p[1]:.4f} (parent / this "
                    f"{pm / cm:.3f}; loss a frame parent "
                    f"{(pm - row['bound_ms']) * per_frame:.3f} ms, this "
                    f"{(cm - row['bound_ms']) * per_frame:.3f} ms)")
        log(msg + f" on {card}")


def run_far_modes(dev, card, parent=None) -> dict:
    """Phase 15: K1's mode instances against their plain versions, the
    fold card vs CPU, then the bench scene with kernel detection and in
    the triggered mode (the redesigned instances timed at their final
    states, beside ``parent``'s where given), then the knobs."""
    t0 = time.perf_counter()
    errs = dict.fromkeys(_k1_mode_instances(), 0.0)
    for w, h in K1_MODE_SHAPES:
        for k, e in check_k1_modes(w, h, dev).items():
            errs[k] = max(errs[k], e)
    check_far_modes_fold()
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    kd = run_kernel_detect(state, spec, cfg, consts, spacing, card, parent)
    v3 = run_v3(state, spec, cfg, consts, spacing, card, parent)
    knobs = run_knobs(state, spec, cfg, consts, card)
    log(f"phase 15 far modes: {time.perf_counter() - t0:.1f} s")
    inst = {}
    for name in _k1_mode_instances():
        if name.endswith("+knobs"):
            continue
        src = kd if name.endswith("+detect") and "trig" not in name else v3
        launches = (kd["k1"].get(name, 0) if src is kd
                    else v3["k1"].get(name, 0))
        row = {"launches": launches, "max_abs_err": errs[name]}
        row.update(src["timing"].get(name, {}))
        inst[name] = row
    for label, t in knobs["timing"].items():
        inst[f"strict+knobs {label}"] = dict(
            t, max_abs_err=errs["strict+knobs"])
    for name in K1_INSTANCES:
        if name != "strict":   # held against the plain version only
            inst[f"{name}+knobs"] = {"launches": 0,
                                     "max_abs_err": errs[f"{name}+knobs"]}
    _log_redesigned(inst, card)
    for name in REDESIGNED:
        cmp = inst[name].pop("compare", None)
        if cmp is not None:
            inst[name]["parent_ms"] = sum(cmp["parent"]) / 2
    return dict(instances=inst, kd=kd, v3=v3, knobs=knobs)


# ---------------------------------------------------------------------------
# phase 16: the compiled frames (ops/compiled.py: frames captured into CUDA
# graphs and replayed), each against the same frame run op by op on the
# card, bit for bit


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    """Every tensor of two states equal bit for bit (NaN payloads too)."""
    ta, tb_ = list(compiled.tensors(a)), list(compiled.tensors(b))
    return len(ta) == len(tb_) and all(torch.equal(_bits(x), _bits(y))
                                       for x, y in zip(ta, tb_))


def _turns_ms(fns: dict, n: int) -> dict:
    """Frame ms (CUDA events) of ``fns["eager"]`` and ``fns["captured"]``
    in turns: eager, captured, captured, eager, ``n`` frames each."""
    ms = {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        ms[kind] += _frames(fns[kind], n)
    return ms


def _rates(ms: dict, substeps: int) -> dict:
    return {k: len(v) * substeps / (sum(v) / 1e3) for k, v in ms.items()}


def _in_turns(label: str, steps: dict, state, n: int, substeps: int,
              card: str, extra=None, short=None) -> dict:
    """A captured frame (``steps["captured"]``, state -> state) against
    its eager twin (``steps["eager"]``) from the same ``state``: one
    untimed frame of each (the captured one's first call captures where
    its key is new), then in turns: eager, captured, captured, eager,
    ``n`` frames each, each kind continuing its own trajectory.  Every
    captured frame equal to the eager frame of the same index bit for bit
    (``extra()`` of each kind's step, when given, too: the stats it
    accumulated), no host read in a captured turn
    (``compiled.HOST_READS``), launches a substep and idle from one
    profiled frame of each (continuing, and held equal after); ``short``:
    ``(steps, substeps)``, twins of fewer substeps a frame profiled on
    the states reached instead (where a whole eager frame launches some
    10^5 kernels).  Returns the rates, reads, profiles, the launches the
    host counted for each kind (``counts``; a captured frame's
    conditional bodies count on the device, ``compiled.sync_counts``)
    and the captured final state."""
    counts = {"captured": {}, "eager": {}}

    def run(kind, st):
        before = compiled.read_counts()
        out = steps[kind](st)
        _add_delta(counts[kind], compiled._count_delta(
            compiled.read_counts(), before))
        return out

    box = {k: run(k, state) for k in ("captured", "eager")}
    if not _same(box["captured"], box["eager"]):
        raise AssertionError(f"{label}: the first captured frame differs "
                             "from the eager frame")
    rec = {k: dict(frames=[], ms=[], reads=0) for k in box}
    for kind in ("eager", "captured", "captured", "eager"):
        r = rec[kind]
        reads0 = compiled.HOST_READS

        def step(kind=kind, r=r):
            box[kind] = run(kind, box[kind])
            r["frames"].append((box[kind], extra(kind) if extra else None))

        r["ms"] += _frames(step, n)
        r["reads"] += compiled.HOST_READS - reads0
    for i, (c, e) in enumerate(zip(rec["captured"]["frames"],
                                   rec["eager"]["frames"])):
        if not _same(c, e):
            raise AssertionError(f"{label}: captured frame {i + 1} differs "
                                 "from the eager frame")
    if rec["captured"]["reads"]:
        raise AssertionError(f"{label}: {rec['captured']['reads']} host "
                             "reads in the captured frames")
    rate = _rates({k: r["ms"] for k, r in rec.items()}, substeps)

    if short is None:
        def stepper(kind):
            def step():
                box[kind] = run(kind, box[kind])
            return step

        prof = {k: profile_frame(f"{label}, {k}", stepper(k),
                                 sum(rec[k]["ms"]) / (2 * n), substeps)
                for k in ("eager", "captured")}
        if not _same(box["captured"], box["eager"]):
            raise AssertionError(f"{label}: the profiled frames differ")
    else:
        twins, sub = short
        prof = {}
        for k in ("captured", "eager"):
            def one(k=k):
                twins[k](box[k])
            one()      # a captured twin captures here
            prof[k] = profile_frame(f"{label}, {k}, {sub} substeps", one,
                                    _frames(one, 1)[0], sub)
    reads_e = rec["eager"]["reads"] / (2 * n * substeps)
    log(f"{label}, captured against eager in turns ({2 * n} frames each): "
        f"every frame equal bit for bit; eager {rate['eager']:.1f}, "
        f"captured {rate['captured']:.1f} substeps/s "
        f"({rate['captured'] / rate['eager']:.2f}x); launches a substep "
        f"eager {prof['eager']['per_substep']:.1f}, captured "
        f"{prof['captured']['per_substep']:.1f} (one profiled frame); idle "
        f"eager {prof['eager']['idle']:.2f}, captured "
        f"{prof['captured']['idle']:.2f}; host reads a substep eager "
        f"{reads_e:.3f}, captured 0; frame ms " + "; ".join(
            f"{k} {[round(x, 2) for x in r['ms']]}" for k, r in rec.items())
        + f" on {card}")
    return dict(rate=rate, prof=prof, reads_eager=reads_e,
                state=box["captured"], counts=counts)


def _profile_replay(label: str, step, frame_ms: float, substeps: int,
                    fns) -> dict:
    """``profile_frame`` of a frame that only replays: a frame that
    captures (a chunk length or list capacity met for the first time)
    runs its warm-up op by op under the profiler and is profiled again,
    up to three times."""
    for _ in range(3):
        before = sum(f.stats()["captures"] for f in fns)
        prof = profile_frame(label, step, frame_ms, substeps)
        if sum(f.stats()["captures"] for f in fns) == before:
            return prof
    raise AssertionError(f"{label}: every profiled frame captured")


def run_compiled_general(dev, card: str) -> dict:
    """BASELINE configs 1, 4 and 3 through ``frame_jit`` from a cleared
    cache: the first call (warm-up, capture, replay) timed and held
    against ``frame`` bit for bit; frames in turns with ``frame``; the
    two trajectories still equal after the turns; one capture for all of
    it; one eager and one replayed frame under the profiler."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    gstep.frame_jit.clear()
    out = {}
    for (label, build, _n, _warm), n in zip(GENERAL_CONFIGS,
                                            COMPILED_TURN_FRAMES):
        st, cfg = build(dev)
        before = gstep.frame_jit.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = gstep.frame_jit(st, consts, uin, cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        e = gstep.frame(st, consts, uin, cfg)
        if not _same(c, e):
            raise AssertionError(f"compiled {label}: the first captured "
                                 "frame differs from the eager frame")
        box = {"captured": c, "eager": e}
        fns = {"captured": lambda: box.__setitem__("captured", gstep.frame_jit(
                   box["captured"], consts, uin, cfg)),
               "eager": lambda: box.__setitem__("eager", gstep.frame(
                   box["eager"], consts, uin, cfg))}
        ms = _turns_ms(fns, n)
        if not _same(box["captured"], box["eager"]):
            raise AssertionError(f"compiled {label}: after {4 * n} frames "
                                 "in turns the trajectories differ")
        captures = gstep.frame_jit.stats()["captures"] - before["captures"]
        if captures != 1:
            raise AssertionError(f"compiled {label}: {captures} captures")
        rate = _rates(ms, cfg.subticks)
        prof = {k: profile_frame(f"compiled {label}, {k}", fns[k],
                                 sum(ms[k]) / len(ms[k]), cfg.subticks)
                for k in ("eager", "captured")}
        log(f"compiled {label}: first call (warm-up, capture, replay) "
            f"{first_ms:.1f} ms, captured == eager bit for bit, and after "
            f"{2 * n} frames each in turns; eager {rate['eager']:.1f}, "
            f"captured {rate['captured']:.1f} substeps/s "
            f"({rate['captured'] / rate['eager']:.2f}x); device ms a "
            f"substep eager {prof['eager']['busy_ms'] / cfg.subticks:.4f}, "
            f"captured {prof['captured']['busy_ms'] / cfg.subticks:.4f}; "
            f"idle eager {prof['eager']['idle']:.2f}, captured "
            f"{prof['captured']['idle']:.2f}; launches a substep "
            f"{prof['eager']['per_substep']:.1f} / "
            f"{prof['captured']['per_substep']:.1f} on {card}")
        out[label.split()[1]] = dict(rate=rate, prof=prof,
                                     first_ms=first_ms)
    return out


def run_compiled_drag(dev, card: str) -> dict:
    """A mouse drag on ``cloth(32, 32)``: DRAG_FRAMES frames, each with a
    new mouse position and velocity, through ``frame_jit`` from a cleared
    cache: one capture (the user input is lifted into the graph's inputs,
    as ``jax.jit`` traces it) and DRAG_FRAMES replays, the frames equal to
    ``frame``'s bit for bit; the same drag again replays with no miss."""
    consts = tb.PhysicsConstants()
    st, cfg = scenes.cloth(32, 32, device=dev)
    st = gstep.frame(st, consts, tb.UserInput(), cfg)
    uins = [tb.UserInput(mouse_active=True, mouse_pos=(300.0 + 25.0 * i,
                                                       600.0),
                         mouse_vel=(50.0, -12.5 * i))
            for i in range(DRAG_FRAMES)]

    def drag(frame):
        s = st
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for u in uins:
            s = frame(s, consts, u, cfg)
        torch.cuda.synchronize()
        return s, DRAG_FRAMES / (time.perf_counter() - t0)

    gstep.frame_jit.clear()
    before = gstep.frame_jit.stats()
    got, fps = drag(gstep.frame_jit)
    after = gstep.frame_jit.stats()
    misses = after["misses"] - before["misses"]
    replays = after["replays"] - before["replays"]
    ref, fps_eager = drag(gstep.frame)
    again, fps_cached = drag(gstep.frame_jit)
    misses_again = gstep.frame_jit.stats()["misses"] - before["misses"]
    if not (_same(got, ref) and _same(again, ref)):
        raise AssertionError("compiled drag: the captured frames differ "
                             "from the eager frames")
    if misses != 1 or replays != DRAG_FRAMES or misses_again != 1:
        raise AssertionError(f"compiled drag: {misses} misses and "
                             f"{replays} replays, then {misses_again}")
    log(f"compiled drag, cloth(32, 32): {DRAG_FRAMES} frames each with a "
        f"new mouse position and velocity, {misses} miss (one capture) and "
        f"{replays} replays at {fps:.2f} frames/s, the first call's capture "
        f"included; eager {fps_eager:.2f} frames/s; the same drag again, "
        f"replayed, {fps_cached:.2f} frames/s; captured == eager bit for "
        f"bit on {card}")
    return {"fps": fps, "fps_eager": fps_eager, "fps_cached": fps_cached,
            "misses": misses}


def check_compiled_alternating(dev, card: str) -> None:
    """Two states through the same captured frame in turns (one graph):
    every returned state equal to its own eager trajectory after all the
    calls."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    a, cfg = scenes.cloth(32, 32, device=dev)
    runs = {"a": [a], "b": [_stirred_world(a, SEED + 16)]}
    before = gstep.frame_jit.stats()
    for _ in range(2):
        for k in runs:
            runs[k].append(gstep.frame_jit(runs[k][-1], consts, uin, cfg))
    for k, states in runs.items():
        ref = states[0]
        for i, got in enumerate(states[1:], 1):
            ref = gstep.frame(ref, consts, uin, cfg)
            if not _same(got, ref):
                raise AssertionError(f"compiled, two states: state {k} "
                                     f"frame {i} differs from eager")
    st = gstep.frame_jit.stats()
    log(f"compiled, two states in turns through one graph: each of 4 "
        f"returned states equal to its eager trajectory bit for bit "
        f"({st['captures'] - before['captures']} captures, "
        f"{st['replays'] - before['replays']} replays) on {card}")


def run_compiled_path_a(dev, card: str) -> dict:
    """Path A (``LatticeBackend`` with ``use_pallas`` and ``FarFieldSpec
    ()`` on the 1M tearing cloth) through its compiled chunks, from
    cleared caches, against the same backend stepping op by op
    (``_frame`` / ``_frame_far`` set to the plain functions): each frame
    equal bit for bit with the same far stats and chunks, K3 64 a
    captured frame; then a frame a turn (eager, captured, captured,
    eager); one captured frame under the profiler; the memory reserved
    after the graphs."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    uin = tb.UserInput()
    lattice_frame_jit.clear()
    lattice_frame_far_jit.clear()
    before = {f.__name__: f.stats() for f in (lattice_frame_jit,
                                              lattice_frame_far_jit)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    be = {"captured": LatticeBackend(spec, cfg, farfield=FarFieldSpec(),
                                     device=dev),
          "eager": LatticeBackend(spec, cfg, farfield=FarFieldSpec(),
                                  device=dev)}
    be["eager"]._frame = lattice_frame
    be["eager"]._frame_far = lattice_frame_far
    box = {"captured": state, "eager": state}
    del state
    fns = {k: (lambda k=k: box.__setitem__(k, be[k].step(box[k], consts,
                                                          uin)))
           for k in be}
    first = {"eager": [], "captured": []}
    k3 = []
    for i in range(COMPILED_PATH_A_FRAMES):
        collide_stencil.K3_LAUNCHES = 0
        first["captured"] += _frames(fns["captured"], 1)
        k3.append(collide_stencil.K3_LAUNCHES)
        first["eager"] += _frames(fns["eager"], 1)
        if not _same(box["captured"], box["eager"]):
            raise AssertionError(f"compiled path A: frame {i + 1} differs "
                                 "from the eager backend's")
    stats = {k: b.far_stats() for k, b in be.items()}
    if (k3 != [cfg.subticks] * COMPILED_PATH_A_FRAMES
            or stats["captured"] != stats["eager"]
            or be["captured"].far_chunks != be["eager"].far_chunks
            or stats["captured"]["far_overflow"]):
        raise AssertionError(f"compiled path A: K3 {k3}, far stats {stats},"
                             f" chunks {be['captured'].far_chunks} / "
                             f"{be['eager'].far_chunks}")
    ms = _turns_ms(fns, 1)
    if not _same(box["captured"], box["eager"]):
        raise AssertionError("compiled path A: the frames in turns differ")
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    graphs = {f.__name__: {k: v - before[f.__name__][k] if k != "graphs"
                           else v for k, v in f.stats().items()}
              for f in (lattice_frame_jit, lattice_frame_far_jit)}
    rate = _rates(ms, cfg.subticks)
    prof = _profile_replay("compiled path A, captured", fns["captured"],
                           sum(ms["captured"]) / 2, cfg.subticks,
                           (lattice_frame_jit, lattice_frame_far_jit))
    profile_frame("compiled path A, eager", fns["eager"],
                  sum(ms["eager"]) / 2, cfg.subticks)
    log(f"compiled path A: frames 1-{COMPILED_PATH_A_FRAMES} captured ms "
        f"{[round(t, 1) for t in first['captured']]} (K3 {k3}), eager ms "
        f"{[round(t, 1) for t in first['eager']]}, each frame equal bit for "
        f"bit, far stats {stats['captured']}, {be['captured'].far_chunks} "
        f"chunks; then in turns eager {rate['eager']:.1f}, captured "
        f"{rate['captured']:.1f} substeps/s "
        f"({rate['captured'] / rate['eager']:.2f}x); graphs {graphs}; "
        f"memory reserved {reserved / 2**30:.2f} GiB "
        f"({(reserved - reserved0) / 2**30:.2f} GiB over the cleared "
        f"caches) on {card}")
    return {"rate": rate, "prof": prof, "k3": sum(k3),
            "reserved_gib": reserved / 2**30,
            "graphs_gib": (reserved - reserved0) / 2**30}


def check_compiled_fold(dev, card: str) -> None:
    """The small fold, far-armed with one list, through
    ``lattice_frame_far_jit`` with K3: two calls (capture, replay) equal
    to ``lattice_frame_far`` bit for bit, K3 once a substep a call."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0, use_pallas=True)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    st = _hairpin(dev)
    fl = rebuild_far_list(st.pos, st.alive, s=2, ff=ff, radius=4.0)
    pairs = fl.counts()[0]
    k3 = 0
    c = e = st
    for i in range(2):
        before = collide_stencil.K3_LAUNCHES
        c = lattice_frame_far_jit(c, fl, consts, uin, spec, cfg, ff)
        k3 += collide_stencil.K3_LAUNCHES - before
        e = lattice_frame_far(e, fl, consts, uin, spec, cfg, ff)
        if not _same(c, e):
            raise AssertionError(f"compiled fold: call {i + 1} differs")
    if pairs == 0 or k3 != 2 * cfg.subticks:
        raise AssertionError(f"compiled fold: {pairs} far pairs, K3 {k3} "
                             "in the captured calls")
    log(f"compiled fold 96x4 ({pairs} far pairs): lattice_frame_far_jit == "
        f"lattice_frame_far bit for bit over 2 calls, K3 {k3} on {card}")


def run_compiled_directed(dev, card: str) -> dict:
    """The compiled ``directed_frame`` at config 3 (the 100k
    self-colliding cloth's directed tables) against its loop
    (``directed_frame.__wrapped__``): the first call equal bit for bit,
    and the trajectories equal after a frame a turn (eager, captured,
    captured, eager)."""
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    flat, cfg = scenes.self_colliding_cloth(PLANIFIED_N, device=dev)
    ds, _slot_edge = build_directed(flat)
    eager = directed_frame.__wrapped__
    box = {"captured": directed_frame(ds, consts, uin, cfg),
           "eager": eager(ds, consts, uin, cfg)}
    if not _same(box["captured"], box["eager"]):
        raise AssertionError("compiled directed config 3: the first "
                             "captured frame differs")
    fns = {"captured": lambda: box.__setitem__("captured", directed_frame(
               box["captured"], consts, uin, cfg)),
           "eager": lambda: box.__setitem__("eager", eager(
               box["eager"], consts, uin, cfg))}
    rate = _rates(_turns_ms(fns, 1), cfg.subticks)
    if not _same(box["captured"], box["eager"]):
        raise AssertionError("compiled directed config 3: the frames in "
                             "turns differ")
    log(f"compiled directed config 3: captured == eager bit for bit over 3 "
        f"frames; in turns eager {rate['eager']:.1f}, captured "
        f"{rate['captured']:.1f} substeps/s on {card}")
    return rate


def run_compiled_runtime(dev, card: str) -> dict:
    """The engines a user drives, now stepping captured frames on their
    worker thread (captures there too) while this thread polls: ``Engine``
    on ``cloth(32, 32)`` and ``LatticeEngine`` on path A (K3 64 a
    frame), each in windows alone, polled, polled, alone: frames/s,
    packet latency, packets bitwise equal to a clone of their frame."""
    out = {}
    consts = tb.PhysicsConstants()
    st, cfg = scenes.cloth(32, 32, device=dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         collision_mode=cfg.collision_mode, target_fps=None)
    engines = [("general", lambda: Engine(st, consts, opts, device=dev))]
    lstate, spec, lcfg, lconsts = tearing_cloth_lattice(
        n_particles=N_PARTICLES, device=dev)
    lopts = EngineOptions(subticks=lcfg.subticks,
                          particle_radius=lcfg.particle_radius,
                          use_pallas=True, target_fps=None)
    engines.append(("path A", lambda: LatticeEngine(
        lstate, spec, lconsts, lopts, farfield=FarFieldSpec(), device=dev)))
    for label, make in engines:
        collide_stencil.K3_LAUNCHES = 0
        with make() as eng:
            far = {}
            kept = _witness(eng)
            f = _wait_frames(eng, 1, far).frame_index
            win = _alone_and_polled(eng, f, COMPILED_RUNTIME_FRAMES[label],
                                    far, f"compiled runtime, {label}")
            frames = _pause(eng, far)
            k3 = collide_stencil.K3_LAUNCHES
            _check_packets(win["packets"], kept, win["seen"],
                           f"compiled runtime, {label}")
            if eng.error is not None:
                raise AssertionError(f"compiled runtime, {label}: "
                                     f"{eng.error!r}")
        if label == "path A" and k3 != lcfg.subticks * frames:
            raise AssertionError(f"compiled runtime, path A: {frames} "
                                 f"frames, K3 {k3}")
        lat = sorted(win["lat"])
        out[label] = dict(fps_alone=win["fps_alone"],
                          fps_polled=win["fps_polled"],
                          lat_median=lat[len(lat) // 2], lat_max=lat[-1])
        log(f"compiled runtime, {label}: {frames} frames on the worker "
            f"thread, {win['fps_alone']:.3f} frames/s alone, "
            f"{win['fps_polled']:.3f} polled flat-out ({len(lat)} packets, "
            f"latency median {out[label]['lat_median']:.2f} ms, max "
            f"{out[label]['lat_max']:.1f} ms; {len(win['packets'])} packets "
            f"bitwise equal to their frame's positions); K3 {k3}, far stats "
            f"over the reads {far} on {card}")
    del lstate
    return out


def run_compiled(dev, card: str) -> dict:
    """Phase 16: the compiled frames against eager (see the functions)."""
    laps = [time.perf_counter()]
    parts = {}

    def lap(name):
        laps.append(time.perf_counter())
        parts[name] = round(laps[-1] - laps[-2], 1)

    out = {"general": run_compiled_general(dev, card)}
    lap("general")
    out["drag"] = run_compiled_drag(dev, card)
    check_compiled_alternating(dev, card)
    lap("drag, two states")
    out["path A"] = run_compiled_path_a(dev, card)
    lap("path A")
    check_compiled_fold(dev, card)
    out["directed"] = run_compiled_directed(dev, card)
    lap("fold, directed")
    out["runtime"] = run_compiled_runtime(dev, card)
    lap("runtime")
    log(f"phase 16 compiled: {laps[-1] - laps[0]:.1f} s ({parts})")
    return out


# ---------------------------------------------------------------------------
# phase 17: the compiled fused frames (fused_frame4_jit, fused_frame3_auto_jit,
# far3_carry_init_jit: whole frames captured into CUDA graphs, their bucket
# and trigger decided on the device by IF nodes), each against the same
# frame run op by op on the card, bit for bit


def _eager_twin(be):
    """``be`` stepping the plain frames (op by op, its decisions read on
    the host) instead of their captured counterparts."""
    be._frame4 = fused_substep2.fused_frame4
    be._frame3 = fused_substep2.fused_frame3_auto
    be._carry_init = fused_substep2.far3_carry_init
    be._frame2 = fused_substep2.fused_frame2
    return be


def _add_delta(acc: dict, delta: dict) -> None:
    for key, d in delta.items():
        name = key[1]
        if isinstance(d, dict):
            acc.setdefault(name, {})
            for i, n in d.items():
                acc[name][i] = acc[name].get(i, 0) + n
        else:
            acc[name] = acc.get(name, 0) + d


def _fused_jits():
    return (fused_substep2.fused_frame4_jit, fused_substep2.fused_frame3_auto_jit,
            fused_substep2.far3_carry_init_jit, fused_substep2.fused_frame2_jit)


def run_fused_captured_path(label: str, make, state, cfg, consts, card,
                            bench: bool, graphs: int = 1) -> dict:
    """One fused path (``make()`` builds its backend) from the scene's
    state: a captured backend and its eager twin.  Frame 1: the captured
    call (warm-up, capture, replay) timed and its memory measured (device
    memory reserved over the cleared caches, before and after); frames
    1-2 equal bit for bit; frames 3-10 in turns (eager, captured,
    captured, eager; FUSED_TURN_FRAMES frames a turn), every frame's
    state and stats accumulator equal bit for bit to the eager frame's,
    every launch counter and far-apply route equal over the turns
    (device-counted bodies folded in), no host read in a captured frame;
    ``far_overflow`` 0 on the bench path; one profiled frame each;
    ``graphs`` captures in all (v3: its carry's initialisation and its
    frame)."""
    uin = tb.UserInput()
    bes = {"captured": make(), "eager": _eager_twin(make())}
    box = {k: be.pack_state(state) for k, be in bes.items()}
    captures = sum(j.stats()["captures"] for j in _fused_jits())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    box["captured"] = bes["captured"].step(box["captured"], consts, uin)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    graphs_gib = (torch.cuda.memory_reserved() - r0) / 2**30
    box["eager"] = bes["eager"].step(box["eager"], consts, uin)
    for f in (1, 2):
        if f == 2:
            for k, be in bes.items():
                box[k] = be.step(box[k], consts, uin)
        if not (_same(box["captured"], box["eager"]) and _same(
                bes["captured"]._stats_acc, bes["eager"]._stats_acc)):
            raise AssertionError(f"fused captured, {label}: frame {f} "
                                 "differs from the eager frame")
    first = {k: be.far_stats() for k, be in bes.items()}
    if first["captured"] != first["eager"]:
        raise AssertionError(f"fused captured, {label}: frames 1-2 far "
                             f"stats {first}")
    rec = {k: dict(frames=[], ms=[], counts={}, reads=0) for k in bes}
    for kind in ("eager", "captured", "captured", "eager"):
        be, r = bes[kind], rec[kind]
        compiled.sync_counts()
        before, reads0 = compiled.read_counts(), compiled.HOST_READS

        def step(kind=kind, be=be, r=r):
            box[kind] = be.step(box[kind], consts, uin)
            r["frames"].append((box[kind], be._stats_acc))

        r["ms"] += _frames(step, FUSED_TURN_FRAMES)
        r["reads"] += compiled.HOST_READS - reads0
        compiled.sync_counts()
        _add_delta(r["counts"], compiled._count_delta(compiled.read_counts(),
                                                      before))
    n = 2 * FUSED_TURN_FRAMES
    for i, (c, e) in enumerate(zip(rec["captured"]["frames"],
                                   rec["eager"]["frames"])):
        if not _same(c, e):
            raise AssertionError(f"fused captured, {label}: frame {i + 3} "
                                 "differs from the eager frame")
    stats = {k: be.far_stats() for k, be in bes.items()}
    counts = {k: r["counts"] for k, r in rec.items()}
    if counts["captured"] != counts["eager"]:
        raise AssertionError(f"fused captured, {label}: launches "
                             f"{counts['captured']} != eager's "
                             f"{counts['eager']}")
    if rec["captured"]["reads"] or stats["captured"] != stats["eager"]:
        raise AssertionError(f"fused captured, {label}: host reads "
                             f"{rec['captured']['reads']}, far stats "
                             f"{stats}")
    if bench and (stats["captured"]["far_overflow"]
                  or not stats["captured"]["far_pairs"]):
        raise AssertionError(f"fused captured, {label}: far stats "
                             f"{stats['captured']}")
    hot = box["captured"][0]
    if not bool(torch.isfinite(hot[:6]).all()):
        raise AssertionError(f"fused captured, {label}: non-finite state")
    rate = _rates({k: r["ms"] for k, r in rec.items()}, cfg.subticks)

    def stepper(kind):
        def step():
            box[kind] = bes[kind].step(box[kind], consts, uin)
        return step

    prof = {k: profile_frame(f"fused captured, {label}, {k}", stepper(k),
                             sum(rec[k]["ms"]) / n, cfg.subticks)
            for k in ("eager", "captured")}
    if not _same(box["captured"], box["eager"]):
        raise AssertionError(f"fused captured, {label}: the profiled "
                             "frames differ")
    new = sum(j.stats()["captures"] for j in _fused_jits()) - captures
    if new != graphs:
        raise AssertionError(f"fused captured, {label}: {new} captures")
    per_frame = {k: (v if not isinstance(v, dict) else
                     {i: c / n for i, c in v.items()})
                 for k, v in counts["captured"].items()}
    log(f"fused captured, {label}: first call (warm-up, capture, replay) "
        f"{first_ms:.1f} ms, {graphs_gib:.3f} GiB reserved by it (the "
        f"graph, its bodies' pool, its static inputs and outputs and the "
        f"frame returned); frames 1-2 equal (far stats {first['captured']})"
        f"; frames 3-10 in turns, every frame's state and stats equal to "
        f"eager bit for bit; far stats {stats['captured']}; launches over "
        f"the {n} frames equal eager's: {counts['captured']}; host reads "
        f"captured 0, eager {rec['eager']['reads'] / (n * cfg.subticks):.3f}"
        f" a substep; eager {rate['eager']:.1f}, captured "
        f"{rate['captured']:.1f} substeps/s "
        f"({rate['captured'] / rate['eager']:.2f}x); device ms a substep "
        f"eager {prof['eager']['busy_ms'] / cfg.subticks:.4f}, captured "
        f"{prof['captured']['busy_ms'] / cfg.subticks:.4f} (kernel sums "
        f"under the profiler); idle against the unprofiled frame eager "
        f"{prof['eager']['idle']:.2f}, captured "
        f"{prof['captured']['idle']:.2f}; within the profiled frame's "
        f"device span eager {prof['eager']['idle_span']:.2f}, captured "
        f"{prof['captured']['idle_span']:.2f}; launches a substep "
        f"{prof['eager']['per_substep']:.1f} / "
        f"{prof['captured']['per_substep']:.1f} on {card}")
    return dict(rate=rate, prof=prof, first_ms=first_ms,
                graphs_gib=graphs_gib, counts=counts["captured"],
                per_frame=per_frame, stats=stats["captured"])


def run_fused_captured_engine(dev, card: str) -> dict:
    """``LatticeEngine(fused=True)`` on the bench scene, its worker
    stepping the captured ``fused_frame4``: windows alone, polled,
    polled, alone (frames 2-10); packets bitwise equal to a clone of
    their frame; K1 64 and K2 8 a frame; no host read in the frames."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         bounds_size=cfg.bounds_size,
                         collision_mode=cfg.collision_mode,
                         force_mode=cfg.force_mode, target_fps=None)
    far = {}
    _zero_k1_k2_k7()
    reads0 = compiled.HOST_READS
    with LatticeEngine(state, spec, consts, opts,
                       farfield=_far_spec(spacing), fused=True,
                       device=dev) as eng:
        del state
        kept = _witness(eng)
        f = _wait_frames(eng, 2, far).frame_index
        win = _alone_and_polled(eng, f, RUNTIME_FRAMES, far,
                                "fused captured engine")
        frames = _pause(eng, far)
        compiled.sync_counts()
        k1, k2 = fused_substep2.K1_LAUNCHES, band_detect.K2_LAUNCHES
        k7, k8 = recmirror.K7_LAUNCHES, _k8_launches()
        _check_packets(win["packets"], kept, win["seen"],
                       "fused captured engine")
        if eng.error is not None:
            raise AssertionError(f"fused captured engine: {eng.error!r}")
    reads = compiled.HOST_READS - reads0
    if (k1 != cfg.subticks * frames or k2 != 8 * frames or reads
            or far.get("held_overflow", 1)
            or (far["far_pairs"] > 0) != (k8 > 0) or k7):
        raise AssertionError(f"fused captured engine: {frames} frames, K1 "
                             f"{k1}, K2 {k2}, K8 {k8}, K7 {k7}, host reads "
                             f"{reads}, far stats {far}")
    lat = sorted(win["lat"])
    out = dict(fps_alone=win["fps_alone"], fps_polled=win["fps_polled"],
               lat_median=lat[len(lat) // 2], lat_max=lat[-1])
    log(f"fused captured engine 1M: {frames} frames on the worker thread, "
        f"{win['fps_alone']:.3f} frames/s alone, {win['fps_polled']:.3f} "
        f"polled flat-out ({len(lat)} packets, latency median "
        f"{out['lat_median']:.1f} ms, max {out['lat_max']:.1f} ms; "
        f"{len(win['packets'])} packets bitwise equal to their frame's "
        f"positions); K1 {k1}, K2 {k2}, K8 {k8}, host reads in the frames "
        f"{reads}; far stats over the reads {far} on {card}")
    return out


def run_fused_compiled(dev, card: str) -> dict:
    """Phase 17: the bench path's default variants and strict, kernel
    detection and v3, each captured against eager (see
    run_fused_captured_path), then the engine."""
    t0 = time.perf_counter()
    # every graph dropped, so that the pool they share is released and
    # each path's first call shows its own memory
    for j in _fused_jits() + (gstep.frame_jit, gstep.substep_jit,
                              lattice_frame_jit, lattice_frame_far_jit,
                              lattice_substep_jit, directed_frame):
        j.clear()
    gc.collect()
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    ff = _far_spec(spacing)
    paths = {
        "bench default": lambda: FusedLatticeBackend(spec, cfg, farfield=ff,
                                                     device=dev),
        "bench strict": lambda: FusedLatticeBackend(
            spec, cfg, farfield=ff, device=dev, kernel_variants=()),
        "kernel detection": lambda: FusedLatticeBackend(
            spec, cfg, farfield=ff, device=dev, far_detect="kernel"),
        "v3": lambda: FusedLatticeBackend(
            spec, cfg, farfield=FarFieldSpec(skin=1.5 * spacing, **V3_FF),
            far_mode="v3", device=dev),
    }
    out = {label: run_fused_captured_path(
        label, make, state, cfg, consts, card, bench=label != "v3",
        graphs=2 if label == "v3" else 1) for label, make in paths.items()}
    del state
    out["engine"] = run_fused_captured_engine(dev, card)
    launches = {}
    for label in paths:
        _add_delta(launches, {(None, k): v
                              for k, v in out[label]["counts"].items()})
    out["launches"] = launches
    log(f"phase 17 fused compiled: {time.perf_counter() - t0:.1f} s")
    return out


def _check_devc_case(label, w, h, dev, drag_exp, dt=None) -> dict:
    """K1, K4 and K3 through the device-constants entries (the frames'
    route: constants and user input in device memory, the pair skip the
    host's decision, ``stencil.host_decisions``) against the by-value
    entries on a stirred ``w × h`` lattice with the mouse grabbing and a
    keyboard force, bit for bit (NaN where NaN): K1 strict and
    rsqrt+rollgroup (observing, far stack), strict+trig+detect, K4
    (varied edge parameters), K3 on the interleaved views; K1 strict
    also against its plain version, K4 against its plain version (edge
    planes bit-exact, particles within K4_ATOL).  ``dt``: a substep the
    constants' clip overflows at (the skip off)."""
    state, cfg, consts, g = _k14_state(w, h, dev, SEED + 21 + w + h)
    consts = dataclasses.replace(consts, drag_exp=drag_exp)
    uin = tb.UserInput(mouse_active=True, user_strength=1.5,
                       mouse_pos=(490.0, 510.0), mouse_vel=(3.0, -1.0),
                       applied_force=(0.5, -0.25))
    base = tb.consts_vector(consts, uin, cfg, h)
    if dt is not None:
        base[1] = dt
    dec = host_decisions(cfg.particle_radius, float(base[1]), consts.ecoeff,
                         consts.friction, drag_exp)
    hot, obs, immut, ec = pack_lattice2(state)
    host = torch.cat([base, ec])
    devv = host.to(dev)
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    bad = []

    def hold(name, got, ref):
        for a, b in (zip(got, ref) if isinstance(got, tuple)
                     else ((got, ref),)):
            if int(_differs(a, b).sum()):
                bad.append(name)

    for name, flags in (("K1 strict", (False, False)),
                        ("K1 rsqrt+rollgroup", (True, True))):
        kw = dict(stencil=2, quantized=True, far=far, obs_in=obs,
                  rsqrt=flags[0], rollgroup=flags[1])
        ref = fused_substep2_call(hot, immut, host, **kw)
        got = fused_substep2_call(hot, immut, devv, skip=dec.k1_skip, **kw)
        hold(name, got, ref)
        if name == "K1 strict":
            hold("K1 strict plain", got,
                 fused_substep2_plain(hot, immut, host, **kw))
    extras = _extras(hot, immut[0] > 0, cfg.particle_radius,
                     0.75 * 980.0 / max(max(w, h) - 1, 1), cfg.dt,
                     t_band=9.0 * cfg.dt, tau=0.05, det=1.0).to(dev)
    refs = (hot[:4] + torch.randn((4, w, h), generator=g,
                                  device=dev)).contiguous()
    kw = dict(stencil=2, quantized=True, far=far, refs=refs, detect=True,
              extras=extras)
    hold("K1 strict+trig+detect", fused_substep2_call(
        hot, immut, devv, skip=dec.k1_skip, **kw),
        fused_substep2_call(hot, immut, host, **kw))
    mut, immut4 = pack_lattice(state)
    immut4[2:] *= 0.5 + torch.rand(immut4[2:].shape, generator=g, device=dev)
    kw = dict(stencil=2, quantized=True, far=far)
    got = fused_substep_call(mut, immut4, devv[:N_CONSTS],
                             skip=dec.k4_skip, **kw)
    hold("K4", got, fused_substep_call(mut, immut4, base, **kw))
    plain = fused_substep_plain(mut, immut4, base, **kw)
    if dt is None:
        hold("K4 plain edges", got[6:], plain[6:])
        _hold(f"K4 device constants {w}x{h}", got, plain)
    views = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
             state.vel[..., 1], state.alive)
    kw = dict(radius=cfg.particle_radius, dt=float(base[1]),
              ecoeff=consts.ecoeff, friction=consts.friction, stencil=2)
    hold("K3", collide_stencil_call(*views, consts=devv, skip=dec.k3_skip,
                                    **kw),
         collide_stencil_call(*views, **kw))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"device constants {label} {w}x{h} drag_exp "
                             f"{drag_exp}: {bad} differ")
    return dict(hot=hot, immut=immut, obs=obs, host=host, devv=devv,
                far=far, mut=mut, immut4=immut4, base=base, dec=dec,
                views=views, kw3=kw)


def check_device_constants(dev, card: str) -> dict:
    """K1's, K4's and K3's device-constants entries, the captured frames'
    route (``_check_devc_case``), at K14_SHAPES (1M and the edge shapes)
    for each of DEVC_DRAG_EXPS, and at 97×61 with dt = 1e-19 (the skip
    off); their instances' registers and local bytes; at 1M their device
    ms against the by-value entries', in turns."""
    t0 = time.perf_counter()
    cases = 0
    for w, h in K14_SHAPES:
        for e in DEVC_DRAG_EXPS:
            last = _check_devc_case("", w, h, dev, e)
            cases += 1
            if (w, h) == (1000, 1000) and e == 2.0:
                at_1m = last
    off = _check_devc_case("clip overflow", 97, 61, dev, 2.0, dt=1e-19)
    if off["dec"].k1_skip or off["dec"].k3_skip or off["dec"].k4_skip:
        raise AssertionError(f"device constants: dt = 1e-19 left the skip "
                             f"on {off['dec']}")
    occ = {}
    for k, kernel, mode in (("K1 strict", "fused_substep2", 0),
                            ("K1 strict+detect", "fused_substep2", 2),
                            ("K1 strict+trig", "fused_substep2", 1),
                            ("K1 strict+trig+detect", "fused_substep2", 3),
                            ("K4", "fused_substep", 0),
                            ("K3", "collide_stencil", 0)):
        occ[k] = {d: _lib.occupancy(kernel, (mode << 8) | 2, devc=d)
                  for d in (False, True)}
        log(f"  {k} s=2 registers / local bytes / blocks per SM: by value "
            + "{registers} / {local_bytes} / {blocks_per_sm}".format(
                **occ[k][False])
            + ", device constants "
            + "{registers} / {local_bytes} / {blocks_per_sm}".format(
                **occ[k][True]))
    a = at_1m
    kw1 = dict(stencil=2, quantized=True, far=a["far"], rsqrt=True,
               rollgroup=True)
    fns = {
        "K1": (lambda: fused_substep2_call(a["hot"], a["immut"], a["host"],
                                           **kw1),
               lambda: fused_substep2_call(a["hot"], a["immut"], a["devv"],
                                           skip=a["dec"].k1_skip, **kw1)),
        "K4": (lambda: fused_substep_call(a["mut"], a["immut4"], a["base"],
                                          stencil=2, quantized=True),
               lambda: fused_substep_call(a["mut"], a["immut4"],
                                          a["devv"][:N_CONSTS],
                                          skip=a["dec"].k4_skip, stencil=2,
                                          quantized=True)),
        "K3": (lambda: collide_stencil_call(*a["views"], **a["kw3"]),
               lambda: collide_stencil_call(*a["views"], consts=a["devv"],
                                            skip=a["dec"].k3_skip,
                                            **a["kw3"])),
    }
    ms = {}
    for k, (by_value, devc) in fns.items():
        t = _turns(by_value, devc, 20)
        ms[k] = {"by_value": sum(t["parent"]) / 2, "devc": sum(t["this"]) / 2}
        log(f"device constants {k} at 1M: device ms by value "
            f"{t['parent'][0]:.4f} / {t['parent'][1]:.4f}, device constants "
            f"{t['this'][0]:.4f} / {t['this'][1]:.4f} (in turns) on {card}")
    log(f"phase 18 device constants: K1 (strict, rsqrt+rollgroup, "
        f"trig+detect), K4 and K3 through their device-constants entries "
        f"bit-exact against the by-value entries at {list(K14_SHAPES)} x "
        f"drag_exp {list(DEVC_DRAG_EXPS)} ({cases} cases) and with the clip "
        f"overflowing (skip off); K1 strict bit-exact against its plain "
        f"version, K4 edge planes too, in each; "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return dict(ms=ms, occ=occ)


def _drag_input(i: int) -> tb.UserInput:
    """Frame ``i`` of the 1M drag: the mouse grabbing at a new position,
    moving."""
    return tb.UserInput(mouse_active=True,
                        mouse_pos=(420.0 + 6.0 * i, 640.0 - 4.0 * i),
                        mouse_vel=(6.0, -4.0))


def run_drag_1m(dev, card: str) -> dict:
    """The drag at 1M through ``FusedLatticeBackend`` (the bench scene,
    its default variants) from a cleared cache: DRAG_1M_FRAMES frames,
    each with the mouse grabbing at a new position; the first
    DRAG_1M_HELD frames (and their stats) held bit for bit against the
    eager twin's, the rest timed; one capture in all; the graph's memory
    (device memory reserved over the cleared caches by the first call).
    Then a second captured backend left alone (no input: the same key,
    no capture) over the same frames from the same state, timed over the
    same frame range: the sheet's cost grows frame by frame (far pairs,
    then overflow past frame ~12), so only the same frames compare."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    ff = _far_spec(spacing)
    for j in _fused_jits():
        j.clear()
    gc.collect()

    def backend():
        return FusedLatticeBackend(spec, cfg, farfield=ff, device=dev)

    bes = {"captured": backend(), "eager": _eager_twin(backend()),
           "alone": backend()}
    box = {k: be.pack_state(state) for k, be in bes.items()}
    del state
    jit = fused_substep2.fused_frame4_jit
    caps0 = jit.stats()["captures"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    reads0 = compiled.HOST_READS
    graphs_gib = None
    for i in range(DRAG_1M_HELD):
        u = _drag_input(i)
        box["captured"] = bes["captured"].step(box["captured"], consts, u)
        if graphs_gib is None:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            graphs_gib = (torch.cuda.memory_reserved() - r0) / 2**30
        box["eager"] = bes["eager"].step(box["eager"], consts, u)
        if not (_same(box["captured"], box["eager"]) and _same(
                bes["captured"]._stats_acc, bes["eager"]._stats_acc)):
            raise AssertionError(f"1M drag: frame {i} differs from the "
                                 "eager twin's")
    eager_reads = compiled.HOST_READS - reads0
    del bes["eager"], box["eager"]
    alone = tb.UserInput()
    for _ in range(DRAG_1M_HELD):
        box["alone"] = bes["alone"].step(box["alone"], consts, alone)
    # frames HELD..FRAMES in two halves, in turns: dragged, alone, alone,
    # dragged (each kind's second turn takes its second half)
    mid = (DRAG_1M_HELD + DRAG_1M_FRAMES) // 2
    halves = {k: [(DRAG_1M_HELD, mid), (mid, DRAG_1M_FRAMES)] for k in bes}
    secs = dict.fromkeys(bes, 0.0)
    reads = dict.fromkeys(bes, 0)
    for kind in ("captured", "alone", "alone", "captured"):
        f0, f1 = halves[kind].pop(0)
        reads0 = compiled.HOST_READS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(f0, f1):
            u = _drag_input(i) if kind == "captured" else alone
            box[kind] = bes[kind].step(box[kind], consts, u)
        torch.cuda.synchronize()
        secs[kind] += time.perf_counter() - t0
        reads[kind] += compiled.HOST_READS - reads0
    fps = {k: (DRAG_1M_FRAMES - DRAG_1M_HELD) / t for k, t in secs.items()}
    stats = {k: be.far_stats() for k, be in bes.items()}
    captures = jit.stats()["captures"] - caps0
    hot = box["captured"][0]
    if (captures != 1 or any(reads.values())
            or not bool(torch.isfinite(hot[:6]).all())):
        raise AssertionError(f"1M drag: {captures} captures, host reads "
                             f"{reads}, finite "
                             f"{bool(torch.isfinite(hot[:6]).all())}")
    log(f"1M drag through FusedLatticeBackend (bench default variants): "
        f"{DRAG_1M_FRAMES} frames with the mouse grabbing at a new "
        f"position each, 1 capture for the drag and a twin left alone "
        f"({graphs_gib:.3f} GiB reserved by the first call); frames "
        f"0-{DRAG_1M_HELD - 1} and their stats equal to the eager twin's "
        f"bit for bit (eager host reads {eager_reads}); frames "
        f"{DRAG_1M_HELD}-{DRAG_1M_FRAMES - 1} in two halves, in turns with "
        f"the twin left alone over the same frames: dragged "
        f"{fps['captured']:.3f}, alone {fps['alone']:.3f} frames/s "
        f"({fps['captured'] / fps['alone']:.2f}x), 0 host reads; far "
        f"stats dragged {stats['captured']}, alone {stats['alone']} on "
        f"{card}")
    return dict(fps=fps["captured"], fps_idle=fps["alone"],
                graphs_gib=graphs_gib, captures=captures)


def _engine_frames(eng, f0: int, n: int, far: dict, drag: bool) -> tuple:
    """From frame ``f0`` of ``eng``, ``n`` frames, with
    ``Engine.mouse(pos, True)`` at a new position each new frame where
    ``drag`` (the worker turns it into each frame's user input): the
    frames/s and the moves made."""
    i, last = 0, f0
    if drag:
        eng.mouse(_drag_input(0).mouse_pos, True)
    t0 = time.perf_counter()
    while last < f0 + n:
        st = eng.stats()
        for k in ("far_pairs", "far_overflow"):
            far[k] = max(far.get(k, 0), getattr(st, k))
        if st.frame_index > last:
            last = st.frame_index
            if drag:
                i += 1
                eng.mouse(_drag_input(i).mouse_pos, True)
        if eng.error is not None or time.perf_counter() > t0 + 180.0:
            raise AssertionError(f"engine drag: frame {last} "
                                 f"({eng.error!r})")
        time.sleep(0.002)
    fps = (last - f0) / (time.perf_counter() - t0)
    if drag:
        eng.mouse(_drag_input(i).mouse_pos, False)
    return fps, i


def _record_dragged(be) -> list:
    """Wrap ``be.step`` (an engine's backend, on its worker thread) to
    record the first DRAG_1M_HELD frames with the mouse active:
    ``(state taken, user input, state returned)``, cloned."""
    held, step = [], be.step

    def recording(state, consts, uin):
        keep = uin.mouse_active and len(held) < DRAG_1M_HELD
        s_in = _clone(state) if keep else None
        out = step(state, consts, uin)
        if keep:
            held.append((s_in, uin, _clone(out)))
        return out

    be.step = recording
    return held


def run_drag_engine(dev, card: str) -> dict:
    """``LatticeEngine(fused=True)`` on the bench scene from a cleared
    cache, twice from the same state: left alone, then dragged
    (``Engine.mouse(pos, True)`` at a new position each new frame), each
    timed from frame 2 over DRAG_1M_FRAMES frames (the same frames: the
    sheet's cost grows frame by frame).  One capture over both engines'
    lives, no host read in their frames, the graphs' memory.  The first
    DRAG_1M_HELD dragged frames are recorded on the worker (the state
    the frame took, the user input the worker made of the mouse, the
    state it returned) and each held bit for bit against the eager
    twin's frame on the same state and input."""
    state, spec, cfg, consts, spacing = _scene(N_PARTICLES, dev)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius,
                         bounds_size=cfg.bounds_size,
                         collision_mode=cfg.collision_mode,
                         force_mode=cfg.force_mode, target_fps=None)
    for j in _fused_jits():
        j.clear()
    gc.collect()
    jit = fused_substep2.fused_frame4_jit
    caps0 = jit.stats()["captures"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    reads0 = compiled.HOST_READS
    fps, far, moves, graphs_gib = {}, {}, 0, None
    for kind in ("alone", "dragged"):
        far[kind] = {}
        with LatticeEngine(state, spec, consts, opts,
                           farfield=_far_spec(spacing), fused=True,
                           device=dev) as eng:
            f = _wait_frames(eng, 2, far[kind]).frame_index
            if graphs_gib is None:
                graphs_gib = (torch.cuda.memory_reserved() - r0) / 2**30
            if kind == "dragged":
                held = _record_dragged(eng._worker.backend)
            fps[kind], n = _engine_frames(eng, f, DRAG_1M_FRAMES, far[kind],
                                          kind == "dragged")
            moves += n
            _pause(eng, far[kind])
            if eng.error is not None:
                raise AssertionError(f"engine drag: {eng.error!r}")
    reads = compiled.HOST_READS - reads0
    captures = jit.stats()["captures"] - caps0
    torch.cuda.synchronize()
    twin = _eager_twin(FusedLatticeBackend(spec, cfg,
                                           farfield=_far_spec(spacing),
                                           device=dev))
    twin.pack_state(state)
    del state
    if len(held) != DRAG_1M_HELD:
        raise AssertionError(f"engine drag: {len(held)} frames recorded")
    for i, (s_in, uin, s_out) in enumerate(held):
        if not _same(twin.step(s_in, consts, uin), s_out):
            raise AssertionError(f"engine drag: dragged frame {i} differs "
                                 "from the eager twin's")
    if captures != 1 or reads:
        raise AssertionError(f"engine drag: {captures} captures, {reads} "
                             "host reads")
    log(f"1M drag through LatticeEngine(fused=True), frames 2-"
        f"{2 + DRAG_1M_FRAMES} of two engines from the same state: left "
        f"alone {fps['alone']:.3f} frames/s, dragged with "
        f"Engine.mouse(pos, True) at a new position each frame ({moves} "
        f"moves) {fps['dragged']:.3f} frames/s "
        f"({fps['dragged'] / fps['alone']:.2f}x), its first "
        f"{DRAG_1M_HELD} dragged frames equal to the eager twin's bit for "
        f"bit; 1 capture over both engines ({graphs_gib:.3f} GiB reserved "
        f"by the first frames), 0 host reads in the frames; far stats over "
        f"the reads {far} on {card}")
    return dict(fps_idle=fps["alone"], fps_drag=fps["dragged"],
                graphs_gib=graphs_gib, captures=captures)


def run_drag_phase(dev, card: str) -> dict:
    """Phase 18: the constants and the user input as device buffers: K1,
    K4 and K3 through their device-constants entries, the 1M drag
    through the backend and the engine."""
    t0 = time.perf_counter()
    out = {"devc": check_device_constants(dev, card),
           "backend": run_drag_1m(dev, card),
           "engine": run_drag_engine(dev, card)}
    log(f"phase 18 drag: {time.perf_counter() - t0:.1f} s")
    return out


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
    # K1's strict mode instances at stencil 2 (the mode in the argument's
    # high byte: trig 1, detect 2, knobs 4)
    for label, mode in (("trig", 1), ("detect", 2), ("trig+detect", 3),
                        ("knobs", 4)):
        o = _lib.occupancy("fused_substep2", (mode << 8) | 2)
        log(f"  K1 strict+{label} residency at s=2: {o['blocks_per_sm']} "
            f"blocks/SM, {o['registers']} registers, {o['local_bytes']} B "
            f"local, {o['smem_bytes']} B shared")


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
    k1_errs = dict.fromkeys(K1_INSTANCES, 0.0)
    for w, h in K14_SHAPES:
        for name, e in check_k1(w, h, dev).items():
            k1_errs[name] = max(k1_errs[name], e)
        errs["K4"] = max(errs["K4"], check_k4(w, h, dev))
    errs["K1"] = k1_errs["rsqrt+rollgroup"]
    log("phases 2-3 kernels vs plain: ok")

    # phase 4: the probe (K5-K7 at the probe's and the 1M sizes)
    probe = run_probe(dev)
    errs.update(probe["errs"])

    # phase 5: small end-to-end against the plain versions on the CPU
    check_small_fold()

    # phase 6: the bench path at full size, bench.py's default variants
    # and strict in turns; frame 10 of both from one frame 9
    state, spec, cfg, consts, spacing = scenes_1m[N_PARTICLES]
    run = run_main_path(state, spec, cfg, consts, spacing)
    strict_run = run.pop("strict")
    del strict_run["be"], strict_run["packed"]
    frame10 = check_default_frame10(state, spec, cfg, consts, spacing)
    del scenes_1m, state

    # phase 7: times at the bench path's final state, kernels against
    # their plain versions
    t, bounds = time_at_final_state(run, spec, cfg, consts, parent)
    errs["K8"] = t.pop("K8 err")
    del run["be"], run["packed"]
    t.update(probe["t"])
    bounds.update(probe["bounds"])

    # phases 8-9: paths A and B at full size, then K3 and K4 timed at
    # their final states
    run_a = run_path_a(dev)
    run_b = run_path_b(dev, card)
    t_ab, bounds_ab = time_paths_kernels(run_a, run_b, parent)
    t_ab["compare"] = {**t["compare"], **t_ab["compare"]}
    t.update(t_ab)
    bounds.update(bounds_ab)
    run_a_k3, rate_a = run_a["k3"], run_a["rate"]
    run_b_k4, rate_b = run_b["k4"], run_b["rate"]
    run_b_turns = run_b["turns"]
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
    plan4 = run_planified_engine(dev, card)
    parts["config 4 engine"] = lap()
    check_planified_config4_cpu(dev)
    parts["config 4 vs cpu"] = lap()
    check_planified_fold(dev)
    parts["fold"] = lap()
    act = run_fused_activation(dev, strict_run["rate"], card)
    parts["activation"] = lap()
    log(f"phase 12 planified: {t12[-1] - t12[0]:.1f} s ({parts})")

    # phase 13: the CLI's verbs at full size (K2 and K7 counted from 0 in
    # each), the editor, the renderer and the far apply's fixed order
    t13 = time.perf_counter()
    launches_cli = run_cli(dev, card)
    log(f"phase 13 cli: {time.perf_counter() - t13:.1f} s")

    # phase 14: the parallel layer at full width, every shard on this card
    # (K3, K4, K1 and K2 counted from 0 in sub-phases 1-3)
    sharded = run_sharded(dev, card, run["rate"])
    launches_sharded = sharded["launches"]

    # phase 15: the fused backend's other far modes: K1's trig, detect
    # and knobs instances against their plain versions, the fold card vs
    # CPU, the bench scene with kernel detection (K1, K2, K7) and in the
    # triggered mode (K1), the knobs (each counted from 0)
    far_modes = run_far_modes(dev, card, parent)

    # phase 16: the compiled frames (captured CUDA graphs) against eager:
    # configs 1, 4, 3, the drag, two states in turns, path A (K3 counted
    # from 0 each frame), the fold, directed config 3, the runtime
    comp = run_compiled(dev, card)

    # phase 17: the compiled fused frames (whole-frame CUDA graphs with
    # IF nodes) against eager: the bench path default and strict, kernel
    # detection, v3 (each captured in turns with its eager twin, launches
    # equal), the engine alone and polled
    fused_comp = run_fused_compiled(dev, card)

    # phase 18: the constants and the user input as device buffers: K1,
    # K4 and K3 through their device-constants entries against the
    # by-value ones, the 1M drag through the fused backend and engine
    drag = run_drag_phase(dev, card)

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
        ("K8", "far_pairs+far_accumulate", "far_apply", "none (XLA's fusion "
         "of softbody_tpu/ops/farfield4.py's pair step)", run["k8"]),
    )
    kernels = [
        {"name": f"{k} {name}", "route": "cuda",
         "source": f"softbody_tpu_torch/csrc/{src}.cu", "replaces": tpu,
         "launches": launches, "max_abs_err": errs[k], "ms": t[k],
         "plain_ms": t[f"{k} plain"], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": t.get(f"{k} library")}
        for k, name, src, tpu, launches in rows
    ]
    # K1 per instance: launches on the bench path (the default's turns,
    # the strict turns), device ms at its final state, plain ms, max
    # |err| against the plain version
    kernels[0]["instances"] = {
        name: {"launches": run["k1_instances"][name]
               + strict_run["k1_instances"][name],
               "ms": t[f"K1 {name}"], "plain_ms": t[f"K1 {name} plain"],
               "max_abs_err": k1_errs[name]}
        for name in K1_INSTANCES}
    kernels[0]["instances"].update(far_modes["instances"])
    kd = far_modes["kd"]
    kernels[0]["launches_kernel_detect"] = sum(kd["k1"].values())
    kernels[0]["launches_v3"] = sum(far_modes["v3"]["k1"].values())
    for row in kernels:
        k = row["name"].split()[0]
        if k in ("K2", "K7", "K8"):
            row["launches_kernel_detect"] = kd[k.lower()]
        if k in ("K2", "K3", "K7", "K8"):
            row["launches_planified"] = plan[k.lower()]
        if k == "K3":
            row["launches_compiled"] = comp["path A"]["k3"]
        if k in ("K1", "K2", "K7", "K8"):
            row["launches_fused_captured"] = fused_comp["launches"].get(
                {"K1": "K1_INSTANCE_LAUNCHES", "K2": "K2_LAUNCHES",
                 "K7": "K7_LAUNCHES", "K8": "K8A_LAUNCHES"}[k], 0)
        if k in ("K2", "K7", "K8"):
            row["launches_cli"] = launches_cli[k]
        if k in launches_sharded:
            row["launches_sharded"] = launches_sharded[k]
        if k == "K7":
            # K7 at JAX's far_mb lane block: the probe's 1M grid, and the
            # bench scene's frame 10 through FusedLatticeBackend(far_mb=)
            row[f"ms_mb{PROBE_MB}"] = t[f"K7 probe mb{PROBE_MB}"]
            row[f"bound_ms_mb{PROBE_MB}"] = bounds[
                f"K7 probe mb{PROBE_MB}"][0]
            row[f"launches_far_mb{PROBE_MB}"] = sharded["mb"]["k7"]
        if k in drag["devc"]["ms"]:
            # the device-constants entry, the captured frames' route, at
            # 1M (K1 rsqrt+rollgroup, K4, K3; phase 18)
            row["ms_devc"] = drag["devc"]["ms"][k]["devc"]
            row["ms_by_value_turns"] = drag["devc"]["ms"][k]["by_value"]
    log(f"path A rate: {rate_a:.1f} substeps/s, path B rate: "
        f"{rate_b:.1f} substeps/s on {card}")
    log(f"bench path, default variants (bench.py's): {run['rate']:.1f} "
        f"substeps/s, K1 rsqrt+rollgroup {t['K1 rsqrt+rollgroup']:.4f} ms; "
        f"strict in turns: {strict_run['rate']:.1f} substeps/s, K1 strict "
        f"{t['K1 strict']:.4f} ms; frame 10 from one frame 9, default vs "
        f"strict by substeps run {frame10} on {card}")
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
    v3 = far_modes["v3"]
    log(f"far modes on the bench scene: kernel detection {kd['rate']:.1f} "
        f"substeps/s (xla detection in turns {kd['rate_xla']:.1f}), "
        f"{kd['reads']:.3f} host reads and {kd['per_substep']:.1f} launches "
        f"per substep; v3 {v3['rate']:.1f} substeps/s, {v3['reads']:.3f} "
        f"host reads and {v3['per_substep']:.1f} launches per substep; K1 "
        "mode instances " + ", ".join(
            f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f})"
            for k, v in far_modes["instances"].items() if "ms" in v)
        + f" on {card}")
    gen = comp["general"]
    log("compiled frames (phase 16), eager -> captured substeps/s: "
        + ", ".join(f"config {k} {v['rate']['eager']:.1f} -> "
                    f"{v['rate']['captured']:.1f} (idle "
                    f"{v['prof']['eager']['idle']:.2f} -> "
                    f"{v['prof']['captured']['idle']:.2f})"
                    for k, v in gen.items())
        + f", path A {comp['path A']['rate']['eager']:.1f} -> "
        f"{comp['path A']['rate']['captured']:.1f} (captured idle "
        f"{comp['path A']['prof']['idle']:.2f}; graphs "
        f"{comp['path A']['graphs_gib']:.2f} GiB), directed config 3 "
        f"{comp['directed']['eager']:.1f} -> "
        f"{comp['directed']['captured']:.1f}; drag {comp['drag']['fps']:.2f}"
        f" frames/s ({comp['drag']['misses']} miss; eager "
        f"{comp['drag']['fps_eager']:.2f}, replayed "
        f"{comp['drag']['fps_cached']:.2f}); runtime frames/s alone / polled"
        + "".join(f", {k} {v['fps_alone']:.2f} / {v['fps_polled']:.2f}"
                  for k, v in comp["runtime"].items())
        + f" on {card}")
    log("compiled fused frames (phase 17), eager -> captured substeps/s: "
        + ", ".join(f"{k} {v['rate']['eager']:.1f} -> "
                    f"{v['rate']['captured']:.1f} (idle in the device "
                    f"span {v['prof']['eager']['idle_span']:.2f} -> "
                    f"{v['prof']['captured']['idle_span']:.2f}; first call "
                    f"{v['first_ms']:.0f} ms; {v['graphs_gib']:.2f} GiB)"
                    for k, v in fused_comp.items()
                    if k not in ("engine", "launches"))
        + f"; engine frames/s alone / polled "
        f"{fused_comp['engine']['fps_alone']:.3f} / "
        f"{fused_comp['engine']['fps_polled']:.3f} on {card}")
    log("phase 14, the sharded steps captured against eager in turns "
        "(substeps/s eager -> captured; launches a substep eager / "
        "captured; idle eager -> captured): " + "; ".join(
            f"{k} {v['rate']['eager']:.1f} -> {v['rate']['captured']:.1f} "
            f"({v['prof']['eager']['per_substep']:.1f} / "
            f"{v['prof']['captured']['per_substep']:.1f}; "
            f"{v['prof']['eager']['idle']:.2f} -> "
            f"{v['prof']['captured']['idle']:.2f})"
            for k, v in sharded["turns"].items())
        + f"; K7 at {PROBE_MB} lanes {t[f'K7 probe mb{PROBE_MB}']:.4f} ms, "
        f"at 32 {t['K7 probe']:.4f} (bound {bounds['K7 probe'][0]:.4f}) on "
        f"{card}")
    log(f"phase 18: 1M drag through the fused backend "
        f"{drag['backend']['fps']:.3f} frames/s (left alone "
        f"{drag['backend']['fps_idle']:.3f}), 1 capture, "
        f"{drag['backend']['graphs_gib']:.3f} GiB; through "
        f"LatticeEngine(fused=True) {drag['engine']['fps_drag']:.3f} "
        f"frames/s dragged, {drag['engine']['fps_idle']:.3f} alone, 1 "
        f"capture; planified config 3 eager -> captured "
        f"{plan['turns']['rate']['eager']:.1f} -> "
        f"{plan['turns']['rate']['captured']:.1f} substeps/s, config 4 "
        f"{plan4['rate']['eager']:.1f} -> {plan4['rate']['captured']:.1f}, "
        f"path B {run_b_turns['rate']['eager']:.1f} -> "
        f"{run_b_turns['rate']['captured']:.1f}; launches a substep eager / "
        f"captured: config 3 {plan['turns']['prof']['eager']['per_substep']:.1f}"
        f" / {plan['turns']['prof']['captured']['per_substep']:.1f}, config 4 "
        f"{plan4['prof']['eager']['per_substep']:.1f} / "
        f"{plan4['prof']['captured']['per_substep']:.1f}, path B "
        f"{run_b_turns['prof']['eager']['per_substep']:.1f} / "
        f"{run_b_turns['prof']['captured']['per_substep']:.1f} on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
