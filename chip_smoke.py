#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Builds the hand-written kernels from ``softbody_tpu_torch/csrc``, holds
each against its plain torch version on the card, drives the main path
(the 1M-particle tearing cloth with far-field self-collision, through
``FusedLatticeBackend``) for a few frames, checks the result, and times
the kernels against their plain versions.  Every phase raises on
failure.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, default
``/usr/local/cuda``); refuses to run without a device.  The last line
of standard output is one JSON object naming the device; the line
before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.engine import FusedLatticeBackend
from softbody_tpu_torch.models import make_lattice, tearing_cloth_lattice
from softbody_tpu_torch.ops.cuda import _lib, band_detect, fused_substep2
from softbody_tpu_torch.ops.cuda.band_detect import (
    band_flag_call,
    band_flags_plain,
)
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    PX,
    PY,
    VX,
    VY,
    fused_substep2_call,
    fused_substep2_plain,
    pack_lattice2,
)
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    rebuild_far_list_planes,
)
from softbody_tpu_torch.ops.farfield4 import bucketed_far_delta_planes
from softbody_tpu_torch.ops.stencil import LatticeSpec, sqrt32

# the bench scene of bench.py:79-107 (1000 x 1000 lattice, ~3.98M springs)
N_PARTICLES = 1_000_000
SCENE_KW = dict(fall_speed=2.5, slits=7, strain_limit=0.22,
                yield_strain=0.18)
# frames 3-10, bench.py's window (first frame, one warm frame, 8 timed):
# the sheet reaches the floor and starts to tear, so far pairs appear
WARM_FRAMES = 2
TIMED_FRAMES = 8
SEED = 0

# K1 against its plain version: edge planes bit-exact, particle planes
# within the port's parity tolerances (tests/test_torch_substep.py)
K1_ATOL = {"pos": 1e-4, "vel": 1e-3, "acc": 1e-2, "obs": 1e-5}


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


# ---------------------------------------------------------------------------
# kernel checks


def _k1_inputs(state, spec, cfg, consts, spacing, seed):
    hot, obs, immut, ec = pack_lattice2(_stirred(state, spacing, seed))
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg,
                                       spec.height), ec])
    g = torch.Generator(device=hot.device).manual_seed(seed + 1)
    far = torch.randn((5,) + tuple(hot.shape[1:]), generator=g,
                      device=hot.device) * 0.5
    return hot, obs, immut, cvec, far


def check_k1(label, state, spec, cfg, consts, spacing) -> float:
    """K1 against its plain version on the card, hot and observing."""
    hot, obs, immut, cvec, far = _k1_inputs(state, spec, cfg, consts,
                                            spacing, SEED)
    kw = dict(stencil=spec.collision_stencil, quantized=True, far=far)
    worst = 0.0
    for observe in (False, True):
        okw = dict(kw, obs_in=obs if observe else None)
        ref = fused_substep2_plain(hot, immut, cvec, **okw)
        got = fused_substep2_call(hot, immut, cvec, **okw)
        torch.cuda.synchronize()
        ref_hot, ref_obs = ref if observe else (ref, None)
        got_hot, got_obs = got if observe else (got, None)
        if not torch.equal(got_hot[6:], ref_hot[6:]):
            n_bad = int((got_hot[6:] != ref_hot[6:]).sum())
            raise AssertionError(f"K1 {label}: {n_bad} edge-plane values "
                                 "differ from the plain version")
        errs = {
            "pos": (got_hot[0:2] - ref_hot[0:2]).abs().max().item(),
            "vel": (got_hot[2:4] - ref_hot[2:4]).abs().max().item(),
            "acc": (got_hot[4:6] - ref_hot[4:6]).abs().max().item(),
        }
        if observe:
            live = torch.repeat_interleave(ref_hot[8::3] > 0, 2, dim=0)
            errs["obs"] = ((got_obs - ref_obs).abs() * live).max().item()
        for k, e in errs.items():
            if not e <= K1_ATOL[k]:
                raise AssertionError(f"K1 {label} observe={observe}: {k} "
                                     f"max |err| {e} > {K1_ATOL[k]}")
        worst = max(worst, *errs.values())
        active = int((ref_hot[8::3] > 0).sum())
        broke = int(((hot[8::3] > 0) & (ref_hot[8::3] == 0)).sum())
        log(f"K1 {label} observe={observe}: edge planes bit-exact, "
            f"max |err| {errs} ({active} alive edges, {broke} broke)")
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


def check_k2(label, state, spec, cfg, spacing) -> float:
    """K2 against its plain version on the card: flags bit-exact."""
    st = _stirred(state, spacing, SEED)
    *planes, offsets = _band_inputs(
        st.pos[..., 0], st.pos[..., 1], st.vel[..., 0], st.vel[..., 1],
        st.alive, cfg, _far_spec(spacing), spec.collision_stencil)
    ref = band_flags_plain(*planes, offsets)
    got = band_flag_call(*planes, offsets=offsets)
    torch.cuda.synchronize()
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"K2 {label}: {n_bad} flags differ from the "
                             "plain version")
    log(f"K2 {label}: flags bit-exact ({int(ref.sum())} of "
        f"{ref.numel()} particles flagged, {len(offsets)} offsets)")
    return float(n_bad)


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


def check_small_end_to_end() -> None:
    """The backend on the card against the same backend on the CPU (the
    plain versions) on a small fold: 2 frames, far stats equal, state
    within the slice's parity tolerances (tests/test_torch_frame.py)."""
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
        be = FusedLatticeBackend(
            LatticeSpec(96, 4), cfg, device=dev, far_buckets=(16,),
            farfield=FarFieldSpec(max_pairs=64, max_tile_pairs=32, skin=4.0,
                                  horizon=8))
        state = be.pack_state(_hairpin(dev))
        for _ in range(2):
            state = be.step(state, tb.PhysicsConstants(), tb.UserInput())
        out[dev] = (state[0].cpu(), be.far_stats())
    (h_cpu, s_cpu), (h_gpu, s_gpu) = out["cpu"], out["cuda"]
    if s_cpu != s_gpu or s_gpu["far_pairs"] == 0:
        raise AssertionError(f"small fold: far stats cpu {s_cpu} vs "
                             f"cuda {s_gpu}")
    dpos = (h_gpu[0:2] - h_cpu[0:2]).abs().max().item()
    dvel = (h_gpu[2:4] - h_cpu[2:4]).abs().max().item()
    if not (dpos <= 5e-3 and dvel <= 5e-2):
        raise AssertionError(f"small fold: cuda vs cpu |dpos| {dpos} "
                             f"|dvel| {dvel}")
    log(f"small fold 96x4, 2 frames: cuda == cpu plain (far stats "
        f"{s_gpu}; max |dpos| {dpos:.3g}, |dvel| {dvel:.3g})")


def run_main_path(state, spec, cfg, consts, spacing) -> dict:
    """The bench scene through FusedLatticeBackend: a warm frame, then
    TIMED_FRAMES frames with the kernels' launch counts from zero."""
    be = FusedLatticeBackend(spec, cfg, farfield=_far_spec(spacing),
                             device="cuda")
    packed = be.pack_state(state)
    uin = tb.UserInput()
    n0, m0 = be.counts(packed)
    t0 = time.perf_counter()
    packed = be.step(packed, consts, uin)
    torch.cuda.synchronize()
    log(f"main path: first frame {time.perf_counter() - t0:.2f} s, "
        f"far stats {be.far_stats()}")
    for _ in range(WARM_FRAMES - 1):
        packed = be.step(packed, consts, uin)
    be.far_stats()  # reset the window

    fused_substep2.K1_LAUNCHES = 0
    band_detect.K2_LAUNCHES = 0
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
    n1, m1 = be.counts(packed)
    ms = start.elapsed_time(end)
    rate = substeps / (ms / 1000.0)
    pos = hot[0:2]
    log(f"main path: {spec.width}x{spec.height} lattice, {n1} particles, "
        f"alive beams {m0} -> {m1}; {TIMED_FRAMES} frames = {substeps} "
        f"substeps in {ms:.1f} ms (CUDA events; host {wall:.3f} s) = "
        f"{rate:.1f} substeps/s; far stats {stats}; K1 launches {k1}, "
        f"K2 launches {k2}; pos range [{pos.min().item():.2f}, "
        f"{pos.max().item():.2f}]")
    return dict(be=be, packed=packed, k1=k1, k2=k2, rate=rate,
                frame_ms=ms / TIMED_FRAMES, stats=stats)


def time_at_final_state(run, spec, cfg, consts) -> dict:
    """At the main path's final state (CUDA events, ms per call): one
    rebuild, one far apply, and K1 and K2 against their plain versions on
    the inputs the main path gives them."""
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

    def apply():
        return bucketed_far_delta_planes(
            hot, immut[0], fl, n_pairs, dt=cfg.dt, ecoeff=consts.ecoeff,
            friction=consts.friction, buckets=(1024, 2048, 4096), **kw)

    far = apply()
    t["apply"] = _timed_ms(apply, 10) if n_pairs else 0.0
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg,
                                       spec.height), be._edge_consts])
    k1kw = dict(stencil=s, quantized=True, far=far)
    t["K1"] = _timed_ms(lambda: fused_substep2_call(hot, immut, cvec,
                                                    **k1kw), 50)
    t["K1 plain"] = _timed_ms(lambda: fused_substep2_plain(hot, immut, cvec,
                                                           **k1kw), 5)
    *planes, offsets = _band_inputs(hot[PX], hot[PY], hot[VX], hot[VY],
                                    alive, cfg, ff, s)
    flagged = int(band_flags_plain(*planes, offsets).sum())
    t["K2"] = _timed_ms(lambda: band_flag_call(*planes, offsets=offsets),
                        50)
    t["K2 plain"] = _timed_ms(lambda: band_flags_plain(*planes, offsets), 5)
    log(f"at the final state ({n_pairs} far pairs, {flagged} band-flagged "
        f"particles): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    return t


def main() -> int:
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
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # phases 2-3: kernels against their plain versions, 64x64 and 1M
    errs = {"K1": 0.0, "K2": 0.0}
    scenes = {}
    for n in (64 * 64, N_PARTICLES):
        state, spec, cfg, consts, spacing = _scene(n, dev)
        scenes[n] = (state, spec, cfg, consts, spacing)
        label = f"{spec.width}x{spec.height}"
        errs["K1"] = max(errs["K1"], check_k1(label, state, spec, cfg,
                                              consts, spacing))
        errs["K2"] = max(errs["K2"], check_k2(label, state, spec, cfg,
                                              spacing))
    log("phases 2-3 kernels vs plain: ok")

    # phase 4: small end-to-end against the plain versions on the CPU
    check_small_end_to_end()

    # phase 5: the main path at full size
    state, spec, cfg, consts, spacing = scenes[N_PARTICLES]
    run = run_main_path(state, spec, cfg, consts, spacing)

    # phase 6: times at the main path's final state, kernels against
    # their plain versions
    t = time_at_final_state(run, spec, cfg, consts)

    kernels = [
        {"name": "K1 fused_substep2", "route": "cuda",
         "source": "softbody_tpu_torch/csrc/fused_substep2.cu",
         "replaces": "softbody_tpu/ops/pallas/fused_substep2.py:195",
         "launches": run["k1"], "max_abs_err": errs["K1"], "ms": t["K1"],
         "plain_ms": t["K1 plain"]},
        {"name": "K2 band_detect", "route": "cuda",
         "source": "softbody_tpu_torch/csrc/band_detect.cu",
         "replaces": "softbody_tpu/ops/pallas/band_detect.py:65",
         "launches": run["k2"], "max_abs_err": errs["K2"], "ms": t["K2"],
         "plain_ms": t["K2 plain"]},
    ]
    log(f"main path rate: {run['rate']:.1f} substeps/s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
