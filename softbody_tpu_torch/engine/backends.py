"""Engine state backends: the port of ``softbody_tpu/engine/backends.py``.
The worker's frame loop is backend-agnostic: a backend owns stepping,
render extraction, snapshot IO, fault injection and stats for one state
representation.

:class:`SimBackend` steps the general gather-path :class:`SimState`
(``ops/step.frame_jit``; arbitrary topology).
:class:`LatticeBackend` steps a :class:`LatticeState` with the stencil
path (``ops/stencil.lattice_frame_jit`` / ``lattice_frame_far_jit``;
its collisions through kernel K3 when ``cfg.use_pallas``) and, when far
field is armed, a Verlet-style
candidate list that it rebuilds when the motion since the last rebuild
could outrun the skin.  :class:`FusedLatticeBackend` steps persistent
packed planes with the fused substep kernel (K1, by default in the JAX
backend's kernel variants) and, when far field is armed, one of the JAX
backend's two far modes: the fixed-cadence frame ("v4": rebuilds with
the band kernel K2 or from K1's detection side planes, the far apply
through the record table of kernel K7 or its narrow rows, optionally
activation-scheduled) or the triggered frame ("v3": K1's trigger
statistics and side planes decide and seed the rebuilds, the list
carried across frames).  It raises on an option it does not run (an
unknown kernel variant, far mode, detection mode or band pass, a record
layout other than 32 lanes) instead of dropping it.
:class:`PlanifiedBackend` steps a :class:`SimState` of any topology
embedded into planes (``ops/planify.py``) on the stencil path.

All run on the CUDA device unless the caller names another
(``device="cpu"`` runs the plain torch versions).

Render readback is decoupled from stepping.  ``extract`` runs on the
worker's thread at frame end: it clones the render planes on the
worker's stream and records an event after the clones, without a host
sync.  ``packet_arrays`` runs on the caller's thread: on a side stream
that waits only for that event, it copies the clones into pinned host
buffers and waits for its own copies alone, so a packet never waits
for the frames the worker has launched since."""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import PhysicsConstants, StaticConfig, UserInput, resolve_device
from ..ops.cuda.fused_substep2 import (
    ALIVE,
    DEFAULT_KVAR,
    EAL,
    N_HOT,
    check_kvar,
    far3_carry_init_jit,
    fused_frame2_jit,
    fused_frame3_auto_jit,
    fused_frame4_jit,
    pack_lattice2,
    unpack_lattice2,
)
from ..ops.collisions import broad_phase_overflow
from ..ops.farfield4 import _check_layout
from ..ops.farfield import (
    crop_far_list,
    displacement_check,
    empty_far_list,
    empty_far_list_at,
    far_candidate_count,
    max_relative_speed,
    rebuild_far_list,
)
from ..ops.planify import planified_frame_far_jit, planified_frame_jit
from ..ops.step import frame_jit
from ..ops.stencil import (
    LatticeState,
    check_reference_offsets,
    lattice_frame_far_jit,
    lattice_frame_jit,
)
from ..snapshot import (
    SnapshotError,
    load_lattice_snapshot,
    load_snapshot,
    save_lattice_snapshot,
    save_snapshot,
)
from ..state import SimState
from ..utils.profiling import span

FAR_BANDS = {"cuda": "kernel", "cpu": "plain"}


class Extracted(NamedTuple):
    """One frame's render planes as device copies (``extract``), and the
    event on the worker's stream after the copies (None on the CPU)."""

    tensors: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event]


class Readback:
    """The two halves of the decoupled readback, shared by the backends:
    ``extract`` on the stepping thread, ``to_host`` on any other."""

    def __init__(self) -> None:
        self._side = {}               # device index -> side stream
        self._side_lock = threading.Lock()

    @staticmethod
    def extract(tensors) -> Extracted:
        """Clones on the current stream and an event after them (no host
        sync)."""
        copies = tuple(t.clone() for t in tensors)
        dev = copies[0].device
        if dev.type != "cuda":
            return Extracted(copies, None)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return Extracted(copies, ready)

    def _side_stream(self, dev: torch.device) -> torch.cuda.Stream:
        with self._side_lock:
            side = self._side.get(dev.index)
            if side is None:
                side = self._side[dev.index] = torch.cuda.Stream(device=dev)
            return side

    def to_host(self, ex: Extracted) -> Tuple[np.ndarray, ...]:
        """The copies on the host.  On CUDA: a non-blocking side stream
        waits for ``ex.ready``, copies into pinned buffers and records its
        own event, which alone is waited for.  ``record_stream`` tells the
        caching allocator that the side stream reads each copy, so once
        the worker drops it its memory is not handed out again before the
        side stream's copy has run."""
        if ex.ready is None:
            return tuple(t.numpy() for t in ex.tensors)
        dev = ex.tensors[0].device
        side = self._side_stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(ex.ready)
            host = []
            for t in ex.tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                host.append(h)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return tuple(h.numpy() for h in host)


def _corrupt_array(arr: torch.Tensor, rng: np.random.Generator
                   ) -> torch.Tensor:
    """Random u32 bit patterns at random offsets (≙ corruptBuffers,
    engineWorker.ts:599-617), drawn from ``rng`` in the JAX package's
    order, so one seed flips the same bits in both."""
    host = arr.detach().cpu().numpy().copy()
    flat = host.reshape(-1)
    view = flat.view(np.uint32) if flat.dtype.itemsize == 4 else None
    while rng.random() < 0.5:
        pos = rng.integers(0, flat.size)
        if view is not None:
            view[pos] = rng.integers(0, 2**32, dtype=np.uint64)
        elif flat.dtype == bool:
            flat[pos] = bool(rng.integers(0, 2))
    return torch.from_numpy(host).to(arr.device)


class SimBackend:
    """The general gather engine on ``device`` (default: the CUDA
    device), stepped through ``ops/step.frame_jit`` (on the card one
    captured CUDA graph per frame, as JAX's ``_sim_step`` is one jitted,
    donating program); snapshots in v0/v1 (``snapshot.py``)
    within the capacities ``max_particles``/``max_beams``."""

    _RENDER = ("pos", "particle_alive", "beam_a", "beam_b", "beam_alive",
               "beam_strain", "beam_stress")
    _CORRUPT = ("pos", "vel", "acc", "beam_length", "beam_target_length",
                "beam_last_length", "beam_spring", "beam_damp",
                "beam_yield_strain", "beam_strain_limit")

    def __init__(self, cfg: StaticConfig,
                 max_particles: Optional[int] = None,
                 max_beams: Optional[int] = None, *, device=None) -> None:
        self.cfg = cfg
        self.max_particles = max_particles
        self.max_beams = max_beams
        self.device = resolve_device(device)
        self._readback = Readback()

    def step(self, state: SimState, consts: PhysicsConstants,
             uin: UserInput) -> SimState:
        return frame_jit(state, consts, uin, self.cfg)

    def extract(self, state: SimState) -> Extracted:
        return Readback.extract(getattr(state, k) for k in self._RENDER)

    def packet_arrays(self, extracted: Extracted) -> Tuple[np.ndarray, ...]:
        """(pos, particle_alive, beam_a, beam_b, beam_alive, beam_strain,
        beam_stress) on the host; endpoints int32, as the JAX package
        keeps them."""
        pos, p_alive, ba, bb, b_alive, strain, stress = \
            self._readback.to_host(extracted)
        return (pos, p_alive, ba.astype(np.int32), bb.astype(np.int32),
                b_alive, strain, stress)

    def save(self, state: SimState, consts: PhysicsConstants) -> bytes:
        return save_snapshot(state, consts)

    def load(self, buf: bytes):
        """``(state, consts)`` on the backend's device, or None for bytes
        that are malformed or exceed the capacities."""
        try:
            return load_snapshot(buf, max_particles=self.max_particles,
                                 max_beams=self.max_beams,
                                 device=self.device)
        except SnapshotError:
            return None

    def counts(self, state: SimState) -> Tuple[int, int]:
        """(alive particles, alive beams), in one host read."""
        n, m = torch.stack([state.particle_alive.sum(),
                            state.beam_alive.sum()]).tolist()
        return int(n), int(m)

    def broad_phase_overflow(self, state: SimState) -> int:
        """The broad phase's current truncation (grid cell-capacity or
        window-row clipping), computed on demand."""
        return int(broad_phase_overflow(state.pos, state.particle_alive,
                                        self.cfg))

    def corrupt(self, state: SimState, rng: np.random.Generator) -> SimState:
        upd = {f: _corrupt_array(getattr(state, f), rng)
               for f in self._CORRUPT}
        if rng.random() < 0.1:
            upd["particle_alive"] = _corrupt_array(state.particle_alive, rng)
            upd["beam_alive"] = _corrupt_array(state.beam_alive, rng)
        return dataclasses.replace(state, **upd)


class LatticeBackend:
    """Dense stencil engine backend on ``device`` (default: the CUDA
    device).

    ``farfield``: optional :class:`~..ops.farfield.FarFieldSpec` enabling
    index-distant (fold/tear) self-collision.  Before each frame chunk the
    backend projects the COM-relative displacement the chunk can add
    (current displacement + 2 × max relative speed × chunk time) against
    the skin/2 validity budget and rebuilds the list when it would run
    out.  An empty list keeps the near-field-only frame; capacity buckets
    (``_FAR_BUCKETS``) keep the per-substep gather small when few pairs
    are active.

    The chunks run through ``lattice_frame_jit`` / ``lattice_frame_far_jit``
    (``self._frame`` / ``self._frame_far``, as in JAX): on the card one
    captured CUDA graph per chunk length (1, 2, 4, ..., 64) and list
    capacity (a bucket or ``max_pairs``), replayed; the rebuild decisions
    (``_motion``, ``_far_rebuild``, the chunk lengths) stay on the
    host."""

    _FAR_BUCKETS = (64, 256, 1024)
    # below this validity horizon (in substeps) a rebuild is cheaper than
    # dicing the frame further; chunks are powers of two, which bounds the
    # number of graphs
    _MIN_CHUNK = 4

    def __init__(self, spec, cfg: StaticConfig, farfield=None, *,
                 device=None) -> None:
        self.spec = spec
        self.cfg = cfg
        self.ff = farfield
        self.device = resolve_device(device)
        if self.device.type not in FAR_BANDS:
            raise ValueError(f"no kernels for device {self.device}")
        self._frame = lattice_frame_jit
        self._frame_far = lattice_frame_far_jit
        self._far_list = None         # full-capacity list
        self._far_active = None       # cropped list passed to the frame
        self.far_rebuilds = 0
        self.far_pairs = 0
        self.far_overflow = 0
        self.far_chunks = 0           # frame chunks run (observability)
        self._static_topology = None  # (beam_a, beam_b, class selections)
        self._readback = Readback()

    def _motion(self, state: LatticeState) -> Tuple[float, float]:
        """(COM-relative displacement since the rebuild, max relative
        speed), in one host read."""
        vrel = max_relative_speed(state.vel, state.alive)
        if self._far_list is None:
            return float("inf"), float(vrel)
        disp = displacement_check(state.pos, state.alive, self._far_list)
        d, v = torch.stack([disp, vrel]).tolist()
        return d, v

    def _far_rebuild(self, pos, alive) -> None:
        """A detection-only count first (a frame with no fold skips the
        compaction), then the full list when candidates exist.  While the
        previous list was non-empty (a persistent fold) the count is
        skipped: it would run the same detection twice."""
        kw = dict(s=self.spec.collision_stencil, ff=self.ff,
                  radius=self.cfg.particle_radius)
        self.far_rebuilds += 1
        if self.far_pairs == 0:
            total, com = far_candidate_count(pos, alive, **kw)
            if int(total) == 0:
                self._far_list = empty_far_list_at(pos, com, self.ff)
                self._far_active = None
                self.far_overflow = 0
                return
        self._far_list = rebuild_far_list(pos, alive, **kw)
        self.far_pairs, self.far_overflow = self._far_list.counts()
        if self.far_pairs == 0:
            self._far_active = None
        else:
            k = next((b for b in self._FAR_BUCKETS if b >= self.far_pairs),
                     self.ff.max_pairs)
            self._far_active = crop_far_list(self._far_list,
                                             min(k, self.ff.max_pairs))

    def _frame_chunk(self, state, consts, uin, n_sub):
        if self._far_active is not None:
            return self._frame_far(state, self._far_active, consts, uin,
                                   self.spec, self.cfg, self.ff, n_sub=n_sub)
        return self._frame(state, consts, uin, self.spec, self.cfg,
                           n_sub=n_sub)

    def step(self, state: LatticeState, consts: PhysicsConstants,
             uin: UserInput) -> LatticeState:
        """One frame.  With far field armed the frame runs as chunks no
        longer than the list's validity horizon: the list built at the
        reference positions covers every pair that can come into reach
        while no particle's COM-relative displacement exceeds skin/2, so
        with max relative speed v it holds for ⌊(skin/2 − disp)/(2·v·dt)⌋
        more substeps (a safety factor 2 for speed growth within the
        chunk).  A horizon shorter than ``_MIN_CHUNK`` rebuilds instead;
        chunk lengths are powers of two."""
        if state.device.type != self.device.type:
            raise ValueError(f"state on {state.device}, backend on "
                             f"{self.device}")
        if self.ff is None or self.cfg.collision_mode == "none":
            return self._frame(state, consts, uin, self.spec, self.cfg)
        dt = self.cfg.dt
        budget = self.ff.skin * 0.5
        remaining = self.cfg.subticks
        while remaining > 0:
            disp, vrel = self._motion(state)
            denom = max(2.0 * vrel * dt, 1e-12)
            horizon = (budget - disp) / denom
            if horizon < min(self._MIN_CHUNK, remaining):
                self._far_rebuild(state.pos, state.alive)
                horizon = max(budget / denom, 1.0)
            j = 1
            while 2 * j <= min(remaining, int(max(horizon, 1.0))):
                j *= 2
            state = self._frame_chunk(state, consts, uin, n_sub=j)
            self.far_chunks += 1
            remaining -= j
        return state

    def far_stats(self) -> dict:
        return {"far_rebuilds": self.far_rebuilds,
                "far_pairs": self.far_pairs,
                "far_overflow": self.far_overflow}

    def counts(self, state: LatticeState) -> Tuple[int, int]:
        """(alive particles, alive beams), in one host read."""
        n = torch.stack([state.alive.sum()]
                        + [e.alive.sum() for e in state.edges]).tolist()
        return int(n[0]), int(sum(n[1:]))

    def extract(self, state: LatticeState) -> Extracted:
        """Render planes, flattened: pos ``[W·H, 2]``, alive, then per
        class strain, per class stress, per class edge alive ``[W·H]``."""
        n = self.spec.width * self.spec.height
        planes = [state.pos.reshape(n, 2), state.alive.reshape(n)]
        for f in ("strain", "stress", "alive"):
            planes += [getattr(e, f).reshape(n) for e in state.edges]
        return Readback.extract(planes)

    def _topology(self):
        """Per edge class: the lattice's valid edges as endpoint indices
        and the selection of them from the class's ``[W·H]`` plane
        (cached)."""
        if self._static_topology is None:
            w, h = self.spec.width, self.spec.height
            x = np.arange(w)[:, None]
            y = np.arange(h)[None, :]
            lin = (x * h + y).reshape(-1)
            a_list, b_list, sel_list = [], [], []
            for dx, dy in self.spec.edge_offsets:
                sel = ((x + dx >= 0) & (x + dx < w) & (y + dy >= 0)
                       & (y + dy < h)).reshape(-1)
                a_list.append(lin[sel])
                b_list.append(lin[sel] + dx * h + dy)
                sel_list.append(sel)
            self._static_topology = (a_list, b_list, sel_list)
        return self._static_topology

    def packet_arrays(self, extracted: Extracted) -> Tuple[np.ndarray, ...]:
        """(pos, alive, beam_a, beam_b, beam_alive, beam_strain,
        beam_stress) on the host: the lattice's edges as a beam list,
        class by class, in the JAX package's order."""
        host = self._readback.to_host(extracted)
        pos, alive = host[0], host[1]
        c = len(self.spec.edge_offsets)
        strains, stresses, ealive = (host[2:2 + c], host[2 + c:2 + 2 * c],
                                     host[2 + 2 * c:])
        a_list, b_list, sel_list = self._topology()

        def beams(planes):
            return np.concatenate([p[sel] for p, sel in zip(planes,
                                                            sel_list)])

        return (pos, alive, np.concatenate(a_list).astype(np.int32),
                np.concatenate(b_list).astype(np.int32), beams(ealive),
                beams(strains), beams(stresses))

    def save(self, state: LatticeState, consts: PhysicsConstants) -> bytes:
        return save_lattice_snapshot(state, consts)

    def load(self, buf: bytes):
        """``(state, consts)`` on the backend's device, or None for bytes
        that are not an L1 snapshot of this lattice's W × H."""
        try:
            state, consts = load_lattice_snapshot(buf, device=self.device)
        except SnapshotError:
            return None
        if state.shape != (self.spec.width, self.spec.height):
            return None
        return state, consts

    def corrupt(self, state: LatticeState,
                rng: np.random.Generator) -> LatticeState:
        upd = {f: _corrupt_array(getattr(state, f), rng)
               for f in ("pos", "vel", "acc")}
        edges = tuple(dataclasses.replace(
            e, target_length=_corrupt_array(e.target_length, rng),
            last_length=_corrupt_array(e.last_length, rng))
            for e in state.edges)
        return dataclasses.replace(state, edges=edges, **upd)


def _stats_merge_device(a, b):
    """Accumulate two frames' int32 stats vectors on the device (no host
    read; JAX's backend merges its device arrays the same way): the
    rebuild count sums, the rest take the running max."""
    return b if a is None else torch.cat([a[:1] + b[:1],
                                          torch.maximum(a[1:], b[1:])])


class FusedLatticeBackend(LatticeBackend):
    """Lattice backend over packed planes ``(hot [18,W,H], obs [8,W,H])``
    on ``device``; the immutable planes and edge constants live on the
    backend (edge parameters must be uniform per class).  The keyword
    arguments are the JAX backend's.

    ``device``: as :class:`LatticeBackend` (default: the CUDA device).
    ``tile_w``: the TPU kernel's slab width; accepted and ignored (K1's
    tile is its own).
    ``far_mode``: ``"v4"`` (default; ``fused_frame4``, no far state across
    frames) or ``"v3"`` (``fused_frame3_auto``: the list, K1's side planes
    and the trigger vector carried across frames, dropped by
    ``pack_state``; K1 strict, whatever ``kernel_variants`` say, as in
    JAX).
    ``far_detect`` (v4): ``"xla"``, each rebuild detects on its state, or
    ``"kernel"``, from the side planes of K1's detect instance.
    ``far_band``: the rebuild's band pass: ``"kernel"`` (K2, on CUDA) or
    ``"plain"`` (on the CPU, its plain version); ``"xla"`` (JAX's name)
    is the plain loop on either device; None picks the device's own.
    ``far_activation``: each rebuild schedules its pairs' first possible
    contact and each substep applies only those that can touch by then
    (``fused_frame4(activation=True)``).
    ``far_mb``/``far_mb_out``: the far apply's record lane blocks (the
    mirror route's gather and scatter sides; multiples of 32, anything
    else raises).  Every lane block gives the same bits; a layout other
    than 32 / None drops ``kmirror``/``krec`` (JAX's rule, below).

    The frames are the compiled ones (``fused_frame4_jit``,
    ``fused_frame3_auto_jit``, ``far3_carry_init_jit``,
    ``fused_frame2_jit``: one CUDA graph per key on the card, replayed
    with no host read; the functions on the CPU).  ``self._frame4``,
    ``_frame3``, ``_carry_init`` and ``_frame2`` hold them: set them to
    the plain functions for an eager twin.

    ``kernel_variants``: the JAX kernel's flags (``fused_substep2.
    KERNEL_VARIANTS``), by default the JAX backend's (``DEFAULT_KVAR``:
    rollgroup, rsqrt, dexp2, lanecut, krec, ealpack), so the same call
    runs the same physics in both packages; ``kernel_variants=()`` is
    the strict path; the attribution knobs ``nospring`` and ``noint``
    (not physics) are taken.  ``self.kvar`` keeps JAX's drop rules
    (``softbody_tpu/engine/backends.py:417-443``): v3 drops the layout
    flags and ``kmirror``/``krec``, kernel detection and a record layout
    other than ``far_mb=32, far_mb_out=None`` drop ``kmirror``/``krec``
    (so buckets ≤ 256 take the narrow route again), and a ladder with a
    bucket ≤ 256 drops
    ``krec``, whose route would change the far apply's sum order there
    (the terminal ``max_pairs`` bucket is not looked at, as in JAX).
    ``step`` drops ``dexp2`` whenever the drag exponent is not 2.
    Unknown names raise."""

    def __init__(self, spec, cfg: StaticConfig, farfield=None,
                 tile_w: int = 128, far_mode: str = "v4",
                 far_buckets: Optional[Tuple[int, ...]] = None,
                 far_activation: bool = False, far_mb: int = 32,
                 far_mb_out: Optional[int] = None, far_detect: str = "xla",
                 far_band: Optional[str] = None,
                 kernel_variants: Tuple[str, ...] = DEFAULT_KVAR, *,
                 device=None) -> None:
        super().__init__(spec, cfg, farfield=farfield, device=device)
        kvar = check_kvar(kernel_variants)
        if far_mode not in ("v4", "v3"):
            raise ValueError(f"far_mode {far_mode!r}: 'v4' or 'v3'")
        if far_detect not in ("xla", "kernel"):
            raise ValueError(f"far_detect {far_detect!r}: 'xla' or 'kernel'")
        _check_layout(far_mb, far_mb_out)
        if far_mode == "v3":
            kvar = tuple(v for v in kvar if v not in ("lanecut", "ealpack"))
        if (far_mode == "v3" or far_detect == "kernel" or far_mb != 32
                or far_mb_out is not None):
            kvar = tuple(v for v in kvar if v not in ("kmirror", "krec"))
        if far_buckets is not None and any(b <= 256 for b in far_buckets):
            kvar = tuple(v for v in kvar if v != "krec")
        self.kvar = kvar
        check_reference_offsets(spec)
        want = FAR_BANDS[self.device.type]
        if far_band is None:
            far_band = want
        if far_band not in (want, "xla"):
            raise ValueError(f"far_band {far_band!r} on {self.device.type}: "
                             f"the band pass there is {want!r} (or 'xla', "
                             "the plain loop)")
        self.far_band = far_band
        self._band_impl = "kernel" if far_band == "kernel" else "plain"
        self.tile_w = tile_w
        self.far_mode = far_mode
        self.far_detect = far_detect
        self.far_buckets = far_buckets
        self.far_activation = far_activation
        self.far_mb = far_mb
        self.far_mb_out = far_mb_out
        self._immut = None
        self._edge_consts = None
        self._template = None
        self._stats_acc = None
        self._far_side = None    # v3: K1's side planes (carried)
        self._far_trig = None    # v3: the trigger vector (carried)
        self._frame4 = fused_frame4_jit
        self._frame3 = fused_frame3_auto_jit
        self._carry_init = far3_carry_init_jit
        self._frame2 = fused_frame2_jit

    def pack_state(self, lstate: LatticeState):
        """LatticeState (on the backend's device) → packed ``(hot, obs)``;
        keeps the immutable planes, edge constants and a template."""
        if lstate.shape != (self.spec.width, self.spec.height):
            raise ValueError(f"state {lstate.shape} does not match spec "
                             f"{(self.spec.width, self.spec.height)}")
        if lstate.device.type != self.device.type:
            raise ValueError(f"state on {lstate.device}, backend on "
                             f"{self.device}")
        hot, obs, immut, ec = pack_lattice2(lstate)
        self._immut = immut
        self._edge_consts = ec
        self._template = lstate
        # a new world: a far list, side planes and trigger vector carried
        # from the old one are dropped
        self._far_list = None
        self._far_active = None
        self._far_side = None
        self._far_trig = None
        return hot, obs

    def unpack_state(self, state) -> LatticeState:
        hot, obs = state
        return unpack_lattice2(hot, obs, self._template)

    def step(self, state, consts: PhysicsConstants, uin: UserInput):
        """One frame.  Far-field armed: ``far_mode="v4"``, the
        fixed-cadence frame (``fused_frame4``: rebuilds with K2 or from
        K1's side planes, the far apply's mirror route with K7 or its
        narrow route per bucket, K1), the bucket chosen on the device;
        ``"v3"``, the triggered frame (``fused_frame3_auto``) with the
        list, side planes and trigger vector carried from the last frame
        (``far3_carry_init`` and an empty list after ``pack_state``), the
        trigger decided on the device.  No host read: the stats
        accumulate on the device (``far_stats`` reads them).  Spans
        (with tracing on): ``backend.step``, ``backend.stats`` (the merge
        of the frame's stats, eager torch ops outside its graph)."""
        with span("backend.step"):
            return self._step(state, consts, uin)

    def _step(self, state, consts: PhysicsConstants, uin: UserInput):
        hot, obs = state
        kvar = self._checked_kvar(consts)
        if self.ff is None or self.cfg.collision_mode == "none":
            return self._frame2(hot, obs, self._immut, self._edge_consts,
                                consts, uin, self.spec, self.cfg, kvar=kvar)
        if self.far_mode == "v3":
            if self._far_list is None:
                self._far_list = empty_far_list(
                    self.spec.width, self.spec.height, self.ff,
                    device=self.device)
                self._far_side, self._far_trig = self._carry_init(
                    hot, self._immut, self.cfg, self.spec, self.ff)
            (hot, obs, self._far_list, self._far_side, self._far_trig,
             st) = self._frame3(
                hot, obs, self._immut, self._edge_consts, self._far_list,
                self._far_side, self._far_trig, consts, uin, self.spec,
                self.cfg, self.ff)
        else:
            kw = ({} if self.far_buckets is None
                  else {"buckets": self.far_buckets})
            hot, obs, st = self._frame4(
                hot, obs, self._immut, self._edge_consts, consts, uin,
                self.spec, self.cfg, self.ff,
                activation=self.far_activation, far_mb=self.far_mb,
                far_mb_out=self.far_mb_out, detect_mode=self.far_detect,
                band_impl=self._band_impl, kvar=kvar, **kw)
        with span("backend.stats"):
            self._stats_acc = _stats_merge_device(self._stats_acc, st)
        return hot, obs

    def _checked_kvar(self, consts: PhysicsConstants) -> Tuple[str, ...]:
        """``self.kvar`` without ``dexp2`` unless the drag exponent is
        exactly 2 (the constants can change between frames)."""
        if "dexp2" in self.kvar and float(consts.drag_exp) != 2.0:
            return tuple(v for v in self.kvar if v != "dexp2")
        return self.kvar

    def far_stats(self) -> dict:
        """Stats since the last read (the accumulator resets on read):
        total rebuilds, max n_pairs, max overflow, and under v4 max active
        pairs.  The one host read of the fused frames' stats (they
        accumulate on the device; span ``backend.far_stats``)."""
        if self._stats_acc is None:
            return super().far_stats()
        with span("backend.far_stats"):
            vals, self._stats_acc = self._stats_acc.tolist(), None
        out = {"far_rebuilds": vals[0], "far_pairs": vals[1],
               "far_overflow": vals[2]}
        if len(vals) > 3:
            out["far_active"] = vals[3]
        return out

    def counts(self, state) -> Tuple[int, int]:
        """(alive particles, alive beams) from the packed planes."""
        hot, _obs = state
        eal = hot[[6 + 3 * c + EAL for c in range((N_HOT - 6) // 3)]]
        n = torch.stack([(self._immut[ALIVE] > 0).sum(),
                         (eal > 0).sum()]).tolist()
        return int(n[0]), int(n[1])

    # the cold paths go through the LatticeState

    def extract(self, state) -> Extracted:
        return super().extract(self.unpack_state(state))

    def save(self, state, consts: PhysicsConstants) -> bytes:
        return super().save(self.unpack_state(state), consts)

    def load(self, buf: bytes):
        """As :meth:`LatticeBackend.load`, packed; None also for a world
        whose edge parameters vary within a class (``pack_state`` cannot
        take it)."""
        loaded = super().load(buf)
        if loaded is None:
            return None
        lstate, consts = loaded
        try:
            return self.pack_state(lstate), consts
        except ValueError:
            return None

    def corrupt(self, state, rng: np.random.Generator):
        return self.pack_state(super().corrupt(self.unpack_state(state), rng))


class PlanifiedBackend(SimBackend):
    """General topologies on the dense stencil path, on ``device``
    (default: the CUDA device): a :class:`SimState` is embedded into
    ``[W, H]`` planes (``ops/planify.py``), beams into dense offset
    classes plus an exception list merged into the same int32 force
    accumulator.  Its collisions go through the stencil (K3 under
    ``cfg.use_pallas``); ``farfield`` arms the activation-scheduled far
    frame (``planified_frame_far``: K2 per rebuild, K7 in applies above
    256 pairs) for contacts that develop after the embedding.

    The state is a :class:`~..ops.planify.PlanifiedState`; the embedding
    lives on the backend and is rebuilt on ``pack_state`` and ``load``.
    Far-armed embeddings are aligned to the far field's chunk grid
    (``chunk_multiple = chunk · tile_chunks``).

    Readback does not sync the stepping thread: ``extract`` gathers the
    render fields on the device, in flat particle and beam order, through
    index tensors kept from the embedding (each particle's cell, each
    beam's slot in its class planes and the exception list
    concatenated), and ``packet_arrays`` copies them as the other
    backends do; packets equal ``unplanify``'s fields bit for bit.

    ``far_stats`` returns ``far_active`` beside the other three keys:
    the JAX package's ``EngineStats`` has no such field, so its worker
    fails on this backend's stats once far field is armed; the port's
    takes it."""

    def __init__(self, cfg: StaticConfig,
                 max_particles: Optional[int] = None,
                 max_beams: Optional[int] = None,
                 collision_stencil: int = 3, farfield=None, *,
                 device=None) -> None:
        super().__init__(cfg, max_particles, max_beams, device=device)
        self.collision_stencil = collision_stencil
        self.ff = farfield
        self._frame = planified_frame_jit
        self._frame_far = planified_frame_far_jit
        self._stats_acc = None
        self._spec = None
        self._aux = None
        self._template = None
        self._cell_index = None   # [N] plane cell of each particle
        self._beam_slot = None    # [M] slot in the concatenated beam state

    @property
    def spec(self):
        """The current embedding's :class:`LatticeSpec`."""
        return self._spec

    @property
    def aux(self):
        """The current embedding's host maps (``PlanifyAux``)."""
        return self._aux

    def pack_state(self, state: SimState):
        """SimState (on the backend's device) → PlanifiedState, embedding
        it anew; keeps the embedding and its device index maps."""
        from ..ops.planify import planify

        if state.pos.device.type != self.device.type:
            raise ValueError(f"state on {state.pos.device}, backend on "
                             f"{self.device}")
        cm = self.ff.chunk * self.ff.tile_chunks if self.ff else 1
        ps, spec, aux = planify(state,
                                collision_stencil=self.collision_stencil,
                                chunk_multiple=cm)
        self._spec, self._aux, self._template = spec, aux, state
        n_cells = aux.width * aux.height
        slot = np.where(aux.beam_class >= 0,
                        aux.beam_class * n_cells + aux.beam_cell,
                        len(spec.edge_offsets) * n_cells + aux.beam_cell)
        self._cell_index = torch.from_numpy(aux.cell_of).to(self.device)
        self._beam_slot = torch.from_numpy(slot).to(self.device)
        return ps

    def unpack_state(self, ps) -> SimState:
        from ..ops.planify import unplanify

        return unplanify(ps, self._template, self._aux)

    def step(self, ps, consts: PhysicsConstants, uin: UserInput):
        """One frame through the compiled frames: ``planified_frame_jit``,
        or with far field armed (and collisions on)
        ``planified_frame_far_jit``, whose buckets are chosen on the device
        and whose stats accumulate there (``far_stats`` reads them): no
        host read.  ``self._frame`` / ``self._frame_far`` hold them (set
        them to the plain functions for an eager twin).  Spans as
        :meth:`FusedLatticeBackend.step`'s."""
        with span("backend.step"):
            if self.ff is not None and self.cfg.collision_mode != "none":
                ps, st = self._frame_far(ps, consts, uin, self._spec,
                                         self.cfg, self.ff)
                with span("backend.stats"):
                    self._stats_acc = _stats_merge_device(self._stats_acc,
                                                          st)
                return ps
            return self._frame(ps, consts, uin, self._spec, self.cfg)

    def far_stats(self) -> dict:
        """Stats since the last read (the accumulator resets on read):
        rebuilds, max n_pairs, max overflow, max active pairs; {} when no
        far frame ran.  The one host read of the frames' stats (span
        ``backend.far_stats``)."""
        if self._stats_acc is None:
            return {}
        with span("backend.far_stats"):
            vals, self._stats_acc = self._stats_acc.tolist(), None
        return {"far_rebuilds": vals[0], "far_pairs": vals[1],
                "far_overflow": vals[2], "far_active": vals[3]}

    def _beam_state(self, ps, field: str) -> torch.Tensor:
        """One beam field over every flat beam ``[M]``, on the device."""
        flat = torch.cat([getattr(e, field).reshape(-1) for e in ps.lat.edges]
                         + [getattr(ps.x, field)])
        return flat[self._beam_slot]

    def extract(self, ps) -> Extracted:
        """The render fields in flat order (``SimBackend.extract``'s),
        gathered on the device."""
        cell = self._cell_index
        return Readback.extract((
            ps.lat.pos.reshape(-1, 2)[cell],
            ps.lat.alive.reshape(-1)[cell],
            self._template.beam_a, self._template.beam_b,
            self._beam_state(ps, "alive"), self._beam_state(ps, "strain"),
            self._beam_state(ps, "stress")))

    def save(self, ps, consts: PhysicsConstants) -> bytes:
        return save_snapshot(self.unpack_state(ps), consts)

    def load(self, buf: bytes):
        """``(PlanifiedState, consts)`` embedded anew, or None for bytes
        ``SimBackend.load`` refuses."""
        got = super().load(buf)
        if got is None:
            return None
        state, consts = got
        return self.pack_state(state), consts

    def counts(self, ps) -> Tuple[int, int]:
        """(alive particles, alive beams: every class plane and the
        exception list), in one host read."""
        beams = torch.cat([e.alive.reshape(-1) for e in ps.lat.edges]
                          + [ps.x.alive])
        n, m = torch.stack([ps.lat.alive.sum(), beams.sum()]).tolist()
        return int(n), int(m)

    def corrupt(self, ps, rng: np.random.Generator):
        """Corrupt the flat state (``SimBackend.corrupt``: the JAX
        package's draws, so one seed flips the same bits), then write it
        into the current embedding.  The JAX package re-embeds with a new
        width search, which a corrupted coordinate can send into a plane
        ~10¹⁵ columns wide (a host loop that does not end); the layout
        kept here gives the same flat state and always returns."""
        from ..ops.planify import embed

        flat = super().corrupt(self.unpack_state(ps), rng)
        self._template = flat
        return embed(flat, self._aux)

    def broad_phase_overflow(self, ps) -> int:
        """The dense index stencil has no capacity to overflow (the far
        field's truncation is in ``far_stats``)."""
        return 0
