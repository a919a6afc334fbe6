"""Host engine façade (≙ ``WGPUSoftbodyEngine``, engine.ts:31-239): the
port of ``softbody_tpu/engine/engine.py``.

Owns an :class:`EngineWorker` thread, forwards input, constants and
snapshots over the typed message protocol with acks, exposes render
packets and stats, and mirrors the reference's input model (keyboard
force vector, throttled coalesced input sends, visibility pause).  The
engine runs on the CUDA device unless the caller names another
(``device="cpu"`` runs the plain torch versions); without a card the
default raises ``RuntimeError``."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Set

import numpy as np

from ..config import PhysicsConstants, StaticConfig
from ..snapshot import load_lattice_snapshot, load_snapshot
from ..state import SimState
from .backends import FusedLatticeBackend, LatticeBackend
from .protocol import EngineOptions, MessageType
from .worker import EngineStats, EngineWorker, RenderPacket


class Engine:
    """The public runtime API.

    >>> eng = Engine(state, device="cuda")  # spawns the worker thread
    >>> eng.set_physics_constants(c)        # message with ack
    >>> pkt = eng.render_packet()           # decoupled readback
    >>> buf = eng.save_snapshot()
    >>> eng.destroy()

    ``state`` lies on ``device``; with ``backend`` (a backend built on
    its own device) ``device`` is the backend's."""

    def __init__(self, state: SimState,
                 consts: Optional[PhysicsConstants] = None,
                 options: Optional[EngineOptions] = None, *, backend=None,
                 device=None) -> None:
        self.options = options or EngineOptions()
        self._worker = EngineWorker(state, consts, self.options,
                                    backend=backend, device=device)
        self.device = self._worker.device
        self._destroyed = False
        self._initial_state: Optional[bytes] = None
        # input model ≙ engine.ts:39-75
        self.keyboard_force: float = 1.0
        self.user_strength: float = 1.0
        self._held_keys: Set[str] = set()
        self._mouse_pos = np.zeros(2, np.float32)
        self._mouse_active = False
        self._last_input_send = 0.0
        self._input_throttle_s = 0.010  # 10 ms throttle (engine.ts:51)

    # ---- physics constants (engine.ts:187-192) ----

    def set_physics_constants(self, consts: PhysicsConstants) -> None:
        self._worker.post_with_ack(MessageType.PHYSICS_CONSTANTS, consts)

    def get_physics_constants(self) -> PhysicsConstants:
        return self._worker.post_with_ack(MessageType.GET_PHYSICS_CONSTANTS)

    # ---- snapshots (engine.ts:194-199) ----

    def save_snapshot(self) -> bytes:
        return self._worker.post_with_ack(MessageType.SNAPSHOT_SAVE)

    def load_snapshot(self, buf: bytes) -> bool:
        return bool(self._worker.post_with_ack(MessageType.SNAPSHOT_LOAD, buf))

    # ---- initial-state slot (≙ main.ts:262-276, 347-362) ----

    def set_initial_state(self, buf: Optional[bytes] = None) -> None:
        """Capture the reset slot (≙ 'Set initial state'): the current
        world by default, or the given snapshot bytes."""
        self._initial_state = buf if buf is not None else self.save_snapshot()

    def reset(self) -> bool:
        """Reload the initial-state slot (≙ resetToInitial, main.ts:347)."""
        if self._initial_state is None:
            return False
        return self.load_snapshot(self._initial_state)

    # ---- fault injection (engine.ts:201-203) ----

    def corrupt_buffers(self) -> None:
        self._worker.post_with_ack(MessageType.CORRUPT_BUFFERS)

    # ---- input (engine.ts:46-125) ----

    def key_down(self, key: str) -> None:
        self._held_keys.add(key.lower())
        self._send_input()

    def key_up(self, key: str) -> None:
        self._held_keys.discard(key.lower())
        self._send_input()

    def mouse(self, pos, active: bool) -> None:
        self._mouse_pos = np.asarray(pos, np.float32)
        self._mouse_active = bool(active)
        self._send_input()

    def blur(self) -> None:
        """Window blur: clear all held input (engine.ts:117-121)."""
        self._held_keys.clear()
        self._mouse_active = False
        self._send_input(force=True)

    def _applied_force(self) -> np.ndarray:
        """WASD → force vector (engine.ts:69-75)."""
        k = self.keyboard_force
        held = self._held_keys
        fx = (k if "d" in held else 0.0) - (k if "a" in held else 0.0)
        fy = (k if "w" in held else 0.0) - (k if "s" in held else 0.0)
        return np.array([fx, fy], np.float32)

    def _send_input(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_input_send < self._input_throttle_s:
            return  # coalesced: the worker reads the latest slot each frame
        self._last_input_send = now
        self._worker.post(MessageType.INPUT, (
            self._applied_force(), self._mouse_pos, self._mouse_active,
            self.user_strength))

    # ---- visibility (engine.ts:122-124) ----

    def set_hidden(self, hidden: bool) -> None:
        self._worker.post(MessageType.VISIBILITY_CHANGE, hidden)

    # ---- observability ----

    def render_packet(self) -> Optional[RenderPacket]:
        """The last frame for drawing.  The device → host transfer runs on
        THIS thread (``EngineWorker.host_packet``), so polling at any rate
        never stalls stepping; the GET_RENDER_PACKET message remains for
        protocol parity (engine.ts's message surface)."""
        return self._worker.host_packet()

    def render_packet_rpc(self) -> Optional[RenderPacket]:
        """The packet built on the worker's thread through the message
        protocol (it holds stepping for the readback)."""
        return self._worker.post_with_ack(MessageType.GET_RENDER_PACKET)

    def stats(self) -> EngineStats:
        return self._worker.post_with_ack(MessageType.GET_STATS)

    def broad_phase_overflow(self) -> int:
        """The broad phase's current truncation count (grid cell-capacity
        or window-row clipping; 0 for exhaustive or stencil modes),
        computed on demand, outside the frame loop."""
        return int(self._worker.post_with_ack(MessageType.GET_BP_OVERFLOW))

    @property
    def fps(self) -> float:
        return self._worker.fps

    # ---- option-change re-creation (≙ main.ts:137-146) ----

    def recreate(self, options: Optional[EngineOptions] = None,
                 **overrides) -> "Engine":
        """Rebuild the engine with new compile-time options, carrying the
        world through a snapshot — the reference's apply-options flow
        (save → destroy → new engine → load, main.ts:137-146) — on the
        same device.  Pass a full ``EngineOptions`` or field overrides
        (``recreate(subticks=32)``).  Returns the NEW engine; this one is
        destroyed."""
        buf = self.save_snapshot()
        initial = self._initial_state
        opts = options if options is not None else dataclasses.replace(
            self.options, **overrides)
        self.destroy()
        new = self._construct_from_snapshot(buf, opts)
        new._initial_state = initial
        return new

    def _construct_from_snapshot(self, buf: bytes, opts: EngineOptions):
        state, consts = load_snapshot(buf, max_particles=opts.max_particles,
                                      max_beams=opts.max_beams,
                                      device=self.device)
        return Engine(state, consts, opts, device=self.device)

    # ---- lifecycle (engine.ts:225-238) ----

    def destroy(self) -> None:
        if self._destroyed:
            return
        self._destroyed = True
        try:
            self._worker.post_with_ack(MessageType.DESTROY, timeout=30.0)
        except (TimeoutError, RuntimeError):
            pass
        self._worker.join(timeout=30.0)

    @property
    def destroyed(self) -> bool:
        return self._destroyed

    @property
    def error(self) -> Optional[BaseException]:
        return self._worker.error

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()


class LatticeEngine(Engine):
    """The engine on a dense lattice backend (lattice scenes): the same
    message surface; snapshots in the L1 lattice format.

    ``fused=False``: :class:`LatticeBackend` (the stencil path; its
    collisions through K3 under ``options.use_pallas``).  ``fused=True``:
    :class:`FusedLatticeBackend` with its default kernel variants, the
    JAX package's (rollgroup, rsqrt, dexp2 and layout flags; K1 in its
    rsqrt+rollgroup instance; with ``farfield`` the fixed-cadence far
    field with K2 and K7), as the JAX package's ``LatticeEngine(fused=
    True)`` runs them.  They differ from the strict physics by 1–2 ulp
    per operation; the strict path is that backend with
    ``kernel_variants=()``.  ``tile_w`` is the TPU kernel's tile width: it
    is accepted for the JAX signature and ignored (the CUDA kernels pick
    their own tiles)."""

    def __init__(self, state, spec, consts: Optional[PhysicsConstants] = None,
                 options: Optional[EngineOptions] = None, farfield=None,
                 fused: bool = False, tile_w: int = 128, *,
                 device=None) -> None:
        options = options or EngineOptions()
        cfg = StaticConfig(
            bounds_size=options.bounds_size,
            particle_radius=options.particle_radius,
            subticks=options.subticks,
            collision_mode=options.collision_mode,
            force_mode=options.force_mode,
            use_pallas=options.use_pallas,
        )
        if fused:
            backend = FusedLatticeBackend(spec, cfg, farfield=farfield,
                                          device=device)
            state = backend.pack_state(state)
        else:
            backend = LatticeBackend(spec, cfg, farfield=farfield,
                                     device=device)
        self._spec = spec
        self._farfield = farfield
        self._fused = fused
        self._tile_w = tile_w
        super().__init__(state, consts, options, backend=backend)

    def _construct_from_snapshot(self, buf: bytes, opts: EngineOptions):
        state, consts = load_lattice_snapshot(buf, device=self.device)
        return LatticeEngine(state, self._spec, consts, opts,
                             farfield=self._farfield, fused=self._fused,
                             tile_w=self._tile_w, device=self.device)
