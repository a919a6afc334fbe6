"""Engine worker: the runtime that owns the device state and runs the
frame loop (≙ ``WGPUSoftbodyEngineWorker``, engineWorker.ts:21-725); the
port of ``softbody_tpu/engine/worker.py``.

- A frame is one ``backend.step`` call on the worker's thread, with the
  state on the backend's device (the thread enters that CUDA device:
  torch's current device is per thread).
- Render readback is decoupled: at frame end the backend extracts device
  copies of the render planes (``backend.extract``, no host sync); a
  host thread builds its packet from them (``host_packet``) on a side
  stream that waits for those copies only (backends.py), so polling at
  any rate never stalls stepping and a packet never waits for the frames
  launched after it.
- ``corrupt_buffers`` fault injection (engineWorker.ts:599-617) pokes
  random u32 bit patterns into random offsets of the state's arrays.
- Hidden-visibility throttling (engineWorker.ts:699-708): a paused
  engine polls its queue every 100 ms.
- An error in the thread stops it; ``error`` holds it and every later
  ``post_with_ack`` raises ``RuntimeError`` from it (≙ engine.ts:139).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import PhysicsConstants, StaticConfig, UserInput
from .lock import FifoLock
from .protocol import EngineOptions, Message, MessageType


@dataclasses.dataclass
class RenderPacket:
    """Host-side view of one frame for drawing (what the reference's render
    pass consumes: positions and per-beam stress/strain colours,
    render.wgsl:77-83)."""

    pos: np.ndarray
    particle_alive: np.ndarray
    beam_a: np.ndarray
    beam_b: np.ndarray
    beam_alive: np.ndarray
    beam_strain: np.ndarray
    beam_stress: np.ndarray
    frame_index: int


@dataclasses.dataclass
class EngineStats:
    fps: float
    substeps_per_sec: float
    particle_substeps_per_sec: float
    frame_index: int
    particle_count: int
    beam_count: int
    # far-field self-collision (lattice backends with a FarFieldSpec;
    # zeros otherwise).  ``far_active``: the fused backend's max active
    # pairs (its far stats carry four keys; the JAX package's
    # EngineStats lacks this field and fails on them)
    far_pairs: int = 0
    far_rebuilds: int = 0
    far_overflow: int = 0
    far_active: int = 0


class EngineWorker:
    """Background engine thread; use it through :class:`.engine.Engine`.

    ``backend`` defaults to a :class:`~.backends.SimBackend` on
    ``device`` (default: the CUDA device; raises ``RuntimeError`` without
    one); a given backend brings its own device."""

    def __init__(self, state, consts: Optional[PhysicsConstants] = None,
                 options: Optional[EngineOptions] = None, backend=None, *,
                 device=None) -> None:
        opts = options or EngineOptions()
        self.options = opts
        self.cfg = StaticConfig(
            bounds_size=opts.bounds_size,
            particle_radius=opts.particle_radius,
            subticks=opts.subticks,
            collision_mode=opts.collision_mode,
            force_mode=opts.force_mode,
            grid_cell_capacity=opts.grid_cell_capacity,
            use_pallas=opts.use_pallas,
        )
        if backend is None:
            from .backends import SimBackend

            backend = SimBackend(self.cfg, max_particles=opts.max_particles,
                                 max_beams=opts.max_beams, device=device)
        self.backend = backend
        self.device = backend.device
        self._state = state
        self._consts = consts or PhysicsConstants.default()
        self._uin_host = {
            "applied_force": (0.0, 0.0),
            "mouse_pos": np.zeros(2, np.float32),
            "mouse_active": False,
        }
        self._last_mouse = np.zeros(2, np.float32)
        self._last_frame_t = time.monotonic()
        self._user_strength = 1.0

        self._lock = FifoLock()
        self._queue: "queue.Queue[Message]" = queue.Queue()
        self._running = True
        self._visible = True
        self._frame_index = 0
        self._frame_times: list[float] = []
        self._render_src = None  # the backend's Extracted of the last frame
        self._render_frame = -1
        self._packet_lock = threading.Lock()
        self.error: Optional[BaseException] = None

        self._thread = threading.Thread(
            target=self._run, name="softbody-engine-worker", daemon=True)
        self._thread.start()

    # ---- thread body ----

    def _run(self) -> None:
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with on_card:
                while self._running:
                    self._drain_messages()
                    if not self._running:
                        break
                    if self._visible:
                        self._frame()
                        self._pace()
                    else:
                        # hidden tab: 100 ms polls (engineWorker.ts:699-708)
                        time.sleep(0.1)
        except Exception as e:  # surfaced to the host (≙ engine.ts:139)
            self.error = e
            self._running = False

    def _pace(self) -> None:
        target = self.options.target_fps
        if not target:
            return
        next_t = self._last_frame_t + 1.0 / target
        now = time.monotonic()
        if next_t > now:
            time.sleep(next_t - now)

    def _drain_messages(self) -> None:
        while True:
            try:
                msg = self._queue.get_nowait()
            except queue.Empty:
                return
            self._handle(msg)

    def _handle(self, msg: Message) -> None:
        t = msg.type
        if t == MessageType.DESTROY:
            self._running = False
            msg.respond()
        elif t == MessageType.PHYSICS_CONSTANTS:
            with self._lock:
                self._consts = msg.data
            msg.respond(self._consts)
        elif t == MessageType.GET_PHYSICS_CONSTANTS:
            msg.respond(self._consts)
        elif t == MessageType.INPUT:
            force, mouse_pos, mouse_active, strength = msg.data
            f = np.asarray(force, np.float32)
            self._uin_host["applied_force"] = (float(f[0]), float(f[1]))
            self._uin_host["mouse_pos"] = np.asarray(mouse_pos, np.float32)
            self._uin_host["mouse_active"] = bool(mouse_active)
            self._user_strength = float(strength)
            msg.respond()
        elif t == MessageType.VISIBILITY_CHANGE:
            self._visible = not bool(msg.data)
            msg.respond()
        elif t == MessageType.SNAPSHOT_SAVE:
            with self._lock:
                buf = self.backend.save(self._state, self._consts)
            msg.respond(buf)
        elif t == MessageType.SNAPSHOT_LOAD:
            loaded = self.backend.load(msg.data)
            if loaded is None:
                msg.respond(False)
                return
            state, consts = loaded
            with self._lock:
                self._state = state
                self._consts = consts
                with self._packet_lock:
                    self._render_src = None
                    self._render_frame = -1
            msg.respond(True)
        elif t == MessageType.CORRUPT_BUFFERS:
            with self._lock:
                self._state = self.backend.corrupt(self._state,
                                                   np.random.default_rng())
            msg.respond()
        elif t == MessageType.GET_RENDER_PACKET:
            msg.respond(self._make_packet())
        elif t == MessageType.GET_STATS:
            msg.respond(self._stats())
        elif t == MessageType.GET_BP_OVERFLOW:
            if hasattr(self.backend, "broad_phase_overflow"):
                with self._lock:
                    msg.respond(
                        self.backend.broad_phase_overflow(self._state))
            else:
                msg.respond(0)
        else:
            msg.respond(None)

    # ---- frame (≙ engineWorker.ts:626-695) ----

    def _frame(self) -> None:
        with self._lock:
            now = time.monotonic()
            dt_wall = max(now - self._last_frame_t, 1e-6)
            mouse = self._uin_host["mouse_pos"]
            # mouse velocity in world units per sim frame:
            # Δpos · fps · Δt_wall (≙ engineWorker.ts:638-640)
            mouse_vel = ((mouse - self._last_mouse)
                         * (max(self.fps, 1.0) * dt_wall)).astype(np.float32)
            self._last_mouse = mouse.copy()
            self._last_frame_t = now
            uin = UserInput(
                user_strength=self._user_strength,
                mouse_active=self._uin_host["mouse_active"],
                mouse_pos=(float(mouse[0]), float(mouse[1])),
                mouse_vel=(float(mouse_vel[0]), float(mouse_vel[1])),
                applied_force=self._uin_host["applied_force"],
            )
            self._state = self.backend.step(self._state, self._consts, uin)
            self._frame_index += 1
            # the decoupled render source: device copies, no host sync
            src = self.backend.extract(self._state)
            with self._packet_lock:
                self._render_src = src
                self._render_frame = self._frame_index
        self._frame_times.append(now)
        cutoff = now - 1.0
        while self._frame_times and self._frame_times[0] < cutoff:
            self._frame_times.pop(0)

    def _make_packet(self) -> Optional[RenderPacket]:
        with self._packet_lock:
            src, idx = self._render_src, self._render_frame
        if src is None:
            return None
        return RenderPacket(*self.backend.packet_arrays(src), idx)

    def host_packet(self) -> Optional[RenderPacket]:
        """The decoupled readback: the packet of the last frame, built on
        the CALLING thread from the copies extracted at that frame's end
        (≙ the staging buffers, engineWorker.ts:453-478), so a large
        readback never blocks the stepping thread (the reference's
        ``mapAsync`` never blocks its render loop either).  Thread-safe:
        the source is replaced, never mutated, under ``_packet_lock``."""
        return self._make_packet()

    def _stats(self) -> EngineStats:
        fps = self.fps
        n, m = self.backend.counts(self._state)
        far = (self.backend.far_stats()
               if hasattr(self.backend, "far_stats") else {})
        return EngineStats(
            fps=fps,
            substeps_per_sec=fps * self.cfg.subticks,
            particle_substeps_per_sec=fps * self.cfg.subticks * n,
            frame_index=self._frame_index,
            particle_count=n,
            beam_count=m,
            **far,
        )

    @property
    def fps(self) -> float:
        return float(len(self._frame_times))

    # ---- host-side entry ----

    def post(self, type: MessageType, data: Any = None) -> None:
        self._queue.put(Message(type, data))

    def post_with_ack(self, type: MessageType, data: Any = None,
                      timeout: Optional[float] = 120.0) -> Any:
        """Post and wait for the reply.  Raises ``RuntimeError`` as soon
        as the worker has died (its error chained), ``TimeoutError`` when
        no reply came within ``timeout`` seconds."""
        ev = threading.Event()
        msg = Message(type, data, reply_event=ev)
        self._queue.put(msg)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ev.wait(0.05):
            if self.error is not None:
                raise RuntimeError("engine worker died") from self.error
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"engine worker did not ack {type}")
        return msg.reply

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._running and self._thread.is_alive()
