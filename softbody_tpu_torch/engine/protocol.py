"""Host ⇄ worker message protocol: the port of
``softbody_tpu/engine/protocol.py`` (≙ ``WGPUSoftbodyEngineMessageTypes``
and the option and constant structs, engine.ts:3-29).

The reference runs its engine in a Web Worker and talks to it with
``postMessage`` and acks (engine.ts:153-171).  The runtime keeps that
shape: one engine thread owns all device work, the host posts typed
messages to its queue, and request/response messages carry a reply
event, so the host side (UI, editor, checkpoint IO) never blocks the
stepping loop.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Optional


class MessageType(enum.Enum):
    INIT = enum.auto()
    DESTROY = enum.auto()
    PHYSICS_CONSTANTS = enum.auto()
    GET_PHYSICS_CONSTANTS = enum.auto()
    INPUT = enum.auto()
    VISIBILITY_CHANGE = enum.auto()
    SNAPSHOT_SAVE = enum.auto()
    SNAPSHOT_LOAD = enum.auto()
    FRAMERATE = enum.auto()
    CORRUPT_BUFFERS = enum.auto()
    # extensions of the reference's set
    GET_RENDER_PACKET = enum.auto()
    GET_STATS = enum.auto()
    GET_BP_OVERFLOW = enum.auto()


@dataclasses.dataclass
class Message:
    """A queue entry; ``reply_event``/``reply`` implement
    postMessageWithAck (engine.ts:159-171)."""

    type: MessageType
    data: Any = None
    reply_event: Optional[threading.Event] = None
    reply: Any = None

    def respond(self, value: Any = None) -> None:
        self.reply = value
        if self.reply_event is not None:
            self.reply_event.set()


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """≙ ``WGPUSoftbodyEngineOptions`` (engine.ts:16-19) plus the
    engine's own knobs, with the JAX package's fields and defaults.

    ``subticks`` is rounded up to even like the reference
    (engineWorker.ts:90; ``StaticConfig`` does it)."""

    particle_radius: float = 10.0
    subticks: int = 64
    bounds_size: float = 1000.0
    collision_mode: str = "allpairs"
    force_mode: str = "quantized"
    grid_cell_capacity: int = 8
    use_pallas: bool = False
    max_particles: Optional[int] = None
    max_beams: Optional[int] = None
    # frame pacing: None = step flat-out; otherwise target frames/sec
    target_fps: Optional[float] = 60.0
