"""The runtime (port of ``softbody_tpu.engine``): the host façade, the
worker thread, the message protocol, the FIFO lock, and the backends
that step each state representation."""

from .backends import (  # noqa: F401
    FusedLatticeBackend,
    LatticeBackend,
    PlanifiedBackend,
    SimBackend,
)
from .engine import Engine, LatticeEngine  # noqa: F401
from .lock import FifoLock  # noqa: F401
from .protocol import EngineOptions, Message, MessageType  # noqa: F401
from .worker import EngineStats, EngineWorker, RenderPacket  # noqa: F401
