"""FIFO lock: the port of ``softbody_tpu/engine/lock.py`` (≙
``AsyncLock``, lock.ts:4-18).

The reference serializes every user of the GPU queue (frame loop,
snapshot load, constant writes) behind a promise-chain mutex
(engineWorker.ts:553,584,632).  Here it guards the device-state slot
between the stepping thread and the host's messages.  Python's
``threading.Lock`` is not FIFO-fair; this one is, keeping the
reference's strict arrival order."""

from __future__ import annotations

import collections
import threading


class FifoLock:
    """Strictly first-in-first-out mutual exclusion."""

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._waiters: collections.deque[threading.Event] = collections.deque()
        self._held = False

    def acquire(self) -> None:
        with self._mutex:
            if not self._held and not self._waiters:
                self._held = True
                return
            ev = threading.Event()
            self._waiters.append(ev)
        ev.wait()

    def release(self) -> None:
        with self._mutex:
            if self._waiters:
                self._waiters.popleft().set()
            else:
                self._held = False

    def __enter__(self) -> "FifoLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def locked(self) -> bool:
        with self._mutex:
            return self._held or bool(self._waiters)
