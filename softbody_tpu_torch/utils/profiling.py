"""Observability (port of ``softbody_tpu/utils/profiling.py``): rolling
FPS / substeps-per-sec counters and an optional ``torch.profiler`` trace
hook.

The reference's only perf instrument is a rolling 1 s frame counter drawn
on the canvas (engineWorker.ts:689-698, engine.ts:217; SURVEY.md §5
"Tracing / profiling").  The port keeps the same rolling counters plus
particle-substeps/sec, and writes Chrome traces (Perfetto reads them)
through ``torch.profiler``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


class FrameClock:
    """Rolling 1-second frame counter (≙ engineWorker.ts:689-698)."""

    def __init__(self, window_s: float = 1.0) -> None:
        self.window_s = window_s
        self._times: list[float] = []

    def tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._times.append(now)
        cutoff = now - self.window_s
        while self._times and self._times[0] < cutoff:
            self._times.pop(0)

    @property
    def fps(self) -> float:
        return len(self._times) / self.window_s


class Profiler:
    """Substeps/sec + particle-substeps/sec accounting over a run."""

    def __init__(self, subticks: int, particle_count: int) -> None:
        self.subticks = subticks
        self.particle_count = particle_count
        self.frames = 0
        self._t0: Optional[float] = None
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> None:
        if self._t0 is not None:
            self.elapsed += time.monotonic() - self._t0
            self._t0 = None

    def add_frames(self, n: int) -> None:
        self.frames += n

    @property
    def substeps_per_sec(self) -> float:
        return self.frames * self.subticks / self.elapsed if self.elapsed else 0.0

    @property
    def particle_substeps_per_sec(self) -> float:
        return self.substeps_per_sec * self.particle_count


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Wrap a block in ``torch.profiler.profile`` (CPU and, where there is
    a card, CUDA activities) when ``log_dir`` is given, and write its
    Chrome trace to ``log_dir/trace.json`` (view in Perfetto); no-op
    otherwise."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
