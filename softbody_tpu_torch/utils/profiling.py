"""Observability (port of ``softbody_tpu/utils/profiling.py``):
substeps-per-sec counters, an optional ``torch.profiler`` trace hook,
and the port's own tracer.

The reference's only perf instrument is a rolling 1 s frame counter drawn
on the canvas (engineWorker.ts:689-698, engine.ts:217; SURVEY.md §5
"Tracing / profiling").  The port keeps substeps/sec and
particle-substeps/sec, and writes Chrome traces (Perfetto reads them)
through ``torch.profiler``.

**The tracer** is off unless a block runs under :func:`tracing`.

- :func:`span` marks a host phase of the program (``backend.step``,
  ``compiled.call`` and its children).  Off, it returns one shared no-op
  context and reads no clock.  On, it records its name, id, parent's id,
  frame id (the id of the outermost span open on its thread: every span
  of one frame shares it) and its start and end
  (``time.perf_counter_ns``); while a ``torch.profiler`` records, it is
  also a ``record_function`` range, so the program's phases lie on the
  profiler's timeline beside the device's kernels.
- :func:`device_mark` marks, inside a frame function, where a layer's
  device work begins (``rebuild``, ``far_apply``, ``substep``, ``end``).
  On the card it launches ``sb_stamp`` (``csrc/graph_cond.cu``: one
  thread writes ``%globaltimer`` into a slot), which a capture records as
  a graph node; on the CPU it reads the host clock.  A captured frame's
  marks go into the stamp buffer of its graph (:class:`Marks`, kept by
  ``ops/compiled.py`` beside the graph); after each replay the used slots
  are cloned into the tracer's log (one device copy, no synchronisation).
- :func:`drain` synchronises once and hands back the spans and, per
  frame, the marks and the time from each mark to the next, summed by
  label.

Whether tracing is on is part of a compiled frame's key: a graph
captured with tracing off holds no stamp node and is the one replayed
with tracing off."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function


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


# ------------------------------------------------------------- the tracer


@dataclasses.dataclass
class Span:
    """One host phase: ``frame`` is the id of the outermost span that was
    open on its thread (its own id where none was)."""

    name: str
    id: int
    parent: Optional[int]
    frame: int
    start_ns: int = 0
    end_ns: int = 0
    _range: object = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Span":
        _stack().append(self)
        if torch._C._autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()
        _TRACER.spans.append(self)


class _Tracer:
    """The process's tracing switch and log; each thread keeps its own
    stack of open spans and the stamp buffer it marks into."""

    def __init__(self) -> None:
        self.on = False
        self.spans: List[Span] = []
        self.marks: list = []           # (frame, labels, int64 stamps)
        self.ids = itertools.count(1)
        self.local = threading.local()


_TRACER = _Tracer()
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_TRACER.local, "stack", None)
    if stack is None:
        stack = _TRACER.local.stack = []
    return stack


def _frame() -> Optional[int]:
    stack = _stack()
    return stack[0].frame if stack else None


def enabled() -> bool:
    """Whether the tracer is on (:func:`tracing`)."""
    return _TRACER.on


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Turn the tracer on for a block (off again after it, unless it was
    on before)."""
    before = _TRACER.on
    _TRACER.on = True
    try:
        yield
    finally:
        _TRACER.on = before


def span(name: str):
    """A host phase named ``name`` (a context manager; see the module's
    docstring); with tracing off, a shared no-op."""
    if not _TRACER.on:
        return _OFF
    stack = _stack()
    parent = stack[-1] if stack else None
    i = next(_TRACER.ids)
    return Span(name, i, None if parent is None else parent.id,
                i if parent is None else parent.frame)


def _stamp(stamps: torch.Tensor, i: int) -> None:
    """Launch ``sb_stamp`` on the current stream: slot ``i`` of the int64
    ``stamps`` ← the card's ``%globaltimer`` (ns) when the device gets
    there."""
    from ..ops.cuda import _lib

    lib = _lib.library()
    stream = torch.cuda.current_stream(stamps.device).cuda_stream
    _lib.check(lib.sb_stamp(stamps.data_ptr() + 8 * i, stream),
               "device_mark: sb_stamp")


class Marks:
    """The device marks of one captured frame: the ``labels`` in the
    order the frame makes them and an int64 slot each in ``stamps``
    (allocated before the capture; :data:`CAPACITY` slots, and a frame
    that makes more raises).  ``ops/compiled.py`` keeps one beside each
    graph captured with tracing on; :func:`recording` makes it the buffer
    the frame marks into."""

    CAPACITY = 1024

    def __init__(self, device) -> None:
        self.stamps = torch.zeros(self.CAPACITY, dtype=torch.int64,
                                  device=device)
        self.labels: List[str] = []
        self.frozen = False
        self.cursor = 0
        if self.stamps.is_cuda:
            # the stamp kernel loaded before any capture
            _stamp(self.stamps, 0)

    def slot(self, label: str) -> int:
        i = self.cursor
        if i == self.CAPACITY:
            raise RuntimeError(f"a frame made more than {self.CAPACITY} "
                               "device marks")
        if not self.frozen:
            self.labels.append(label)
        elif self.labels[i] != label:
            raise RuntimeError(f"device mark {i} is {label!r}, captured as "
                               f"{self.labels[i]!r}")
        self.cursor += 1
        return i

    def reset(self) -> None:
        """Forget the marks made so far (a warm-up's)."""
        self.labels.clear()
        self.cursor = 0

    def log(self) -> None:
        """Clone the slots of the last replay into the tracer's log, under
        the frame of the span open on this thread."""
        n = len(self.labels)
        _TRACER.marks.append((_frame(), tuple(self.labels),
                              self.stamps[:n].clone()))


def recording(marks: Optional[Marks]):
    """Make ``marks`` the buffer this thread's :func:`device_mark` calls
    write into, from its first slot (a no-op for None)."""
    if marks is None:
        return _OFF
    return _Recording(marks)


class _Recording:
    def __init__(self, marks: Marks) -> None:
        self.marks = marks

    def __enter__(self) -> Marks:
        self.before = getattr(_TRACER.local, "marks", None)
        _TRACER.local.marks = self.marks
        self.marks.cursor = 0
        return self.marks

    def __exit__(self, *exc) -> None:
        _TRACER.local.marks = self.before


def device_mark(label: str, like: torch.Tensor) -> None:
    """Mark the start of the layer ``label`` on ``like``'s device (see the
    module's docstring); nothing with tracing off.  Call it in a frame's
    main chain, never in a ``device_if`` / ``device_switch`` body, so
    that every replay writes every slot."""
    if not _TRACER.on:
        return
    marks = getattr(_TRACER.local, "marks", None)
    cuda = like.device.type == "cuda"
    if marks is None:
        # outside a captured frame: a slot of its own
        if cuda:
            t = torch.empty(1, dtype=torch.int64, device=like.device)
            _stamp(t, 0)
        else:
            t = torch.full((1,), time.perf_counter_ns(), dtype=torch.int64)
        _TRACER.marks.append((_frame(), (label,), t))
        return
    i = marks.slot(label)
    if cuda:
        _stamp(marks.stamps, i)
    else:
        marks.stamps[i].fill_(time.perf_counter_ns())


@dataclasses.dataclass
class Drained:
    """What the tracer logged since the last :func:`drain`: the finished
    spans in the order they ended, and per frame id (None for marks made
    outside any span) its marks ``[(label, ns)]`` in order."""

    spans: List[Span]
    marks: Dict[Optional[int], list]

    def split(self) -> Dict[Optional[int], Dict[str, float]]:
        """Per frame ``{label: ms}``: the time from each mark to the next,
        summed by label (the last mark ends the frame and counts none)."""
        out = {}
        for frame, marks in self.marks.items():
            ms: Dict[str, float] = {}
            for (label, a), (_next, b) in zip(marks, marks[1:]):
                ms[label] = ms.get(label, 0.0) + (b - a) / 1e6
            out[frame] = ms
        return out


def drain() -> Drained:
    """Synchronise once (where a mark lies on the card) and take the
    tracer's log: :class:`Drained`."""
    spans, _TRACER.spans = _TRACER.spans, []
    logged, _TRACER.marks = _TRACER.marks, []
    if any(t.device.type == "cuda" for _f, _l, t in logged):
        torch.cuda.synchronize()
    marks: Dict[Optional[int], list] = {}
    for frame, labels, stamps in logged:
        marks.setdefault(frame, []).extend(zip(labels, stamps.tolist()))
    return Drained(spans, marks)
