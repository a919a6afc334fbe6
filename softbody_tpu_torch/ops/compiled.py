"""Compiled frames: the port's counterpart of the JAX package's
``jax.jit(fn, static_argnames=..., donate_argnames=...)`` over a frame
function (``ops/step.frame_jit``, ``ops/stencil.lattice_frame_jit``, ...).

A :class:`Compiled` wraps a frame function.  On CUDA tensors each call
runs a CUDA graph of the function, captured once per key and replayed
after that; on CPU tensors it runs the function itself (the caller asked
for the CPU, where the plain torch versions run: no graph exists there).

**The key** holds everything a capture bakes into its launches:

- the function (one cache per :class:`Compiled`) and its static
  arguments (``static_argnames``: ``cfg``, ``spec``, ``ffspec``,
  ``n_sub``), by value;
- every tensor argument's shape, dtype, strides and device (a far list's
  capacity is its tensors' shape);
- every other argument by value, floats by their bits: the physics
  constants and the user input.  The frame functions read these on the
  host (``config.consts_vector`` through ``stencil.Scalars``,
  ``stencil.device_scalar``, K3's scalar arguments), so a graph holds
  them as numbers; another mouse position is another key.

The cache is bounded (least recently used first out) and counts its
misses, captures and replays.

**A call** copies its tensors into the graph's static inputs, replays
the graph on the caller's stream and hands back fresh copies of the
graph's outputs; an output that is an input passed through unchanged
(a rest length, a spring constant) is handed back as the caller's own
tensor.  So the state a call returns is never a buffer that a later call
overwrites, whatever states are passed in between, and the input stays
valid: JAX's donation lets XLA reuse the input's buffers for the result,
and nothing here needs that.

**A miss** copies the inputs in, runs the function once on a side
stream as a warm-up (the first capture of a set of shapes only: kernels
load and the kernel library builds at their first launch) and throws
that result away, captures (which launches nothing), then replays as
any call does: the first call advances the state exactly once.  A
function that writes into its inputs is refused (a replay would write
into the static inputs, not the caller's tensors).

**Launch counters**: the kernel wrappers count their launches on the
host (``K1_LAUNCHES`` ... ``K7_LAUNCHES``), and a replay runs no Python.
A capture records what the wrappers counted while it was captured and
every replay adds that again; what the warm-up and the capture counted
is taken back (the warm-up's result is discarded, the capture launches
nothing).

**No fallback**: on CUDA tensors a capture or a replay that fails
raises.  A host synchronisation inside the function (``.item()``,
``.tolist()`` of a device tensor, ``nonzero``, a blocking copy) fails
the capture.

**Threads and memory**: graphs are captured with
``capture_error_mode="thread_local"``, so the engine's worker captures
while another thread copies render packets on a side stream.  Every
graph of the process on one device draws on one memory pool, and calls
run one at a time: a lock on the host, and an event after each call's
copies that the next call's stream waits for.  So a capture may reuse
the intermediate memory of every earlier one: each call has copied its
outputs out before another graph replays.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import importlib
import inspect
import struct
import threading
from typing import Callable, Dict, Sequence

import torch

# the kernel wrappers' launch counters: (module, name), an int or a dict
# of ints (K1's per instance)
LAUNCH_COUNTERS = (
    (".cuda.fused_substep2", "K1_LAUNCHES"),
    (".cuda.fused_substep2", "K1_INSTANCE_LAUNCHES"),
    (".cuda.band_detect", "K2_LAUNCHES"),
    (".cuda.collide_stencil", "K3_LAUNCHES"),
    (".cuda.fused_substep", "K4_LAUNCHES"),
    (".cuda.recmirror", "K5_LAUNCHES"),
    (".cuda.recmirror", "K6_LAUNCHES"),
    (".cuda.recmirror", "K7_LAUNCHES"),
)

# graphs kept per compiled function (JAX keeps every compilation; a
# graph holds its static inputs and outputs, a state's size each)
MAX_GRAPHS = 32

# one call at a time, process-wide; per CUDA device one memory pool and
# the event after the last call's copies; the graphs of failed captures
_LOCK = threading.RLock()
_POOLS: Dict[int, tuple] = {}
_LAST: Dict[int, torch.cuda.Event] = {}
_ABANDONED: list = []


def read_counts() -> dict:
    """The launch counters' current values (dicts copied)."""
    out = {}
    for mod, name in LAUNCH_COUNTERS:
        v = getattr(importlib.import_module(mod, __package__), name)
        out[mod, name] = dict(v) if isinstance(v, dict) else v
    return out


def set_counts(counts: dict) -> None:
    """Set the launch counters to ``counts`` (from :func:`read_counts`)."""
    for (mod, name), v in counts.items():
        m = importlib.import_module(mod, __package__)
        if isinstance(v, dict):
            d = getattr(m, name)
            d.clear()
            d.update(v)
        else:
            setattr(m, name, v)


def _count_delta(after: dict, before: dict) -> dict:
    delta = {}
    for k, v in after.items():
        if isinstance(v, dict):
            d = {i: n - before[k].get(i, 0) for i, n in v.items()}
            d = {i: n for i, n in d.items() if n}
            if d:
                delta[k] = d
        elif v != before[k]:
            delta[k] = v - before[k]
    return delta


def _add_counts(delta: dict) -> None:
    for (mod, name), d in delta.items():
        m = importlib.import_module(mod, __package__)
        if isinstance(d, dict):
            counter = getattr(m, name)
            for i, n in d.items():
                counter[i] = counter.get(i, 0) + n
        else:
            setattr(m, name, getattr(m, name) + d)


def _is_record(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def tensors(obj):
    """The tensors of a tree of dataclasses, tuples, lists and dicts, in
    a fixed order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif _is_record(obj):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors(x)


def _rebuilt(obj, fn: Callable):
    """``obj`` with each tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if _is_record(obj):
        new = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, _rebuilt(getattr(obj, f.name),
                                                     fn))
        return new
    if isinstance(obj, tuple) and hasattr(type(obj), "_fields"):
        return type(obj)(*(_rebuilt(x, fn) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuilt(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: _rebuilt(v, fn) for k, v in obj.items()}
    return obj


def _signature(obj, values: bool):
    """What a capture bakes in besides the tensors' contents: the tree's
    structure, each tensor's layout and, with ``values``, every other
    leaf (floats by their bits, so -0.0 and NaN key as themselves);
    without ``values`` floats and bools are left out (the shapes' key)."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.stride(),
                obj.device)
    if _is_record(obj):
        return (type(obj),) + tuple(
            (f.name, _signature(getattr(obj, f.name), values))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_signature(x, values) for x in obj)
    if isinstance(obj, dict):
        return (dict,) + tuple((k, _signature(v, values))
                               for k, v in obj.items())
    if isinstance(obj, (bool, float)) and not values:
        return type(obj)
    if isinstance(obj, float):
        return (float, struct.pack("<d", obj))
    return (type(obj), obj)


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the cache's three calls: a
    warm-up and the capture on a side stream, replays on the current
    stream."""

    device_type = "cuda"

    def __init__(self, device: torch.device) -> None:
        self.device = device
        if device.index not in _POOLS:
            _POOLS[device.index] = torch.cuda.graph_pool_handle()
        self.pool = _POOLS[device.index]
        self.graph = torch.cuda.CUDAGraph()
        self.side = torch.cuda.Stream(device)

    def warm_up(self, run: Callable) -> None:
        with torch.cuda.device(self.device):
            self.side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.side):
                run()

    def capture(self, run: Callable):
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                out = run()
            except BaseException:
                self._abandon()
                raise
            self.graph.capture_end()
            return out

    def _abandon(self) -> None:
        """End a capture that ``run`` broke off.  ``capture_end`` of an
        invalidated capture (a host synchronisation in ``run``) raises
        before it stops the allocator from drawing on the pool, and
        torch (2.11) then refuses every later capture into that pool:
        stop the drawing, and let later captures take a new pool.  The
        graph is kept alive (the allocator held a reference to it)."""
        try:
            self.graph.capture_end()
        except RuntimeError:
            try:
                torch._C._cuda_endAllocateToPool(self.device.index,
                                                 self.pool)
            except RuntimeError:   # this torch had stopped it already
                pass
            if _POOLS.get(self.device.index) == self.pool:
                del _POOLS[self.device.index]
            _ABANDONED.append(self.graph)

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class _Entry:
    graph: object
    inputs: list            # static input tensors, in argument order
    out: object             # the function's output on the static inputs
    passed: dict            # id(static input) -> its index (pass-through)
    counts: dict            # launch counts one replay stands for


class Compiled:
    """``fn`` run as captured graphs on CUDA tensors (see the module's
    docstring).  ``static_argnames``: arguments keyed by value and passed
    to ``fn`` as they are (hashable).  ``graph_cls``: the graph type
    (:class:`CudaGraph`; its ``device_type`` names the tensors it
    captures, a call on any other device runs ``fn``).  Keeps at most
    ``MAX_GRAPHS`` graphs; counts ``misses``, ``captures``, ``replays``."""

    def __init__(self, fn: Callable, static_argnames: Sequence[str] = (),
                 *, graph_cls=CudaGraph) -> None:
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.static_argnames = tuple(static_argnames)
        self.graph_cls = graph_cls
        self._sig = inspect.signature(fn)
        unknown = set(self.static_argnames) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{fn.__name__} has no arguments {unknown}")
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._warm = set()
        self.misses = self.captures = self.replays = 0

    def stats(self) -> dict:
        return {"misses": self.misses, "captures": self.captures,
                "replays": self.replays, "graphs": len(self._graphs)}

    def clear(self) -> None:
        """Drop every graph (their memory goes back to the pool) and
        forget the shapes warmed up: the next call of a key is a first
        call again."""
        with _LOCK:
            self._graphs.clear()
            self._warm.clear()

    def __call__(self, *args, **kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = dict(bound.arguments)
        dynamic = {k: v for k, v in arguments.items()
                   if k not in self.static_argnames}
        leaves = list(tensors(dynamic))
        devices = {t.device for t in leaves}
        if not any(d.type == self.graph_cls.device_type for d in devices):
            return self.fn(**arguments)
        if len(devices) != 1:
            raise ValueError(f"{self.__name__}: a captured frame takes its "
                             f"tensors on one device, got {devices}")
        device = leaves[0].device
        static = tuple((k, arguments[k]) for k in self.static_argnames)
        key = (static, _signature(dynamic, True))
        with _LOCK:
            entry = self._graphs.get(key)
            if entry is None:
                self.misses += 1
                entry = self._capture(arguments, dynamic, leaves, device,
                                      (static, _signature(dynamic, False)))
                self._graphs[key] = entry
                self.captures += 1
                while len(self._graphs) > MAX_GRAPHS:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
            return self._replay(entry, leaves, device)

    def _capture(self, arguments, dynamic, leaves, device, shapes) -> _Entry:
        static_in = _rebuilt(dynamic, torch.empty_like)
        inputs = list(tensors(static_in))
        for s, t in zip(inputs, leaves):
            s.copy_(t)
        versions = [s._version for s in inputs]
        graph = self.graph_cls(device)
        call = {**arguments, **static_in}
        before = read_counts()
        try:
            if shapes not in self._warm:
                graph.warm_up(lambda: self.fn(**call))
                set_counts(before)
            out = graph.capture(lambda: self.fn(**call))
            counts = _count_delta(read_counts(), before)
        finally:
            set_counts(before)
        self._warm.add(shapes)
        if [s._version for s in inputs] != versions:
            raise RuntimeError(f"{self.__name__} writes into its inputs; a "
                               "captured frame must return new tensors")
        passed = {id(s): i for i, s in enumerate(inputs)}
        return _Entry(graph, inputs, out, passed, counts)

    def _replay(self, entry: _Entry, leaves, device):
        cuda = device.type == "cuda"
        if cuda and device.index in _LAST:
            torch.cuda.current_stream(device).wait_event(_LAST[device.index])
        for s, t in zip(entry.inputs, leaves):
            s.copy_(t)
        entry.graph.replay()

        def out(t):
            i = entry.passed.get(id(t))
            return t.clone() if i is None else leaves[i]

        result = _rebuilt(entry.out, out)
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            _LAST[device.index] = done
        _add_counts(entry.counts)
        self.replays += 1
        return result
