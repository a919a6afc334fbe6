"""Compiled frames: the port's counterpart of the JAX package's
``jax.jit(fn, static_argnames=..., donate_argnames=...)`` over a frame
function (``ops/step.frame_jit``, ``ops/stencil.lattice_frame_jit``, ...).

A :class:`Compiled` wraps a frame function.  On CUDA tensors each call
runs a CUDA graph of the function, captured once per key and replayed
after that; on CPU tensors it runs the function itself (the caller asked
for the CPU, where the plain torch versions run: no graph exists there).

**The key** holds what ``jax.jit`` holds static, and no value that a
frame computes with:

- the function (one cache per :class:`Compiled`) and its static
  arguments (``static_argnames``: ``cfg``, ``spec``, ``ffspec``,
  ``n_sub``), by value;
- the tree structure of the other arguments, and every tensor's shape,
  dtype, strides (but those of dimensions of size 1, which lay out
  nothing) and device (a far list's capacity is its tensors' shape);
- the arguments left at their defaults, by value (JAX traces only what
  is passed);
- the host decisions of the frame (``decide``: which kernel instance
  the constants allow, ``stencil.frame_decisions``), computed from the
  host values before they are lifted;
- whether the tracer is on (``utils/profiling.py``): a graph captured
  with tracing on holds a stamp node for each of the frame's device
  marks, written into a buffer kept beside the graph and cloned into the
  tracer's log after each replay; one captured with tracing off holds
  none.

**Lifted, as ``jax.jit`` traces them**: every float and bool leaf of the
passed arguments (each field of ``PhysicsConstants`` and ``UserInput``)
goes into one small float32 buffer on the frame's device, and the
function receives a 0-d view of it in the leaf's place; a CPU tensor of
a frame on the card (the edge constants) is received as a tensor on the
device.  Both are copied in before each replay, with the state, from
pinned host memory (no synchronisation).  So a mouse drag, a keyboard
force or a slider replays one graph: only a constant that changes a host
decision (one that makes the penetration clip non-finite) is another
key.

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
host (``K1_LAUNCHES`` ... ``K8B_LAUNCHES``), and a replay runs no Python.
A capture records what the wrappers counted while it was captured and
every replay adds that again; what the warm-up and the capture counted
is taken back (the warm-up's result is discarded, the capture launches
nothing).

**Conditional bodies** (:func:`device_if`, :func:`device_switch`): the
counterpart of ``lax.cond`` / ``lax.switch`` in a frame.  A body runs
where its predicate (a 0-d tensor on the device) holds: on the CPU the
predicate is read and the body run; on the card, run eagerly, likewise,
each read counted in :data:`HOST_READS`; under capture the body is
recorded into a CUDA-graph IF node (built by ``csrc/graph_cond.cu``:
the card's torch has no conditional-node API), which the device
evaluates at replay with no host read.  A body returns nothing: it
writes its results into tensors allocated before it (torch's own
``if_else_node`` pattern).  Its temporaries come from a second pool
per device, drawn on by the capturing thread only while a body is
recorded; bodies do not nest.  The warm-up runs every body, whatever
its predicate (kernels load at their first launch, as
``ControlFlowOpWarmupDispatchMode`` warms both sides of a cond).  The
launches in a body vary from replay to replay: each body adds one to a
device counter (one slot per distinct set of launches), and
:func:`sync_counts` folds those counters into the host's, outside the
frames.

**No fallback**: on CUDA tensors a capture or a replay that fails
raises.  A host synchronisation inside the function (``.item()``,
``.tolist()`` of a device tensor, ``nonzero``, a blocking copy) fails
the capture.

**Spans** (with tracing on): ``compiled.call``, and in it
``compiled.key`` (binding, key, decisions, lifted leaves),
``compiled.lock`` (the lock, and the wait for the last call's event
queued on the stream), ``compiled.capture`` (a miss only),
``compiled.fill`` (the copies in, pinned), ``compiled.replay`` and
``compiled.out`` (the clones, the event, the counters).

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
import contextlib
import copy
import ctypes
import dataclasses
import functools
import importlib
import inspect
import struct
import threading
import weakref
from typing import Callable, Dict, Sequence

import torch

from ..utils import profiling
from ..utils.profiling import span

# the kernel wrappers' launch counters and the far apply's routes:
# (module, name), an int or a dict of ints (K1's per instance)
LAUNCH_COUNTERS = (
    (".cuda.fused_substep2", "K1_LAUNCHES"),
    (".cuda.fused_substep2", "K1_INSTANCE_LAUNCHES"),
    (".cuda.band_detect", "K2_LAUNCHES"),
    (".cuda.collide_stencil", "K3_LAUNCHES"),
    (".cuda.fused_substep", "K4_LAUNCHES"),
    (".cuda.recmirror", "K5_LAUNCHES"),
    (".cuda.recmirror", "K6_LAUNCHES"),
    (".cuda.recmirror", "K7_LAUNCHES"),
    (".cuda.far_apply", "K8A_LAUNCHES"),
    (".cuda.far_apply", "K8B_LAUNCHES"),
    (".farfield4", "APPLY_ROUTES"),
)

# graphs kept per compiled function (JAX keeps every compilation; a
# graph holds its static inputs and outputs, a state's size each)
MAX_GRAPHS = 32

# one call at a time, process-wide; per CUDA device the live graphs (they
# share one memory pool) and the event after the last call's copies; the
# graphs of failed captures and the pools they left unusable
_LOCK = threading.RLock()
_POOLS: Dict[int, "weakref.WeakSet"] = {}
_POISONED: set = set()
_LAST: Dict[int, torch.cuda.Event] = {}
_ABANDONED: list = []
# per CUDA device the stream frames are captured on, and the stream and
# pool that conditional bodies are recorded with (_streams); the device
# counters of the live graphs' bodies
_STREAMS: Dict[int, tuple] = {}
_COND_COUNTS: list = []
# per thread: ``warming`` (a warm-up runs every body), ``cond`` (the
# device counters of the capture in progress), ``in_body``, ``decided``
# (the host decisions of the Compiled call in progress)
_TLS = threading.local()

# the host reads that decide a frame's branches on the card (each a
# synchronisation with the device): device_if's and device_switch's eager
# reads of CUDA predicates; a captured frame makes none
HOST_READS = 0


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


def _scaled(delta: dict, n: int) -> dict:
    return {k: ({i: c * n for i, c in d.items()} if isinstance(d, dict)
                else d * n) for k, d in delta.items()}


def host_read(t: torch.Tensor) -> list:
    """``t.tolist()``; a read of a CUDA tensor is counted in
    :data:`HOST_READS`."""
    global HOST_READS
    if t.device.type == "cuda":
        HOST_READS += 1
    return t.tolist()


class _CondCounts:
    """The launches of one capture's conditional bodies, counted on the
    device: slot ``i`` of ``counter`` counts the replays in which a body
    with the launches ``deltas[i]`` ran (bodies with equal launches share
    a slot); :meth:`fold` adds what is new since the last fold to the
    host counters."""

    SLOTS = 64

    def __init__(self, device: torch.device) -> None:
        self.counter = torch.zeros(self.SLOTS, dtype=torch.int64,
                                   device=device)
        self.deltas: list = []
        self.folded: list = []

    def slot(self, delta: dict) -> torch.Tensor:
        if delta not in self.deltas:
            if len(self.deltas) == self.SLOTS:
                raise RuntimeError("too many distinct conditional bodies")
            self.deltas.append(delta)
            self.folded.append(0)
        return self.counter[self.deltas.index(delta)]

    def fold(self) -> None:
        if not self.deltas:
            return
        # every stream's replays done (the engine's worker replays on its
        # own)
        torch.cuda.synchronize(self.counter.device)
        for i, v in enumerate(self.counter[:len(self.deltas)].tolist()):
            if v != self.folded[i]:
                _add_counts(_scaled(self.deltas[i], v - self.folded[i]))
                self.folded[i] = v


def sync_counts() -> None:
    """Fold the device counters of the captured conditional bodies into
    the host counters (one read per graph that has them, after the
    device finishes what was queued on every stream).  Call it before
    reading or zeroing a launch counter after captured frames with
    conditional bodies."""
    with _LOCK:
        for cc in _COND_COUNTS:
            cc.fold()


def _retire(entry) -> None:
    """Fold a dropped graph's device counters and forget them."""
    cc = entry.cond
    if cc is not None:
        cc.fold()
        _COND_COUNTS.remove(cc)


def decided():
    """The host decisions of the :class:`Compiled` call running on this
    thread (its ``decide`` of the host arguments, part of its key), or
    None outside such a call: a frame then decides from its arguments'
    host values itself."""
    return getattr(_TLS, "decided", None)


def _capturing(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def device_if(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body`` where the 0-d tensor ``pred`` holds (``lax.cond``
    with a no-op branch).  ``body`` returns nothing: it writes into
    tensors allocated before the call.  On the CPU ``pred`` is read;
    on the card, eagerly, too (counted in :data:`HOST_READS`); in a
    warm-up ``body`` always runs; under a :class:`Compiled` capture it
    is recorded into a CUDA-graph IF node that the device evaluates at
    each replay."""
    if _capturing(pred):
        _capture_if(pred, body)
    elif getattr(_TLS, "warming", False):
        body()
    elif host_read(pred.reshape(()).to(torch.bool)):
        body()


def device_switch(index: torch.Tensor, branches) -> None:
    """Run ``branches[index]`` (``lax.switch``; ``index`` a 0-d integer
    tensor in range): one read of ``index`` eagerly, one IF node per
    branch on ``index == i`` under capture, every branch in a
    warm-up."""
    if _capturing(index):
        for i, branch in enumerate(branches):
            _capture_if(index == i, branch)
    elif getattr(_TLS, "warming", False):
        for branch in branches:
            branch()
    else:
        branches[int(host_read(index.reshape(())))]()


def _own_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A CUDA stream no other stream object shares: ``torch.cuda.Stream``
    hands out streams from a pool of 32 per device, so two of them can
    be one stream, and a body's capture cannot begin on the stream that
    captures its frame."""
    from .cuda import _lib

    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _lib.check(_lib.library().sb_stream_create(ctypes.byref(ptr)),
                   "a capture stream")
    return torch.cuda.ExternalStream(ptr.value, device=device)


def _streams(device: torch.device):
    """The device's capture stream (warm-ups and captures), body stream
    and body pool."""
    if device.index not in _STREAMS:
        _STREAMS[device.index] = (_own_stream(device), _own_stream(device),
                                  torch.cuda.MemPool())
    return _STREAMS[device.index]


def _capture_if(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Record ``body`` into an IF node of the graph captured on the
    current stream (``sb_cond_begin`` / ``sb_cond_end``): the body is
    captured on the device's body stream, its temporaries drawn from the
    body pool by this thread; the launches it counts on the host are
    taken back and counted on the device instead."""
    from .cuda import _lib

    cond = getattr(_TLS, "cond", None)
    if cond is None:
        raise RuntimeError("device_if under a capture records its body "
                           "only inside a Compiled frame's capture")
    if getattr(_TLS, "in_body", False):
        raise RuntimeError("device_if bodies do not nest")
    device = pred.device
    flag = (pred.reshape(()) != 0).to(torch.uint8)
    stream = torch.cuda.current_stream(device)
    _side, child, mempool = _streams(device)
    pool = mempool.id
    lib = _lib.library()
    before = read_counts()
    _lib.check(lib.sb_cond_begin(stream.cuda_stream, flag.data_ptr(),
                                 child.cuda_stream), "device_if: IF node")
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
    _TLS.in_body = True
    try:
        with torch.cuda.stream(child):
            body()
            delta = _count_delta(read_counts(), before)
            if delta:
                cond.slot(delta).add_(1)
    finally:
        _TLS.in_body = False
        torch._C._cuda_endAllocateToPool(device.index, pool)
        torch._C._cuda_releasePool(device.index, pool)
        err = lib.sb_cond_end(child.cuda_stream)
    _lib.check(err, "device_if: end of the body")
    set_counts(before)


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


def _is_scalar(obj) -> bool:
    return isinstance(obj, (bool, float))


def _lifted(obj, on_tensor: Callable, on_scalar: Callable):
    """``obj`` with each tensor ``t`` replaced by ``on_tensor(t)`` and
    each float or bool leaf ``x`` by ``on_scalar(x)``."""
    if isinstance(obj, torch.Tensor):
        return on_tensor(obj)
    if _is_scalar(obj):
        return on_scalar(obj)
    if _is_record(obj):
        new = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(new, f.name, _lifted(getattr(obj, f.name),
                                                    on_tensor, on_scalar))
        return new
    if isinstance(obj, tuple) and hasattr(type(obj), "_fields"):
        return type(obj)(*(_lifted(x, on_tensor, on_scalar) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_lifted(x, on_tensor, on_scalar) for x in obj)
    if isinstance(obj, dict):
        return {k: _lifted(v, on_tensor, on_scalar) for k, v in obj.items()}
    return obj


def _scalars(obj) -> list:
    """The float and bool leaves of ``obj``, in :func:`_lifted`'s order,
    as floats."""
    out = []
    _lifted(obj, lambda t: t, lambda x: out.append(float(x)))
    return out


def _signature(obj, values: bool):
    """What a capture bakes in besides the tensors' contents: the tree's
    structure, each tensor's layout and every other leaf by value, but
    floats and bools (lifted) by their type only, unless ``values``
    (floats by their bits, so -0.0 and NaN key as themselves)."""
    if isinstance(obj, torch.Tensor):
        # a dimension of size 1 has no layout: its stride is not keyed
        stride = tuple(st if n != 1 else 0
                       for st, n in zip(obj.stride(), obj.shape))
        return ("tensor", tuple(obj.shape), obj.dtype, stride, obj.device)
    if _is_record(obj):
        return (type(obj),) + tuple(
            (f.name, _signature(getattr(obj, f.name), values))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_signature(x, values) for x in obj)
    if isinstance(obj, dict):
        return (dict,) + tuple((k, _signature(v, values))
                               for k, v in obj.items())
    if _is_scalar(obj) and not values:
        return type(obj)
    if isinstance(obj, float):
        return (float, struct.pack("<d", obj))
    return (type(obj), obj)


def _shared_pool(device: torch.device):
    """The memory pool of a live graph on ``device`` (all of them share
    one), or a new one where none lives: torch (2.11) refuses a capture
    into a pool whose graphs all died, and into one that a failed
    capture left (:data:`_POISONED`)."""
    for g in _POOLS.get(device.index, ()):
        if g.pool not in _POISONED:
            return g.pool
    return torch.cuda.graph_pool_handle()


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the cache's three calls: a
    warm-up and the capture on a side stream, replays on the current
    stream."""

    device_type = "cuda"

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.pool = _shared_pool(device)
        self.graph = torch.cuda.CUDAGraph()
        self.side = _streams(device)[0]

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
            _POOLS.setdefault(self.device.index, weakref.WeakSet()).add(self)
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
            _POISONED.add(self.pool)
            _ABANDONED.append(self.graph)

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class _Entry:
    graph: object
    inputs: list            # static input tensors, in argument order
    scalars: object         # float32 [n] of the lifted leaves, or None
    out: object             # the function's output on the static inputs
    passed: dict            # id(static input) -> its index (pass-through)
    counts: dict            # launch counts one replay stands for
    decided: object         # the host decisions the graph was captured under
    cond: object = None     # _CondCounts of its conditional bodies
    marks: object = None    # profiling.Marks of a graph captured traced


def _fill(inputs: list, srcs: list, scalars, values: list,
          cuda: bool) -> None:
    """Copy the call's tensors and lifted leaves into a graph's static
    inputs.  A host tensor or value bound for the card goes through pinned
    memory without blocking (a pageable copy would wait for the stream)."""
    for s, t in zip(inputs, srcs):
        if cuda and t.device.type == "cpu":
            s.copy_(t.pin_memory(), non_blocking=True)
        else:
            s.copy_(t)
    if scalars is not None:
        host = torch.tensor(values, dtype=torch.float32)
        if cuda:
            scalars.copy_(host.pin_memory(), non_blocking=True)
        else:
            scalars.copy_(host)


class Compiled:
    """``fn`` run as captured graphs on CUDA tensors (see the module's
    docstring).  ``static_argnames``: arguments keyed by value and passed
    to ``fn`` as they are (hashable).  ``decide``: the frame's host
    decisions, a function of the bound arguments (host values) returning
    a hashable, keyed and handed to ``fn`` through :func:`decided`.
    ``graph_cls``: the graph type (:class:`CudaGraph`; its
    ``device_type`` names the tensors it captures, a call on any other
    device runs ``fn``).  Keeps at most ``MAX_GRAPHS`` graphs; counts
    ``misses``, ``captures``, ``replays``."""

    def __init__(self, fn: Callable, static_argnames: Sequence[str] = (),
                 *, decide: Callable = None, graph_cls=CudaGraph) -> None:
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.static_argnames = tuple(static_argnames)
        self.decide = decide
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
        """Drop every graph (their memory goes back to the pool; the
        device counters of their bodies are folded first) and forget
        the shapes warmed up: the next call of a key is a first call
        again."""
        with _LOCK:
            for entry in self._graphs.values():
                _retire(entry)
            self._graphs.clear()
            self._warm.clear()

    def _graph_tensor(self, t: torch.Tensor) -> bool:
        return t.device.type == self.graph_cls.device_type

    def __call__(self, *args, **kwargs):
        with span("compiled.call"):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        with span("compiled.key"):
            bound = self._sig.bind(*args, **kwargs)
            passed = set(bound.arguments)
            bound.apply_defaults()
            arguments = dict(bound.arguments)
            dynamic = {k: v for k, v in arguments.items()
                       if k not in self.static_argnames}
            leaves = [t for t in tensors(dynamic) if self._graph_tensor(t)]
            if leaves:
                device, key, shapes, traced, srcs, values, decided_now = (
                    self._key(arguments, dynamic, passed, leaves))
        if not leaves:
            return self.fn(**arguments)
        cuda = device.type == "cuda"
        with contextlib.ExitStack() as held:
            with span("compiled.lock"):
                held.enter_context(_LOCK)
                if cuda and device.index in _LAST:
                    torch.cuda.current_stream(device).wait_event(
                        _LAST[device.index])
            entry = self._graphs.get(key)
            if entry is None:
                with span("compiled.capture"):
                    self.misses += 1
                    entry = self._capture(arguments, traced, srcs, values,
                                          device, shapes, decided_now)
                    self._graphs[key] = entry
                    self.captures += 1
                    while len(self._graphs) > MAX_GRAPHS:
                        _retire(self._graphs.popitem(last=False)[1])
            else:
                self._graphs.move_to_end(key)
            return self._replay(entry, srcs, values, device)

    def _key(self, arguments, dynamic, passed, leaves):
        """The call's device, key (with whether tracing is on: a traced
        graph holds the stamp nodes), shapes, traced arguments, their
        tensors and lifted leaves, and host decisions."""
        devices = {t.device for t in leaves}
        others = {t.device for t in tensors(dynamic)
                  if not self._graph_tensor(t) and t.device.type != "cpu"}
        if len(devices) != 1 or others:
            raise ValueError(f"{self.__name__}: a captured frame takes its "
                             "tensors on one device (and host constants "
                             f"on the CPU), got {devices | others}")
        device = leaves[0].device
        static = tuple((k, arguments[k]) for k in self.static_argnames)
        # traced (lifted) as JAX traces them: the arguments passed; those
        # left at their defaults are keyed by value
        traced = {k: v for k, v in dynamic.items() if k in passed}
        fixed = {k: v for k, v in dynamic.items() if k not in passed}
        decided_now = (None if self.decide is None
                       else self.decide(arguments))
        shapes = (static, _signature(traced, False), _signature(fixed, True))
        key = shapes + (decided_now, profiling.enabled())
        return (device, key, shapes, traced, list(tensors(traced)),
                _scalars(traced), decided_now)

    def _capture(self, arguments, traced, srcs, values, device, shapes,
                 decided_now) -> _Entry:
        inputs = []     # in the order of tensors(traced), as srcs

        def static_tensor(t):
            # a host tensor of a frame on the card is lifted to the device
            s = (torch.empty_like(t) if self._graph_tensor(t) else
                 torch.empty(t.shape, dtype=t.dtype, device=device))
            inputs.append(s)
            return s

        scalars = (torch.empty(len(values), dtype=torch.float32,
                               device=device) if values else None)
        slots = iter(range(len(values)))
        static_in = _lifted(traced, static_tensor,
                            lambda _x: scalars[next(slots)])
        cuda = device.type == "cuda"
        _fill(inputs, srcs, scalars, values, cuda)
        watched = inputs + ([scalars] if scalars is not None else [])
        versions = [s._version for s in watched]
        graph = self.graph_cls(device)
        call = {**arguments, **static_in}
        cond = _CondCounts(device) if cuda else None
        marks = profiling.Marks(device) if profiling.enabled() else None
        before = read_counts()
        _TLS.decided = decided_now
        try:
            if shapes not in self._warm:
                _TLS.warming = True
                try:
                    with profiling.recording(marks):
                        graph.warm_up(lambda: self.fn(**call))
                finally:
                    _TLS.warming = False
                set_counts(before)
                if marks is not None:
                    marks.reset()
            _TLS.cond = cond
            try:
                with profiling.recording(marks):
                    out = graph.capture(lambda: self.fn(**call))
            finally:
                _TLS.cond = None
            counts = _count_delta(read_counts(), before)
        finally:
            _TLS.decided = None
            set_counts(before)
        self._warm.add(shapes)
        if [s._version for s in watched] != versions:
            raise RuntimeError(f"{self.__name__} writes into its inputs; a "
                               "captured frame must return new tensors")
        passed = {id(s): i for i, s in enumerate(inputs)}
        if cond is not None and cond.deltas:
            _COND_COUNTS.append(cond)
        else:
            cond = None
        if marks is not None:
            marks.frozen = True
        return _Entry(graph, inputs, scalars, out, passed, counts,
                      decided_now, cond, marks)

    def _replay(self, entry: _Entry, srcs, values, device):
        cuda = device.type == "cuda"
        with span("compiled.fill"):
            _fill(entry.inputs, srcs, entry.scalars, values, cuda)
        with span("compiled.replay"):
            _TLS.decided = entry.decided
            try:
                with profiling.recording(entry.marks):
                    entry.graph.replay()
            finally:
                _TLS.decided = None

        def out(t):
            i = entry.passed.get(id(t))
            return t.clone() if i is None else srcs[i]

        with span("compiled.out"):
            result = _lifted(entry.out, out, lambda x: x)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                _LAST[device.index] = done
            if entry.marks is not None:
                entry.marks.log()
            _add_counts(entry.counts)
        self.replays += 1
        return result
