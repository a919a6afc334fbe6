"""The program's own spans and device marks, read over traced episodes
for the per-layer readers ``rebuild_frame_ms``, ``far_apply_frame_ms``,
``substep_frame_ms``, ``replay_host_ms`` and ``idle_in_program_ms``.

The tracer is the program's (``softbody_tpu_torch.utils.profiling``):
host spans (``backend.*``, ``compiled.*``) and, inside a captured frame,
device marks (``rebuild``, ``far_apply``, ``substep``, ``end``) that the
graph stamps with the card's clock.  Each reading runs the cell's
episodes from its start state with tracing on, each ending with one read
of the far-field stats; the first episode captures the traced graphs
(tracing is part of a captured frame's key).  Measured episodes queue
each frame alone behind a sleep of the card, as
``Loop.device_episode_ms`` times each frame.

- The split (:func:`_marks`, in the run's own process, whose card mode
  ``device_episode_ms`` shares: the card can run a process's frames
  7–10% slower): each frame's device ms from each mark to the next, by
  label, over one measured episode.
- The host (:func:`_host`, in a fresh process, :func:`in_own_process`):
  once ``torch.profiler`` has traced the card in a process, each launch
  of a captured graph there costs about ten times the host time it did
  before, and the run's earlier readers have profiled.  There, before
  any profiler: ``replay_host_ms``, each measured frame's host ms in
  ``compiled.call`` less ``compiled.capture`` (the call's own cost, not
  a wait for the frame before it), median over ``HOST_EPISODES``
  episodes' frames.  Then ``PROFILED_EPISODES`` episodes, each run back
  to back as the window runs them, under ``torch.profiler`` (after one
  warm-up episode that takes the profiler's start-up), where each
  program span is also a range on the profiler's clock: each idle gap of
  the device is put down to the innermost program span the host was in
  when the gap began, and the median episode's sum is the reading (a
  single stall of the host would otherwise make it).  A gap inside a
  captured frame's graph, between its first and last device mark (the
  stamp kernels in the trace), is left out: the graph, once launched,
  runs without the host, and the profiler's own tracing opens gaps
  between a graph's kernels that an untraced replay does not have.

Computed once a run; the run's own window replays untraced graphs.
Nothing where the program has no tracer (a checkout that predates it)
or the run is not on the card."""

from __future__ import annotations

import bisect
import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
# the program's span names begin so; its device marks' kernel is named so
PROGRAM = ("backend.", "compiled.")
STAMP = "sb_stamp_kernel"
# the sleep a frame timed alone is queued behind, at first (~0.2 s)
SLEEP_CYCLES = 400_000_000
# measured episodes whose frames give ``replay_host_ms``
HOST_EPISODES = 3
# profiled episodes, after a warm-up one: ``idle_in_program_ms`` is the
# median episode's
PROFILED_EPISODES = 3


def _tracer():
    from softbody_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "drain") else None


def readings(ctx) -> Optional[dict]:
    """The traced episodes' readings (see the module doc), or None."""
    prof = _tracer()
    if prof is None or ctx.loop.card.device.type != "cuda":
        return None

    def read():
        out = _marks(ctx.loop, ctx.sim, prof)
        out.update(in_own_process(ctx.cell.name, ctx.loop.seed) or {})
        return out
    return ctx.loop._once("program_spans", read)


def in_own_process(cell: str, seed: int) -> Optional[dict]:
    """:func:`_host` for ``cell`` at ``seed`` in a process of its own
    (``python3 -m simbench.spans CELL SEED``), or None."""
    proc = subprocess.run([sys.executable, "-m", "simbench.spans", cell,
                           str(seed)], cwd=CHECKOUT, capture_output=True,
                          text=True, timeout=1200)
    for line in proc.stderr.splitlines():
        if line.startswith("program spans:") or proc.returncode not in (0, 2):
            print(line, file=sys.stderr, flush=True)
    if proc.returncode != 0:
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def frame_ms(ctx, label: str) -> Optional[float]:
    """Device ms a frame spends from its ``label`` marks to the next mark,
    mean over the measured episode's frames."""
    got = readings(ctx)
    if got is None or not got["split"]:
        return None
    return statistics.fmean(f.get(label, 0.0) for f in got["split"])


def _episode(loop, sim) -> None:
    s = loop.start
    for _ in range(loop.frames):
        s = sim.step(s)
    sim.far_stats()
    loop.card.sync()


def _alone(loop, sim, prof):
    """One episode, each frame queued behind a ``torch.cuda._sleep``
    that outlasts the host's call (doubled, twice at most, until it
    does), as ``roofline.device_ms`` times a call: the frame's whole
    graph is queued before the card reaches it, and the call waits for
    no frame before it.  The spans and each frame's marks of the
    attempts kept, and the number of sleeps that ended too early."""
    cuda = loop.card.device.type == "cuda"
    s, spans, split, short = loop.start, [], [], 0
    for _ in range(loop.frames):
        cycles = SLEEP_CYCLES
        while True:
            loop.card.sync()
            prof.drain()
            if cuda:
                slept = torch.cuda.Event()
                torch.cuda._sleep(cycles)
                slept.record()
            out = sim.step(s)
            early = cuda and slept.query()
            loop.card.sync()
            got = prof.drain()
            if not early or cycles >= SLEEP_CYCLES * 4:
                break
            short += 1
            cycles *= 2
        s = out
        spans += got.spans
        split += [m for m in got.split().values() if m]
    sim.far_stats()
    prof.drain()
    return spans, split, short


def _marks(loop, sim, prof) -> dict:
    """The split: each measured frame's device ms by label."""
    t0 = time.perf_counter()
    loop.card.sync()
    with prof.tracing():
        _episode(loop, sim)
        prof.drain()
        t1 = time.perf_counter()
        _spans, split, short = _alone(loop, sim, prof)
    out = {"split": split}
    seconds = {"capture": t1 - t0, "measured": time.perf_counter() - t1}
    print("program spans: " + json.dumps(dict(out, seconds=seconds,
                                              short_sleeps=short)),
          file=sys.stderr, flush=True)
    return out


def _host(loop, sim, prof) -> dict:
    """The host's readings (see the module doc), in a process no
    profiler has traced: each measured frame's ``compiled.call``, each
    span's self time, then the idle gaps of ``PROFILED_EPISODES``
    profiled episodes (the median episode's, and each episode's ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    loop.card.sync()
    spans, short = [], 0
    with prof.tracing():
        _episode(loop, sim)
        prof.drain()
        for _ in range(HOST_EPISODES):
            got, _split, n = _alone(loop, sim, prof)
            spans, short = spans + got, short + n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=PROFILED_EPISODES,
                                       repeat=1)) as p:
            _episode(loop, sim)
            prof.drain()
            p.step()
            for _ in range(PROFILED_EPISODES):
                _episode(loop, sim)
                p.step()
        profiled = prof.drain()
    ops, program, stamps = trace_events(p.profiler.kineto_results.events())
    graphs = graph_ranges(stamps, [len(m) for m in profiled.marks.values()])
    idle = [idle_by_span(o, s, loop.frames, graphs)
            for o, s in by_episode(ops, program)]
    out = {"replay_host_ms": replay_host_ms(spans),
           "host_self_ms": host_self_ms(spans, HOST_EPISODES * loop.frames),
           "idle": median_episode(idle),
           "idle_episodes": [i["ms"] for i in idle]}
    print("program spans: " + json.dumps(dict(out, short_sleeps=short)),
          file=sys.stderr, flush=True)
    return out


def replay_host_ms(spans) -> Optional[float]:
    """Host ms in ``compiled.call`` less ``compiled.capture``, per frame
    (the spans' frame id), median over the frames that called one."""
    per: Dict[int, float] = {}
    for s in spans:
        if s.name == "compiled.call":
            per[s.frame] = per.get(s.frame, 0.0) + s.ms
        elif s.name == "compiled.capture":
            per[s.frame] = per.get(s.frame, 0.0) - s.ms
    return statistics.median(per.values()) if per else None


def host_self_ms(spans, frames: int) -> Dict[str, float]:
    """Each span name's self time (its duration less its children's), in
    host ms a frame."""
    children: Dict[int, float] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.ms
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = (out.get(s.name, 0.0)
                       + (s.ms - children.get(s.id, 0.0)) / frames)
    return out


def trace_events(events) -> Tuple[List[tuple], List[tuple], List[tuple]]:
    """The profiler's device operations ``(start, end)``, the program's
    spans ``(start, end, name)`` and its device marks' stamp kernels
    ``(start, end)`` (µs on the profiler's clock), from Kineto's events
    as they come (torch's own event tree takes a minute to build at the
    fold's ~700k kernels).  A span's range also shows on the device's
    row; it is no operation."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, stamps = [], [], []
    for e in events:
        name = e.name()
        program = name.startswith(PROGRAM)
        on_device = e.device_type() == cuda
        if on_device and not program:
            ops.append(_range_us(e))
            if STAMP in name:
                stamps.append(ops[-1])
        elif not on_device and program:
            spans.append(_range_us(e) + (name,))
    return ops, spans, stamps


def by_episode(ops, spans, end: str = "backend.far_stats") -> List[tuple]:
    """``ops`` and ``spans`` (each sorted by start) cut into episodes
    ``(ops, spans)``, each ending where its ``end`` span (an episode's
    one read of the far-field stats) ends."""
    ops, spans = sorted(ops), sorted(spans)
    o_starts = [o[0] for o in ops]
    s_starts = [s[0] for s in spans]
    out, lo = [], float("-inf")
    for hi in sorted(b for _a, b, n in spans if n == end):
        o = ops[bisect.bisect_left(o_starts, lo):
                bisect.bisect_left(o_starts, hi)]
        s = spans[bisect.bisect_left(s_starts, lo):
                  bisect.bisect_left(s_starts, hi)]
        out.append((o, s))
        lo = hi
    return out


def median_episode(idle: List[dict]) -> Optional[dict]:
    """The episode of median ``ms`` (the lower of two), or None."""
    if not idle:
        return None
    return sorted(idle, key=lambda i: i["ms"])[(len(idle) - 1) // 2]


def _range_us(e) -> tuple:
    return e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3


def graph_ranges(stamps, per_frame: List[int]) -> List[tuple]:
    """Each frame's device range from its first stamp to its last, the
    stamps in order taken ``per_frame`` at a time."""
    stamps = sorted(stamps)
    out, i = [], 0
    for n in per_frame:
        if n and i + n <= len(stamps):
            out.append((stamps[i][0], stamps[i + n - 1][1]))
        i += n
    return out


def innermost(spans) -> List[tuple]:
    """Nested spans ``(start, end, name)`` cut into disjoint segments
    ``(start, end, name of the innermost span over it)``, in order: the
    innermost is the one that began last."""
    bounds = sorted({t for a, b, _n in spans for t in (a, b)})
    segs = []
    for a, b in zip(bounds, bounds[1:]):
        mid = (a + b) / 2
        over = [s for s in spans if s[0] <= mid <= s[1]]
        if over:
            segs.append((a, b, max(over, key=lambda s: (s[0], -s[1]))[2]))
    return segs


def _within(ranges, starts, a, b) -> bool:
    i = bisect.bisect_right(starts, a) - 1
    return i >= 0 and b <= ranges[i][1]


def idle_by_span(ops, spans, frames: int, graphs=()) -> dict:
    """The device's idle gaps between ``ops`` whose start lies inside a
    program span and which lie inside none of the ``graphs`` ranges,
    each put down to the innermost span there: ``{"ms": summed ms over
    frames, "by_span": {name: ms over frames}}``."""
    ops = sorted(ops)
    segs = innermost(spans)
    starts = [s[0] for s in segs]
    graphs = sorted(graphs)
    g_starts = [g[0] for g in graphs]
    by: Dict[str, float] = {}
    if ops:
        hi = ops[0][1]
        for a, b in ops[1:]:
            if a > hi and not _within(graphs, g_starts, hi, a):
                i = bisect.bisect_right(starts, hi) - 1
                if i >= 0 and hi <= segs[i][1]:
                    name = segs[i][2]
                    by[name] = by.get(name, 0.0) + (a - hi) / 1e3 / frames
            hi = max(hi, b)
    return {"ms": sum(by.values()), "by_span": by}


def main(argv=None) -> int:
    """``python3 -m simbench.spans CELL SEED``: the cell's start state
    made as a run makes it, then :func:`_host`; one JSON line.  Exits 2
    where the program has no tracer or there is no card."""
    from simbench import harness

    cell_name, seed = (argv if argv is not None else sys.argv[1:])
    prof = _tracer()
    if prof is None or not torch.cuda.is_available():
        return 2
    cell = harness.Cell(cell_name)
    card = harness.Card()
    sim = cell.config.Sim(int(seed), card.device)
    loop = cell.loop.Loop(sim, cell.mix, int(seed), card)
    loop.setup()
    print(json.dumps(_host(loop, sim, prof)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
