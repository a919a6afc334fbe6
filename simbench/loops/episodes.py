"""A closed loop of episodes, the loop of the mixes whose ``"loop"`` is
``"episodes"``.

Each episode starts from the same state (``"from"``: ``"initial"``, the
seed's scene, or ``"checkpoint"``, the state after ``checkpoint_frame``
frames, made in set-up) and runs ``frames`` frames through ``Sim.step``.
A CUDA event is recorded on the stream at every frame boundary and read
after the window.  An episode's outcome (the far list's overflow and
whether its state is finite) is copied to the host behind it and read
once the next episode is queued, so nothing inside the window waits for
the device while it has work.  The window runs from a synchronize to
the synchronize after the last episode that started before ``seconds``
had passed.

End-to-end metrics: ``substeps_per_s``, every substep completed over
the whole window, and ``frame_ms_p95``, the 95th percentile of every
frame's time."""

from __future__ import annotations

import dataclasses
import random
import statistics
import time
from typing import Dict, List, Optional

import torch

from simbench import check


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


@dataclasses.dataclass
class Window:
    """What one window did: episodes started and failed, substeps
    completed, its length, every frame's time, the program states kept
    for the check (``kept[(episode, frame)] = (before, after)``), the far
    list's largest overflow and the last episode's final state."""

    episodes: int = 0
    failed: int = 0
    substeps: int = 0
    seconds: float = 0.0
    frame_ms: List[float] = dataclasses.field(default_factory=list)
    kept: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    overflow: int = 0
    last_state: Optional[object] = None

    @property
    def attempted(self) -> int:
        return self.episodes

    def end_to_end(self, setup_s: float) -> Dict[str, float]:
        return {"setup_s": setup_s,
                "substeps_per_s": self.substeps / self.seconds,
                "frame_ms_p95": p95(self.frame_ms)}

    def tally(self, outcome: List[int]) -> None:
        """One episode's outcome ``[far overflow, not finite]``."""
        over, bad = outcome
        self.overflow = max(self.overflow, over)
        self.failed += int(over > 0 or bad > 0)


class Loop:
    """A closed loop of episodes over ``sim`` on ``card`` (see the
    module doc)."""

    def __init__(self, sim, mix: dict, seed: int, card) -> None:
        self.sim = sim
        self.mix = mix
        self.frames = int(mix["frames"])
        self.seed = seed
        self.card = card
        self.before_start = None    # the state one frame before the start
        self.result: Optional[Window] = None
        self._cache: Dict[str, object] = {}

    def setup(self) -> None:
        """The start state (the checkpoint made here), then one whole
        episode, which captures every frame function the window
        replays."""
        s = self.sim.initial
        if self.mix["from"] == "checkpoint":
            for _ in range(int(self.mix["checkpoint_frame"])):
                self.before_start, s = s, self.sim.step(s)
        elif self.mix["from"] != "initial":
            raise ValueError(f"episodes from {self.mix['from']!r}")
        self.start = s
        self.episode()
        self.sim.far_stats()
        self.card.sync()

    def episode(self, keep=None, marks=None):
        s = self.start
        for k in range(self.frames):
            before, s = s, self.sim.step(s)
            if marks is not None:
                marks.append(self.card.mark())
            if keep is not None and k in keep:
                keep[k] = (before, s)
        return s

    def sample(self, n: int, episodes: int) -> Dict[int, List[int]]:
        """The frames kept for the check, drawn from the seed: ``n``
        (episode, frame) pairs among the first ``episodes`` episodes,
        the episode's last frame among them."""
        rng = random.Random(self.seed)
        pairs = {(rng.randrange(episodes), self.frames - 1)}
        while len(pairs) < min(n, episodes * self.frames):
            pairs.add((rng.randrange(episodes), rng.randrange(self.frames)))
        out: Dict[int, List[int]] = {}
        for e, k in sorted(pairs):
            out.setdefault(e, []).append(k)
        return out

    def window(self, seconds: float, sample: Dict[int, List[int]]) -> Window:
        w = Window()
        sub = self.sim.substeps_per_frame
        self.card.sync()
        marks = [self.card.mark()]
        t0 = time.perf_counter()
        pending = None
        while True:
            keep = dict.fromkeys(sample.get(w.episodes, ()))
            s = self.episode(keep=keep, marks=marks)
            for k, pair in keep.items():
                w.kept[(w.episodes, k)] = pair
            outcome = self.card.to_host(self.sim.outcome(s))
            if pending is not None:
                w.tally(pending.read())
            pending = outcome
            w.episodes += 1
            w.last_state = s
            if time.perf_counter() - t0 >= seconds:
                break
        self.card.sync()
        w.seconds = time.perf_counter() - t0
        w.tally(pending.read())
        w.substeps = w.episodes * self.frames * sub
        w.frame_ms = [self.card.ms(a, b) for a, b in zip(marks, marks[1:])]
        self.result = w
        return w

    def check_inputs(self) -> check.Inputs:
        """The start and the far list's overflow, and the kept frames
        (with the checkpoint's last frame) as the reference's worlds."""
        sim, w = self.sim, self.result
        numbers = {"start_diff": float(check.start_diff(
            sim.world(sim.initial), sim.ref_world)),
            "far_overflow": float(w.overflow)}
        pairs = [(sim.world(a), sim.world(b))
                 for _key, (a, b) in sorted(w.kept.items())]
        if self.before_start is not None:
            pairs.append((sim.world(self.before_start),
                          sim.world(self.start)))
        return check.Inputs(numbers, pairs, sim.ref_consts, sim.spacing,
                            getattr(sim, "near", None))

    def release(self) -> None:
        """Drops the program states the loop holds."""
        if self.result is not None:
            self.result.kept.clear()
            self.result.last_state = None
        self._cache.clear()
        self.start = self.before_start = None

    # what the per-layer readers read, each computed once

    def _once(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def device_episode_ms(self) -> float:
        """One episode's device ms: each frame, from the state the
        episode gives it, queued behind ``torch.cuda._sleep`` and timed
        alone (``roofline.device_ms``), summed."""
        from simbench import roofline

        def run():
            states = [self.start]
            for _ in range(self.frames - 1):
                states.append(self.sim.step(states[-1]))
            return sum(roofline.device_ms(lambda s=s: self.sim.step(s), 1)
                       for s in states)
        return self._once("device_episode", run)

    def window_episode_ms(self) -> float:
        return self.result.seconds * 1e3 / self.result.episodes

    def device_window(self) -> Dict[str, float]:
        """``busy_s``: the window's episodes times one episode's device
        time, each frame timed alone behind ``_sleep``; ``window_s``: the
        window.  The profiler's own busy time is not used: it stretches
        short kernels."""
        return {"busy_s": self.result.episodes
                * self.device_episode_ms() / 1e3,
                "window_s": self.result.seconds}

    def probes(self) -> dict:
        return self._once("probes", lambda: self.sim.probes(
            self.result.last_state))

    def far_per_frame(self) -> List[dict]:
        """One episode replayed from its start with the far-field
        counters read after every frame."""
        def run():
            s, out = self.start, []
            self.sim.far_stats()
            for _ in range(self.frames):
                s = self.sim.step(s)
                out.append(self.sim.far_stats())
            return out
        return self._once("far_per_frame", run)

    def profile(self) -> dict:
        """One episode under ``torch.profiler`` (host and device
        activity), each frame in a host span of its own: the kernels'
        count over the episode's substeps, the device operations that
        took most time and the longest idle gaps, each named by the span
        the host was in when it began."""
        return self._once("profile", self._profile)

    def _profile(self) -> dict:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.card.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = self.start
            for k in range(self.frames):
                with record_function(f"simbench.frame{k}"):
                    s = self.sim.step(s)
            with record_function("simbench.sync"):
                self.card.sync()
        events = prof.events()
        ops = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("simbench.")]
        spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
        gaps = []
        hi = spans[0][1]
        for a, b in spans[1:]:
            if a > hi:
                gaps.append((hi, a))
            hi = max(hi, b)
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("simbench.")]

        def host_at(t):
            return next((n for a, b, n in host if a <= t <= b),
                        "between frames")

        by_name: Dict[str, float] = {}
        for e in ops:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {
            "kernels": sum(1 for e in ops
                           if not e.name.startswith(("Memcpy", "Memset"))),
            "substeps": self.frames * self.sim.substeps_per_frame,
            "device_ops": [[n[:120], us / 1e6] for n, us in top],
            "idle_gaps": [[host_at(a), (b - a) / 1e6] for a, b in gaps],
        }
