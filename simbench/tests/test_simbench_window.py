"""The window's arithmetic: a rate over all the work and the whole
window, a 95th percentile over every frame, and each episode's outcome
read only once the next episode is queued."""

import statistics
import time

import torch

from simbench import harness

from .conftest import HostCard

EPISODES = harness.load_module("loops", "episodes.py")


class _Sim:
    """A stand-in for a configuration: frames that take known host time,
    and a log of what the loop asks for."""

    substeps_per_frame = 64

    def __init__(self):
        self.initial = torch.zeros(3)
        self.calls = 0
        self.log = []

    def step(self, s):
        self.calls += 1
        self.log.append("step")
        time.sleep(0.002 if self.calls % 7 else 0.01)
        return s + 1

    def far_stats(self):
        return {"far_rebuilds": 8, "far_pairs": 0, "far_overflow": 0}

    def outcome(self, s):
        return torch.tensor([0, int(not torch.isfinite(s).all())],
                            dtype=torch.int32)


class _Late(HostCard):
    """Logs when an episode's outcome is read."""

    def __init__(self, sim):
        self.sim = sim

    def to_host(self, t):
        sim = self.sim

        class Pending:
            def read(self):
                sim.log.append("read")
                return t.tolist()
        return Pending()


def _loop(sim, frames, seed=1, card=None):
    return EPISODES.Loop(sim, {"from": "initial", "frames": frames}, seed,
                         card or HostCard())


def test_rate_is_all_substeps_over_the_whole_window():
    sim = _Sim()
    loop = _loop(sim, 3)
    loop.setup()
    w = loop.window(0.2, {})
    assert w.substeps == w.episodes * 3 * 64
    assert len(w.frame_ms) == w.episodes * 3
    assert w.seconds >= 0.2
    e2e = w.end_to_end(setup_s=1.0)
    assert e2e["substeps_per_s"] == w.substeps / w.seconds
    assert e2e["setup_s"] == 1.0
    assert e2e["frame_ms_p95"] == EPISODES.p95(w.frame_ms)
    # every frame's time is inside the window, and the frames cover it
    assert sum(w.frame_ms) <= w.seconds * 1e3 + 1e-6
    assert sum(w.frame_ms) >= 0.9 * w.seconds * 1e3
    assert w.attempted == w.episodes and w.failed == 0


def test_an_episode_is_read_after_the_next_is_queued():
    sim = _Sim()
    loop = _loop(sim, 2, card=_Late(sim))
    loop.setup()
    sim.log.clear()
    w = loop.window(0.05, {})
    assert w.episodes >= 2
    # step step | step step read | step step read | ... | read
    assert sim.log[:2] == ["step", "step"]
    assert sim.log.count("read") == w.episodes
    for e in range(1, w.episodes):
        chunk = sim.log[3 * e - 1: 3 * e + 2]
        assert chunk == ["step", "step", "read"], sim.log
    assert sim.log[-1] == "read"


def test_a_failed_episode_is_counted():
    sim = _Sim()
    sim.initial = torch.tensor([float("nan")])
    loop = _loop(sim, 1)
    loop.setup()
    w = loop.window(0.02, {})
    assert w.failed == w.episodes >= 1


def test_p95_over_every_sample():
    vals = [float(v) for v in range(1, 101)]
    assert EPISODES.p95(vals) == statistics.quantiles(
        vals, n=100, method="inclusive")[94]
    assert abs(EPISODES.p95(vals) - 95.05) < 1e-9
    assert EPISODES.p95([5.0]) == 5.0
    vals = [1.0] * 99 + [1000.0]
    assert 1.0 < EPISODES.p95(vals + [1000.0] * 9) <= 1000.0


def test_episode_samples_come_from_the_seed():
    a = _loop(_Sim(), 10, seed=9).sample(3, 2)
    assert a == _loop(_Sim(), 10, seed=9).sample(3, 2)
    assert sum(len(v) for v in a.values()) == 3
    assert any(9 in v for v in a.values())
