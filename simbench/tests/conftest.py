"""CPU tests of the benchmark: small sizes, torch on two threads, and a
stand-in for the card."""

import json
import pathlib
import time

import pytest
import torch

from simbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {"tearing_cloth_1m": {"n_particles": 32 * 32},
         "self_colliding_cloth_100k": {"n_particles": 600}}


class Ready:
    """A value already on the host."""

    def __init__(self, values) -> None:
        self.values = values

    def read(self):
        return self.values


class HostCard:
    """The harness's card on the CPU: host time for frame boundaries,
    nothing to synchronize, no device memory."""

    device = torch.device("cpu")

    def mark(self):
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return (b - a) * 1e3

    def sync(self) -> None:
        pass

    def to_host(self, t):
        return Ready(t.tolist())

    def start(self, err) -> None:
        pass

    def info(self) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}

    def free(self) -> None:
        pass


def on_host(cell, fault=None, frames=None):
    """``cell`` made to run on the CPU: its configuration at the small
    sizes above (its frames broken by ``fault(sim, state, out)`` when
    given), ``frames`` frames an episode, and the loop's readings that
    only the card gives (device times, the profiled episode) empty."""
    base = cell.config.Sim

    class Sim(base):
        PARAMS = {**base.PARAMS, **SMALL[cell.spec["config"]]}

        def step(self, state):
            out = base.step(self, state)
            return out if fault is None else fault(self, state, out)

    loop = cell.loop.Loop

    class Loop(loop):
        def device_window(self):
            return {"busy_s": 0.0, "window_s": self.result.seconds}

        def profile(self):
            return {"kernels": 0, "substeps": 1, "device_ops": [],
                    "idle_gaps": []}

    cell.config.Sim = Sim
    cell.loop.Loop = Loop
    if frames is not None:
        cell.mix = dict(cell.mix, frames=min(frames, cell.mix["frames"]))
    return cell


class HostCell(harness.Cell):
    """A cell resolved by name, made to run on the CPU (``on_host``)."""

    fault = None
    frames = None

    def __init__(self, name, bench=None):
        super().__init__(name, bench)
        on_host(self, type(self).fault, type(self).frames)


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
