"""One run of one cell: set-up, the measured window, the per-layer
readings (``--trace 1``), the check against the reference, and the
result line.

Everything a cell needs is found by name: the cell
``simbench/workloads/<cell>.json`` names its configuration
(``simbench/configs/<config>.py`` and its ``.json`` of sizes) and its
traffic mix (``simbench/traffic/<mix>.json``), whose ``"loop"`` names the
generator that drives it (``simbench/loops/<loop>.py``), and that loop's
window reports the end-to-end metrics by their names.
``BENCHMARK.json`` at the checkout's root lists the cell's metrics, and
each per-layer metric is read by ``simbench/metrics/<metric>.py``.
Adding a cell, configuration, mix, loop or metric adds files and
entries and edits none."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from simbench import check

ROOT = pathlib.Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# modules that may not be loaded once the window has closed, compared by
# their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "softbody_tpu")


def load_json(*parts) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


def load_module(*parts):
    """A module of the benchmark by its file, so that names with dots
    (``idle_share.sim``) load too; each call loads it afresh."""
    path = ROOT.joinpath(*parts)
    name = "simbench._by_name." + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell resolved by name: its file, configuration module, mix, the
    mix's loop module and the metrics ``BENCHMARK.json`` gives it."""

    def __init__(self, name: str, bench: Optional[dict] = None) -> None:
        self.name = name
        self.spec = load_json("workloads", f"{name}.json")
        self.config = load_module("configs", f"{self.spec['config']}.py")
        self.mix = load_json("traffic", f"{self.spec['traffic']}.json")
        self.loop = load_module("loops", f"{self.mix['loop']}.py")
        bench = bench if bench is not None else json.loads(
            (CHECKOUT / "BENCHMARK.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        return load_module("metrics", f"{metric}.py")


class Outcome:
    """A device tensor's values on their way to the host: copied behind
    the work queued before it, read with :meth:`read`."""

    def __init__(self, t: torch.Tensor) -> None:
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def read(self) -> list:
        self.done.synchronize()
        return self.host.tolist()


class Card:
    """The CUDA device a run measures: frame boundaries as CUDA events,
    the synchronize, copies to the host, and what the result line says
    of the device."""

    device = torch.device("cuda")

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b)

    def sync(self) -> None:
        torch.cuda.synchronize()

    def to_host(self, t: torch.Tensor) -> Outcome:
        return Outcome(t)

    def start(self, err) -> None:
        print(f"card: {card_line()}", file=err, flush=True)
        torch.cuda.reset_peak_memory_stats()

    def info(self) -> dict:
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}

    def free(self) -> None:
        torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the cell, the simulation, the loop
    (whose methods give the layer probes, the profiled episode and the
    device times) and the window."""

    def __init__(self, cell: Cell, sim, loop, window) -> None:
        self.cell, self.sim, self.loop, self.window = cell, sim, loop, window


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: Optional[float] = None, bench: Optional[dict] = None,
        card=None, out=sys.stdout, err=sys.stderr) -> int:
    """One run on ``card`` (the CUDA device unless a test gives another);
    prints the result line on ``out``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, bench)
    card = Card() if card is None else card
    card.start(err)
    sim = cell.config.Sim(seed, card.device)
    loop = cell.loop.Loop(sim, cell.mix, seed, card)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    chk = cell.spec["check"]
    window = loop.window(seconds, loop.sample(chk["frames"],
                                              chk["episodes"]))
    measured = window.end_to_end(setup_s)
    device_info = card.info()
    result: Dict[str, object] = {"correct": False,
                                 "attempted": window.attempted,
                                 "failed": window.failed}
    breakdown = None
    if trace:
        ctx = Context(cell, sim, loop, window)
        out_metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        device_info.update(loop.device_window())
        prof = loop.profile()
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
        del ctx
    else:
        out_metrics = {m["name"]: {"value": float(measured[m["name"]]),
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
    inputs = loop.check_inputs()
    loop.release()
    del sim, loop, window
    card.free()
    numbers = inputs.compare()
    del inputs
    correct, compared = check.judge(numbers, chk["limits"])
    correct = correct and numbers["frames_compared"] > 0
    print("numbers: " + json.dumps(numbers), file=err, flush=True)
    result.update(correct=correct, metrics=out_metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded: {found}", file=err,
              flush=True)
        return 3
    result["check"] = compared
    print(json.dumps(result), file=out, flush=True)
    for name, v in compared.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=err, flush=True)
    return 0


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m simbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == a.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"simbench: {a.workload} needs {chips} CUDA device(s); this "
              "benchmark runs only on the card", file=sys.stderr)
        return 2
    return run(a.workload, a.seed, a.seconds, bool(a.trace),
               t_start=t_start, bench=bench)
