"""Every name in BENCHMARK.json resolves to its files, and a new cell,
mix and metric can be added as new files alone."""

import json
import os
import shutil
import subprocess
import sys

from simbench import harness, roofline

from .conftest import ROOT


def test_every_cell_config_mix_and_metric_resolves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert json.loads(path.read_text())["name"] == c["name"]
        mod = harness.load_module("configs", f"{c['name']}.py")
        assert mod.REDUCED == c["reduced"]
        assert hasattr(mod, "Sim") and mod.SOURCE
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert cell.spec["config"] == w["config"]
        assert cell.spec["traffic"] == w["traffic"]
        assert {"start_diff"} <= set(cell.spec["check"]["limits"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", f"{m['name']}.py")
                        .read)
        assert m["moves"] in e2e
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


def test_k1_bytes_at_1m_is_172_mb():
    assert roofline.k1_bytes(1_000_000) == 172e6
    t, what = roofline.bound(roofline.k1_bytes(1_000_000),
                             roofline.substep_ops(1_000_000, 2))
    assert what == "bytes" and abs(t - 0.0513) < 1e-4


RUNNER = """
import json, sys, torch
torch.set_num_threads(2)
from simbench import harness
from simbench.tests.conftest import HostCard, HostCell
bench = json.load(open(sys.argv[1]))
harness.Cell = HostCell
sys.exit(harness.run("throwaway-cell", 5, 0.1, sys.argv[2] == "1",
                     bench=bench, card=HostCard()))
"""

LOOP = """
from simbench import harness

base = harness.load_module("loops", "episodes.py")


class Window(base.Window):
    def end_to_end(self, setup_s):
        return {"setup_s": setup_s,
                "episodes_per_s": self.episodes / self.seconds}


class Loop(base.Loop):
    def window(self, seconds, sample):
        w = super().window(seconds, sample)
        self.result = Window(**vars(w))
        return self.result
"""


def test_a_throwaway_cell_needs_new_files_only(tmp_path, bench):
    """A copy of the benchmark gains a cell, a mix, a loop with an
    end-to-end metric of its own and a per-layer metric as new files and
    entries, with no file edited, and runs."""
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    sb = tmp_path / "simbench"
    (sb / "loops" / "throwaway_loop.py").write_text(LOOP)
    (sb / "traffic" / "throwaway.json").write_text(json.dumps(
        {"loop": "throwaway_loop", "from": "initial", "frames": 1}))
    (sb / "workloads" / "throwaway-cell.json").write_text(json.dumps(
        {"name": "throwaway-cell", "config": "tearing_cloth_1m",
         "traffic": "throwaway", "why": "a test",
         "check": {"frames": 1, "episodes": 1,
                   "limits": {"start_diff": 0, "pos_err_p50": 1e-3}}}))
    (sb / "metrics" / "throwaway_metric.py").write_text(
        "def read(ctx):\n    return float(ctx.window.episodes)\n")
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "throwaway-cell", "config": "tearing_cloth_1m",
         "traffic": "throwaway", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = [
        {"name": "episodes_per_s", "unit": "episodes/s", "better": "higher",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["throwaway-cell"]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}]
    bench["per_layer"] = [{"name": "throwaway_metric", "unit": "episodes",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "episodes_per_s",
                           "workloads": ["throwaway-cell"]}]
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    (tmp_path / "run_cell.py").write_text(RUNNER)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    for trace, want in (("0", {"episodes_per_s", "setup_s"}),
                        ("1", {"throwaway_metric"})):
        out = subprocess.run([sys.executable, str(tmp_path / "run_cell.py"),
                              str(tmp_path / "bench.json"), trace],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True
        assert set(result["metrics"]) == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
        assert list(result)[-1] == "check"
