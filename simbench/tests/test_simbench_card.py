"""On the card: one short run of the cheapest cell comes out correct and
prints every end-to-end metric of the cell.  Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "simbench", "--workload", "cloth1m-fall",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    want = {m["name"] for m in bench["end_to_end"]
            if "cloth1m-fall" in m.get("workloads", ["cloth1m-fall"])}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
