"""Nothing of the benchmark loads JAX or the JAX package, compared by
whole top-level names; without a card a run exits non-zero and prints
no result."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from simbench import harness

from .conftest import ROOT


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "simbench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        names = set(_top_names(path))
        assert not names & set(harness.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("softbody_tpu_torch", "softbody_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "softbody_tpu.ops", sys)
    assert harness.forbidden_modules() == ["softbody_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Importing the harness, every configuration and reader, and the
    program's modules a run uses, in a fresh process."""
    code = (
        "import sys, json; from simbench import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[harness.Cell(w['name'], b) for w in b['workloads']]\n"
        "[harness.load_module('metrics', m['name'] + '.py') "
        "for m in b['per_layer']]\n"
        "import softbody_tpu_torch.engine.backends, "
        "softbody_tpu_torch.models.lattice_dense, "
        "softbody_tpu_torch.models.scenes\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "simbench", "--workload", "cloth1m-tear",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
