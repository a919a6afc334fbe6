"""The port's CLI (``python -m softbody_tpu_torch``, ``cli.py``) against
the JAX package's (``python -m softbody_tpu``) at small sizes, both
called in-process with the same arguments (the port's with
``--device cpu``): ``scenes`` output equal, ``snapshot create`` bytes
identical and ``info`` JSON equal, ``run`` JSON equal but for the rates,
``render`` PNG bytes equal; the far-armed planified ``run``; ``play``
headless (stdin not a terminal) draws frames into a buffer and leaves no
worker thread behind."""

import contextlib
import io
import json
import sys
import threading

import pytest
import torch

from softbody_tpu.cli import main as jmain
from softbody_tpu_torch.cli import main as tmain

RATES = ("substeps_per_sec", "particle_substeps_per_sec")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _call(main, argv) -> str:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue()


def _port(argv) -> str:
    return _call(tmain, argv + ["--device", "cpu"])


def _json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_scenes_output_equal():
    assert _port(["scenes"]) == _call(jmain, ["scenes"])


@pytest.mark.parametrize("scene,n,fmt", [("default", None, "auto"),
                                         ("cloth", 256, "v1")])
def test_snapshot_create_and_info_equal(scene, n, fmt, tmp_path):
    args = ["--scene", scene, "--format", fmt] + (
        [] if n is None else ["--n", str(n)])
    jfile, tfile = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jout = _json(_call(jmain, ["snapshot", "create", jfile] + args))
    tout = _json(_port(["snapshot", "create", tfile] + args))
    assert tout["bytes"] == jout["bytes"]
    with open(jfile, "rb") as fj, open(tfile, "rb") as ft:
        assert ft.read() == fj.read()
    info = _json(_call(jmain, ["snapshot", "info", jfile]))
    assert info["particles"] > 100
    assert _json(_port(["snapshot", "info", tfile])) == info
    assert _json(_port(["snapshot", "info", jfile])) == info


# the cloth cases share JAX's compiled frames with the render cases
RUNS = {
    "general": ["--scene", "cloth", "--n", "256", "--subticks", "16",
                "--frames", "2"],
    "lattice": ["--scene", "cloth", "--n", "256", "--subticks", "16",
                "--frames", "2", "--path", "lattice"],
}


@pytest.mark.parametrize("path", list(RUNS))
def test_run_json_equal_but_rates(path):
    ref = _json(_call(jmain, ["run"] + RUNS[path]))
    got = _json(_port(["run"] + RUNS[path]))
    assert got["finite"] and got["beams_alive"] > 0
    for k in RATES:
        assert got.pop(k) > 0
        ref.pop(k)
    assert got == ref


def test_run_planified_farfield():
    """The far-armed planified verb at 400 particles (a 44 × 16 plane:
    far pairs from the first rebuild, chunks of the tile padding among
    them) keeps every beam through a frame, as the JAX CLI's does (its
    far frame is held against JAX's op by op in
    tests/test_torch_planify_far.py; JAX compiles this verb's frame in
    ~27 s, so it is not run here)."""
    from softbody_tpu_torch.models import self_colliding_cloth

    flat, _cfg = self_colliding_cloth(n_particles=400, device="cpu")
    got = _json(_port(["run", "--scene", "self_colliding_cloth", "--n",
                       "400", "--subticks", "24", "--frames", "1",
                       "--path", "planified", "--farfield"]))
    assert got["finite"] and got["path"] == "planified"
    assert got["beams_alive"] == int(flat.beam_count) == 1452


@pytest.mark.parametrize("path,extra", [("general", ["--frames", "1"]),
                                        ("lattice", ["--trails"])])
def test_render_png_bytes_equal(path, extra, tmp_path):
    args = RUNS[path] + ["--resolution", "64"] + extra
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jout = _json(_call(jmain, ["render", "--out", str(jdir)] + args))
    tout = _json(_port(["render", "--out", str(tdir)] + args))
    assert tout["frames_written"] == jout["frames_written"] >= 1
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


@pytest.mark.parametrize("argv", [
    ["--scene", "cloth", "--n", "64"],
    ["--scene", "cloth", "--n", "256", "--path", "lattice", "--farfield"],
], ids=["general", "lattice-farfield"])
def test_play_headless(argv, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    before = {t.ident for t in threading.enumerate()}
    text = _port(["play", "--duration", "2", "--fps", "20"] + argv)
    assert text.count("\x1b[H") >= 1          # frames drawn
    assert "substeps/s |" in text and "particles" in text   # the HUD
    assert text.endswith("\x1b[0m\x1b[?25h\n")   # terminal restored
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.name == "softbody-engine-worker"]
    assert not left


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["run", "--scene", "cloth", "--n", "16", "--frames", "1"])
