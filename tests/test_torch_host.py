"""The port's host surfaces against the JAX package's on the same inputs:
``utils/png.py`` and ``utils/profiling.py``, ``mapping.py``'s registry
(``to_state``, ``load_state``, snapshot bytes both ways),
``models.add_rectangle``, ``models.lattice_to_simstate`` on a torn
lattice, and ``editor.py`` (a scripted session: saves byte-identical,
the overlaid render equal as uint8)."""

import json
import math
import time

import numpy as np
import pytest
import torch

from softbody_tpu import editor as jeditor
from softbody_tpu import mapping as jmapping
from softbody_tpu import models as jmodels
from softbody_tpu.utils import png as jpng
from softbody_tpu.utils import profiling as jprofiling
from softbody_tpu_torch import editor as teditor
from softbody_tpu_torch import mapping as tmapping
from softbody_tpu_torch import models as tmodels
from softbody_tpu_torch import viz as tviz
from softbody_tpu_torch.convert import (
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    sim_state_to_numpy,
)
from softbody_tpu_torch.utils import png as tpng
from softbody_tpu_torch.utils import profiling as tprofiling

from torch_parity import sim_to_jax, sim_to_port, to_jax


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_fields_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------- utils


def test_png_bytes_equal(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    jpng.write_png(str(tmp_path / "j.png"), img)
    tpng.write_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    # a float image through save_png (rounded, clipped), given as a tensor
    f = rng.uniform(-0.1, 1.1, (9, 5, 3)).astype(np.float32)
    from softbody_tpu.viz import save_png as jsave_png

    jsave_png(str(tmp_path / "jf.png"), f)
    tviz.save_png(str(tmp_path / "tf.png"), torch.from_numpy(f))
    assert (tmp_path / "jf.png").read_bytes() == (tmp_path / "tf.png").read_bytes()
    with pytest.raises(ValueError):
        tpng.write_png(str(tmp_path / "bad.png"), img[..., :2])


def test_profiling_counters_match_jax():
    profs = [jprofiling.Profiler(64, 1000), tprofiling.Profiler(64, 1000)]
    for p in profs:
        p.elapsed = 2.0
        p.add_frames(10)
    assert profs[1].substeps_per_sec == profs[0].substeps_per_sec == 320.0
    assert (profs[1].particle_substeps_per_sec
            == profs[0].particle_substeps_per_sec)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.device_trace(None):
        pass
    with tprofiling.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


# ------------------------------------------------------ registry, editor


def _registry(pkg_mapping, pkg_models):
    """Two rectangles through ``add_rectangle`` (one unbreakable), a free
    flung particle, a removed particle (its beams go with it) and a
    dangling beam id reused."""
    reg = pkg_mapping.SceneRegistry()
    pkg_models.add_rectangle(reg, 100.0, 120.0, 30.0, 5, 4, 50.0, 2.0,
                             0.2, 0.5)
    pkg_models.add_rectangle(reg, 500.0, 600.0, 25.0, 3, 3, 10.0, 1.0)
    Vec2 = pkg_mapping.Vec2
    reg.add_particle(pkg_mapping.ParticleObj(
        reg.first_empty_particle_id, Vec2(700.5, 40.25), Vec2(3.0, -2.5)))
    reg.remove_particle(7)
    reg.add_beam(pkg_mapping.BeamObj(reg.first_empty_beam_id, 0, 30,
                                     length=12.5, spring=4.0, damp=0.25))
    return reg


@pytest.fixture(scope="module")
def registries():
    return _registry(jmapping, jmodels), _registry(tmapping, tmodels)


@pytest.mark.parametrize("fmt", ["auto", "v0", "v1"])
def test_registry_save_bytes_equal(fmt, registries):
    jreg, treg = registries
    assert treg.particle_count == jreg.particle_count == 29
    buf = jreg.save(format=fmt)
    assert treg.save(format=fmt) == buf
    # each package's registry reads the other's bytes back the same
    back = tmapping.SceneRegistry()
    assert back.load(buf)
    jback = jmapping.SceneRegistry()
    assert jback.load(treg.save(format=fmt))
    for k, v in jback.to_arrays().items():
        np.testing.assert_array_equal(back.to_arrays()[k], v, err_msg=k)
    assert back.save(format=fmt) == buf


def test_registry_to_state_and_load_state(registries):
    jreg, treg = registries
    ref = sim_state_to_numpy(jreg.to_state())
    got = sim_state_to_numpy(treg.to_state(device="cpu"))
    _assert_fields_equal(got, ref)
    # a state with holes: dead particles and beams are skipped on load
    fields = dict(ref)
    fields["particle_alive"] = fields["particle_alive"].copy()
    fields["particle_alive"][[2, 11]] = False
    fields["beam_alive"] = fields["beam_alive"].copy()
    fields["beam_alive"][::5] = False
    jl, tl = jmapping.SceneRegistry(), tmapping.SceneRegistry()
    jl.load_state(sim_to_jax(fields))
    tl.load_state(sim_to_port(fields))
    assert tl.particle_count == jl.particle_count == 27
    for k, v in jl.to_arrays().items():
        np.testing.assert_array_equal(tl.to_arrays()[k], v, err_msg=k)
    # a capacity the snapshot exceeds is refused, as in JAX
    small = tmapping.SceneRegistry(max_particles=4)
    assert not small.load(jreg.save())
    assert not small.load(b"not a snapshot")


def _editor_session(pkg_editor, pkg_mapping, **kw):
    """One scripted session: a beam drawn between fresh particles, a
    second from an existing one snapped onto a third, a flung particle,
    auto-triangulation, a painted and a deleted beam, a moved selection."""
    Vec2 = pkg_mapping.Vec2
    ed = pkg_editor.SoftbodyEditor(**kw)
    ed.auto_triangulate_distance = 60.0
    ed.beam_settings = pkg_editor.BeamSettings(spring=25.0, damp=3.0,
                                               yield_strain=0.3,
                                               strain_limit=0.9)
    ed.pointer_down(Vec2(200, 300))
    ed.pointer_move(Vec2(260, 310))
    ed.pointer_up(Vec2(260, 310))
    ed.pointer_down(Vec2(260, 310))
    ed.pointer_move(Vec2(240, 360))
    ed.pointer_up(Vec2(240, 360))
    ed.pointer_down(Vec2(500, 500))
    ed.pointer_up(Vec2(520, 540))
    ed.pointer_down(Vec2(230, 305))       # paint the first beam
    ed.pointer_up(Vec2(230, 305))
    ed.set_edit_mode("particle")
    ed.pointer_down(Vec2(700, 200))
    ed.pointer_up(Vec2(730, 180))         # fling
    ed.select_mode = True
    ed.pointer_down(Vec2(150, 250))
    ed.pointer_move(Vec2(300, 400))
    ed.pointer_up(Vec2(300, 400))
    ed.select_mode = False
    ed.pointer_down(Vec2(200, 300))       # move the selection
    ed.pointer_move(Vec2(220, 330))
    ed.pointer_up(Vec2(220, 330))
    ed.set_edit_mode("beam")
    ed.delete_mode = True
    ed.pointer_down(Vec2(510, 520))
    ed.pointer_up(Vec2(510, 520))
    ed.delete_mode = False
    ed.snap_grid_size = 50.0
    ed.pointer_move(Vec2(240, 340))
    return ed


def test_editor_session_saves_and_renders_like_jax(monkeypatch):
    # the HUD prints the renders of the last second: a clock that stands
    # still keeps a slow first render (JAX compiles it) inside that window
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    jed = _editor_session(jeditor, jmapping)
    ted = _editor_session(teditor, tmapping, device="cpu")
    assert ted.registry.particle_count == jed.registry.particle_count
    assert ted.registry.beam_count == jed.registry.beam_count > 2
    assert ted.save() == jed.save()
    got = ted.render(resolution=96, overlay=True)
    ref = jed.render(resolution=96, overlay=True)
    assert got.dtype == np.uint8 and got.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ted.render(resolution=96, overlay=False),
                                  jed.render(resolution=96, overlay=False))


# ------------------------------------------------------- dense lattices


def test_add_rectangle_matches_jax(registries):
    jreg, treg = registries
    def xy(v):
        return v.x, v.y

    for pj, pt in zip(jreg.particles, treg.particles):
        assert (pt.id, xy(pt.position), xy(pt.velocity)) == (
            pj.id, xy(pj.position), xy(pj.velocity))
    for bj, bt in zip(jreg.beams, treg.beams):
        assert (bt.id, bt.a, bt.b, bt.length, bt.spring, bt.yield_strain,
                bt.strain_limit) == (bj.id, bj.a, bj.b, bj.length,
                                     bj.spring, bj.yield_strain,
                                     bj.strain_limit)
    assert math.isinf(treg.beams[-2].yield_strain)


@pytest.mark.parametrize("incidence", [True, False])
def test_lattice_to_simstate_matches_jax(incidence):
    """A torn 21 × 21 lattice (two slits, broken and yielded springs with
    strain and stress, dead and pinned particles) flattened by both."""
    jstate, _spec, _cfg, _consts = jmodels.tearing_cloth_lattice(
        n_particles=480, slits=2, pin_top=True)
    fields = lattice_state_to_numpy(jstate)
    w, h = fields["pos"].shape[:2]
    rng = np.random.default_rng(2)
    fields["alive"] = rng.random((w, h)) > 0.05
    for e in fields["edges"]:
        e["alive"] = e["alive"] & (rng.random((w, h)) > 0.1)
        e["strain"] = rng.normal(0, 1, (w, h)).astype(np.float32)
        e["stress"] = rng.normal(0, 1, (w, h)).astype(np.float32)
        e["target_length"] = (e["target_length"]
                              * rng.uniform(0.9, 1.1, (w, h))
                              ).astype(np.float32)
    ref = sim_state_to_numpy(jmodels.lattice_to_simstate(
        to_jax(fields), build_incidence=incidence))
    got = sim_state_to_numpy(tmodels.lattice_to_simstate(
        lattice_state_from_numpy(**fields, device="cpu"),
        build_incidence=incidence, device="cpu"))
    _assert_fields_equal(got, ref)
    assert not ref["particle_alive"].all()
