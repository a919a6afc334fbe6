"""The general gather engine as a whole (``ops/step``, ``models/scenes``,
``convert``) against the JAX package and against ``tests/oracle.py``.

- The scene builders give the JAX package's arrays bit for bit.
- One substep from a jittered world (overlaps, yields, breaks) is
  bit-exact against JAX run op by op in positions, accelerations and
  every beam field; velocities to the collision sums' f32 order (rtol
  1e-5, atol 1e-6 of the largest velocity).
- Trajectories (JAX's ``substep_jit`` and ``frame_jit``) keep beam
  liveness equal and positions and velocities within
  tests/test_step_vs_oracle.py:68-76's tolerances (pos atol 2e-3, vel
  atol 4e-3): JAX's jitted step itself rounds a few sums differently
  from its op-by-op run, and springs amplify a last-bit difference.
- The two-blob collision and the 8×8 cloth against the NumPy oracle at
  the JAX tests' own tolerances (tests/test_multiblob.py:80-83,
  tests/test_step_vs_oracle.py:107)."""

import dataclasses

import numpy as np
import pytest

import softbody_tpu as sb
from softbody_tpu.models import scenes as jscenes
from softbody_tpu.ops.step import frame_jit, substep as j_substep
from softbody_tpu.ops.step import substep_jit
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import sim_state_to_numpy
from softbody_tpu_torch.models import scenes as tscenes
from softbody_tpu_torch.ops import step as tstep

import oracle
from test_step_vs_oracle import cloth_grid
from test_torch_general import SCENES, _cfgs, _world
from torch_parity import consts_to_port, jittered, sim_to_jax, sim_to_port
from torch_parity import uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

SCENE_BUILDERS = {
    "default_scene": {},
    "cloth": dict(w=6, h=5, pin_top=True),
    "blob": dict(radius=80.0),
    "self_colliding_cloth": dict(n_particles=400),
    "multi_blob": dict(n_blobs=4),
    "tearing_cloth": dict(n_particles=400),
}


def _consts_uin():
    return sb.PhysicsConstants.default(), sb.UserInput.none()


def _port_step(f, cfg, n):
    consts, uin = _consts_uin()
    st = sim_to_port(f)
    for _ in range(n):
        st = tstep.substep(st, consts_to_port(consts), uin_to_port(uin), cfg)
    return sim_state_to_numpy(st)


@pytest.mark.parametrize("name", sorted(SCENE_BUILDERS))
def test_scene_builders_match_jax(name):
    kw = SCENE_BUILDERS[name]
    jst, jcfg = getattr(jscenes, name)(**kw)
    tst, tcfg = getattr(tscenes, name)(**kw, device="cpu")
    ref, got = sim_state_to_numpy(jst), sim_state_to_numpy(tst)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for fld in dataclasses.fields(tb.StaticConfig):
        assert getattr(tcfg, fld.name) == getattr(jcfg, fld.name), fld.name
    assert tst.pos.device.type == "cpu"


@pytest.mark.parametrize("scene,mode,force", [
    ("default", "allpairs", "quantized"),
    ("cloth", "grid", "segment"),
    ("multi_blob", "window", "quantized"),
])
def test_substep_matches_jax_op_by_op(scene, mode, force):
    f, cfg = _world(scene, pos_jitter=12.0)
    jc, tc = _cfgs(cfg, collision_mode=mode, force_mode=force)
    consts, uin = _consts_uin()
    ref = sim_state_to_numpy(j_substep(sim_to_jax(f), consts, uin, jc))
    got = _port_step(f, tc, 1)
    for k, v in ref.items():
        if v is None or k == "vel":
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=1e-5,
                               atol=1e-6 * np.abs(ref["vel"]).max())
    assert (ref["beam_target_length"] != f["beam_target_length"]).any(), \
        "beams yield"


@pytest.mark.parametrize("scene,mode,force,incidence", [
    ("default", "allpairs", "quantized", True),
    ("default", "grid", "segment", False),
    ("default", "window", "quantized", False),
    ("cloth", "allpairs", "segment", True),
    ("cloth", "grid", "quantized", True),
    ("cloth", "window", "segment", True),
    ("multi_blob", "grid", "quantized", True),
    ("multi_blob", "allpairs", "quantized", False),
    ("multi_blob", "window", "segment", False),
])
def test_trajectory_matches_jax(scene, mode, force, incidence):
    """24 substeps of a scene with small random velocities: every broad
    phase, both force modes, with and without the incidence."""
    jst, cfg = SCENES[scene]()
    f = jittered(sim_state_to_numpy(jst), 7, 0.5, 3.0)
    if not incidence:
        f["inc_beam"] = f["inc_sign"] = None
    jc, tc = _cfgs(cfg, collision_mode=mode, force_mode=force,
                   collision_tile=32, window_rows=256)
    consts, uin = _consts_uin()
    js = sim_to_jax(f)
    for _ in range(24):
        js = substep_jit(js, consts, uin, jc)
    ref = sim_state_to_numpy(js)
    got = _port_step(f, tc, 24)
    np.testing.assert_array_equal(got["beam_alive"], ref["beam_alive"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=4e-3)


def test_frame_and_run_frames_match_jax():
    """``frame`` is ``cfg.subticks`` substeps (JAX: one ``lax.scan``);
    ``run_frames`` repeats it."""
    jst, cfg = jscenes.cloth(8, 8)
    jc, tc = _cfgs(cfg, subticks=16)
    f = jittered(sim_state_to_numpy(jst), 3, 0.5, 3.0)
    consts, uin = _consts_uin()
    js = sim_to_jax(f)
    for _ in range(2):
        js = frame_jit(js, consts, uin, jc)
    ref = sim_state_to_numpy(js)
    tconsts, tuin = consts_to_port(consts), uin_to_port(uin)
    once = tstep.frame(tstep.frame(sim_to_port(f), tconsts, tuin, tc),
                       tconsts, tuin, tc)
    twice = tstep.run_frames(sim_to_port(f), tconsts, tuin, tc, 2)
    got = sim_state_to_numpy(twice)
    for k in ("pos", "vel", "acc", "beam_alive"):
        np.testing.assert_array_equal(got[k], sim_state_to_numpy(once)[k])
    np.testing.assert_array_equal(got["beam_alive"], ref["beam_alive"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=4e-3)


def _to_oracle(fields):
    names = dict(particle_alive="alive", beam_length="length",
                 beam_target_length="target", beam_last_length="last",
                 beam_spring="spring", beam_damp="damp",
                 beam_yield_strain="yield_strain",
                 beam_strain_limit="strain_limit", beam_strain="strain",
                 beam_stress="stress")
    return {names.get(k, k): v for k, v in fields.items()
            if k not in ("particle_pinned", "inc_beam", "inc_sign")}


@pytest.mark.parametrize("quantized", [True, False])
def test_cloth_trajectory_matches_oracle(quantized):
    """tests/test_step_vs_oracle.py's 8×8 cloth, 32 substeps."""
    pos, beams, lengths, props = cloth_grid()
    st = tb.state_from_numpy(
        pos, beams=beams, beam_length=lengths, beam_spring=props["spring"],
        beam_damp=props["damp"], beam_yield_strain=props["yield_strain"],
        beam_strain_limit=props["strain_limit"],
        build_incidence=quantized, device="cpu")
    cfg = tb.StaticConfig(collision_mode="allpairs", collision_tile=32,
                          force_mode="quantized" if quantized else "segment")
    s_np = oracle.make_state(pos, beams=beams, length=lengths, **props)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    for _ in range(32):
        st = tstep.substep(st, consts, uin, cfg)
        s_np = oracle.substep(s_np, dt=cfg.dt, quantized=quantized)
    got = sim_state_to_numpy(st)
    np.testing.assert_allclose(got["pos"], s_np["pos"], atol=2e-3)
    np.testing.assert_allclose(got["vel"], s_np["vel"], atol=4e-3)
    np.testing.assert_array_equal(got["beam_alive"], s_np["beam_alive"])


@pytest.mark.parametrize("mode", ["allpairs", "grid"])
def test_blob_contact_matches_oracle(mode):
    """tests/test_multiblob.py's two blobs on a collision course, built
    with the port's scene helpers, 24 substeps."""
    from softbody_tpu_torch.models.scenes import (
        _build,
        _disk_points,
        _triangulate,
        merge_scenes,
    )

    parts = []
    for cx in (300.0, 300.0 + 2 * 40.0 + 2.0):
        pos = _disk_points(cx, 500.0, 40.0, 18.0)
        beams, lengths = _triangulate(pos, 18.0 * 1.6)
        m = beams.shape[0]
        parts.append((pos, beams, lengths, {
            "spring": np.full(m, 120.0, np.float32),
            "damp": np.full(m, 15.0, np.float32),
            "yield_strain": np.full(m, 0.6, np.float32),
            "strain_limit": np.full(m, 3.0, np.float32)}))
    merged = merge_scenes(*parts)
    n0 = parts[0][0].shape[0]
    vel = np.zeros_like(merged[0])
    vel[:n0, 0], vel[n0:, 0] = 15.0, -15.0
    st = _build(*merged, vel=vel, device="cpu")
    cfg = tb.StaticConfig(collision_mode=mode, particle_radius=18.0 * 0.45,
                          grid_cell_capacity=8)
    s_np = _to_oracle(sim_state_to_numpy(st))
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    for _ in range(24):
        st = tstep.substep(st, consts, uin, cfg)
        s_np = oracle.substep(s_np, dt=cfg.dt, radius=cfg.particle_radius,
                              quantized=True)
    got = sim_state_to_numpy(st)
    np.testing.assert_allclose(got["pos"], s_np["pos"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["vel"], s_np["vel"], rtol=0, atol=2e-2)


def test_sim_state_convert_round_trip():
    """JAX state → numpy → port → numpy → JAX gives the same fields."""
    jst, _cfg = jscenes.multi_blob(n_blobs=2)
    ref = sim_state_to_numpy(jst)
    back = sim_state_to_numpy(sim_to_jax(sim_state_to_numpy(
        sim_to_port(ref))))
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    st = sim_to_port(ref)
    assert st.beam_a.dtype.is_floating_point is False
    assert int(st.particle_count) == int(ref["particle_alive"].sum())
    assert int(st.beam_count) == int(ref["beam_alive"].sum())
