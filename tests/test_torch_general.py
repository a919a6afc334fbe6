"""The general gather engine's ops (``state``, ``ops/incidence``,
``ops/forces``, ``ops/integrate``, ``ops/collisions``) against the JAX
package, on the same seeded numpy worlds, JAX run op by op on the CPU.

Exact where the JAX package is exact by construction or the ops are the
same float32 sequence: state building, incidence tables, quantized beam
force totals, beam updates and breakage, the integrator, the broad
phases' sort order, cell offsets and overflow counts, the coincident
nudge.  Collision impulse and penetration sums and f32 segment force sums
differ only in the order torch sums partners: to rtol 1e-5 with an atol
of 1e-6 of the largest term (a few ulp of it)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import softbody_tpu as sb
from softbody_tpu import state as jstate
from softbody_tpu.models import scenes as jscenes
from softbody_tpu.ops import collisions as jcoll
from softbody_tpu.ops import forces as jforces
from softbody_tpu.ops import incidence as jinc
from softbody_tpu.ops import integrate as jint
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import sim_state_to_numpy
from softbody_tpu_torch.ops import collisions as tcoll
from softbody_tpu_torch.ops import forces as tforces
from softbody_tpu_torch.ops import incidence as tinc
from softbody_tpu_torch.ops import integrate as tint

from torch_parity import (
    consts_to_port,
    jittered,
    sim_to_jax,
    sim_to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

SCENES = {
    "default": lambda: jscenes.default_scene(),
    "cloth": lambda: jscenes.cloth(8, 8),
    "multi_blob": lambda: jscenes.multi_blob(n_blobs=4),
}


def _world(scene, seed=1, pos_jitter=6.0, vel_scale=20.0, incidence=True):
    """A scene's numpy fields, jittered so that particles overlap, beams
    yield and break; some particles and beams dead; one coincident
    pair."""
    jst, cfg = SCENES[scene]()
    f = jittered(sim_state_to_numpy(jst), seed, pos_jitter, vel_scale)
    rng = np.random.default_rng(seed + 1)
    f["particle_alive"] = f["particle_alive"] & (rng.random(
        f["particle_alive"].shape) > 0.05)
    f["beam_alive"] = f["beam_alive"] & (rng.random(
        f["beam_alive"].shape) > 0.05)
    f["pos"][3] = f["pos"][4]
    if not incidence:
        f["inc_beam"] = f["inc_sign"] = None
    return f, cfg


def _cfgs(cfg, **kw):
    jc = dataclasses.replace(cfg, **kw)
    tc = tb.StaticConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(tb.StaticConfig)})
    return jc, tc


def _close(got, ref, scale=None):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("incidence,capacity", [
    (True, None), (False, None), (True, (200, 400))])
def test_state_from_numpy_matches_jax(incidence, capacity):
    rng = np.random.default_rng(0)
    pos = rng.uniform(100, 900, (30, 2)).astype(np.float32)
    beams = rng.integers(0, 30, (50, 2))
    kw = dict(vel=rng.normal(size=(30, 2)).astype(np.float32), beams=beams,
              beam_spring=np.float32(3.5), beam_damp=rng.random(50),
              beam_yield_strain=0.4, pinned=rng.random(30) < 0.2,
              build_incidence=incidence)
    if capacity:
        kw.update(max_particles=capacity[0], max_beams=capacity[1])
    ref = sim_state_to_numpy(jstate.state_from_numpy(pos, **kw))
    st = tb.state_from_numpy(pos, device="cpu", **kw)
    got = sim_state_to_numpy(st)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(st.particle_count) == 30 and int(st.beam_count) == 50
    assert st.max_particles == (capacity or (30,))[0]


def test_empty_state_matches_jax():
    ref = sim_state_to_numpy(jstate.empty_state(7, 5))
    got = sim_state_to_numpy(tb.empty_state(7, 5, device="cpu"))
    for k, v in ref.items():
        if v is not None:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_build_incidence_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 40, 120), rng.integers(0, 40, 120)
    for kw in ({}, dict(min_degree=2, pad_multiple=8)):
        ref = jinc.build_incidence(a, b, 45, **kw)
        got = tinc.build_incidence(a, b, 45, **kw)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("force_mode", ["quantized", "segment"])
@pytest.mark.parametrize("incidence", [True, False])
def test_beam_forces_match_jax(force_mode, incidence):
    """Beam updates and breaks bit-exact; quantized totals bit-exact (int32
    sums); segment totals to the module's tolerance."""
    f, cfg = _world("default", pos_jitter=20.0, incidence=incidence)
    jc, tc = _cfgs(cfg, force_mode=force_mode)
    js, ts = sim_to_jax(f), sim_to_port(f)
    jfv, jupd, jbr = jforces.beam_forces(js, jc)
    tfv, tupd, tbr = tforces.beam_forces(ts, tc)
    np.testing.assert_array_equal(tfv.numpy(), np.asarray(jfv))
    for k in jupd:
        np.testing.assert_array_equal(tupd[k].numpy(), np.asarray(jupd[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tbr.numpy(), np.asarray(jbr))
    assert int(np.asarray(jbr).sum()) > 0, "some beams must break"
    ref = jforces.accumulate_forces(js, jfv, jc)
    got = tforces.accumulate_forces(ts, tfv, tc)
    if force_mode == "quantized":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref, scale=np.abs(np.asarray(jfv)).max())


@pytest.mark.parametrize("mode", ["allpairs", "grid", "window"])
@pytest.mark.parametrize("scene", ["cloth", "multi_blob"])
def test_collision_terms_match_jax(mode, scene):
    """Impulse and penetration sums to the module's tolerance, the
    coincident nudge exactly; small tiles and windows so that the tiled
    and windowed loops run several passes."""
    f, cfg = _world(scene)
    jc, tc = _cfgs(cfg, collision_mode=mode, collision_tile=24,
                   window_rows=96)
    consts = sb.PhysicsConstants.default()
    args = [f["pos"], f["vel"], f["particle_alive"]]
    ref = jcoll.collision_terms(*(jnp.asarray(a) for a in args), consts, jc)
    got = tcoll.collision_terms(*(torch.from_numpy(a) for a in args),
                                consts_to_port(consts), tc)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0, "particles overlap"
    assert float(np.abs(np.asarray(ref[2])).max()) > 0, "a coincident pair"
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def _crowded(n=300, seed=4):
    """Particles crowded into a corner: hash cells past their capacity and
    sorted windows past their row cap."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(5.0, 120.0, (n, 2)).astype(np.float32)
    pos[:40] = rng.uniform(500.0, 505.0, (40, 2))
    alive = rng.random(n) > 0.1
    return pos, alive


def test_build_grid_matches_jax():
    pos, alive = _crowded()
    jc, tc = _cfgs(sb.StaticConfig(particle_radius=6.0),
                   collision_mode="grid", grid_cell_capacity=3)
    ref = jcoll.build_grid(jnp.asarray(pos), jnp.asarray(alive), jc)
    got = tcoll.build_grid(torch.from_numpy(pos), torch.from_numpy(alive),
                           tc)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(ref[2]) > 0


@pytest.mark.parametrize("mode,kw", [
    ("grid", dict(grid_cell_capacity=3)),
    ("grid", dict(grid_cell_capacity=64)),
    ("window", dict(window_rows=64)),
    ("allpairs", {}),
])
def test_broad_phase_overflow_matches_jax(mode, kw):
    pos, alive = _crowded()
    jc, tc = _cfgs(sb.StaticConfig(particle_radius=6.0),
                   collision_mode=mode, **kw)
    ref = int(jcoll.broad_phase_overflow(jnp.asarray(pos),
                                         jnp.asarray(alive), jc))
    got = tcoll.broad_phase_overflow(torch.from_numpy(pos),
                                     torch.from_numpy(alive), tc)
    assert int(got) == ref
    assert (ref > 0) == (mode != "allpairs" and kw.get(
        "grid_cell_capacity") != 64)


def test_integrate_particles_matches_jax():
    """The flat integrator is the lattice path's component integrator:
    bit-exact against JAX's, with the mouse, keyboard force, drag,
    border hits and pinned and dead particles."""
    rng = np.random.default_rng(5)
    n = 200
    pos = rng.uniform(-20.0, 1020.0, (n, 2)).astype(np.float32)
    vel = rng.normal(0.0, 40.0, (n, 2)).astype(np.float32)
    vel[:3] = 0.0
    acc = rng.normal(0.0, 2.0, (n, 2)).astype(np.float32)
    alive = rng.random(n) > 0.1
    pinned = rng.random(n) < 0.1
    dv = rng.normal(0.0, 3.0, (n, 2)).astype(np.float32)
    da = rng.normal(0.0, 50.0, (n, 2)).astype(np.float32)
    dy = rng.integers(-1, 2, n).astype(np.float32)
    bf = rng.normal(0.0, 5.0, (n, 2)).astype(np.float32)
    consts = sb.PhysicsConstants.default()
    consts.drag_exp = jnp.float32(1.7)
    uin = sb.UserInput(
        user_strength=jnp.float32(1.5), mouse_active=jnp.asarray(True),
        mouse_pos=jnp.asarray(pos[7] + 3.0), mouse_vel=jnp.asarray(
            [4.0, -2.0], jnp.float32),
        applied_force=jnp.asarray([0.3, -0.2], jnp.float32))
    jc, tc = _cfgs(sb.StaticConfig(particle_radius=7.0))
    arrays = (pos, vel, acc, alive, pinned, dv, da, dy, bf)
    ref = jint.integrate_particles(*(jnp.asarray(a) for a in arrays),
                                   consts, uin, jc)
    got = tint.integrate_particles(*(torch.from_numpy(a) for a in arrays),
                                   consts_to_port(consts), uin_to_port(uin),
                                   tc)
    for g, r, name in zip(got, ref, ("pos", "vel", "acc")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
