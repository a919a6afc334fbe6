"""The port's parallel layer for the general engine (``parallel/mesh``,
``spatial``, ``batched`` and ``collision_terms(query=)``) against the
JAX package's, on the same seeded numpy worlds: JAX on its 8 virtual CPU
devices (tests/conftest.py), the port on meshes of ``["cpu"] * n``.
The counterparts of tests/test_parallel.py:45-146.

- ``collision_terms(query=)`` equals the full pass's rows bit for bit
  (the same pairs in the same order) and JAX's query to the collision
  sums' float32 order (rtol 1e-5, atol 1e-6 of the largest term;
  tests/test_torch_general.py); the nudge sums exactly.
- The sharded frame with quantized forces and collisions off is
  bit-exact against JAX's sharded frame in positions, velocities,
  accelerations and every beam field: the beam pass keeps JAX's sharded
  expressions and the int32 sums are exact in any order.  JAX's frame is
  compiled there without XLA's fusion and algebraic simplifier
  (``_jax_as_written``): on the CPU those contract ``a·b + c·d`` into a
  fused multiply-add and turn ``x / 20`` into ``x · 0.05``, which no
  torch op does.
- JAX's falling cloth of tests/test_parallel.py:45-67 within that test's
  tolerances (pos atol 2e-4, vel 5e-4), beam liveness equal.  With
  contacts across shards (a granular world) the sharded frame equals
  the single-device one bit for bit, and JAX's to the collision sums'
  order amplified over a frame of contacts (stated at the test).
- Batches (dp) and dp×sp equal the port's single-device frame of each
  world bit for bit, and JAX's within tests/test_parallel.py's
  tolerances (1e-5 and 2e-4)."""

import numpy as np
import pytest
import torch

import jax

import softbody_tpu as sb
from softbody_tpu.models import cloth as j_cloth
from softbody_tpu.ops import collisions as jcoll
from softbody_tpu.parallel import (
    batched_frame_fn as j_batched_frame_fn,
    device_put_batched as j_device_put_batched,
    make_mesh as j_make_mesh,
    pad_state_for_mesh as j_pad,
    shard_state as j_shard_state,
    spatial_frame_fn as j_spatial_frame_fn,
    stack_states as j_stack,
    unstack_states as j_unstack,
)
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import sim_state_to_numpy
from softbody_tpu_torch.ops import collisions as tcoll
from softbody_tpu_torch.ops import step as tstep
from softbody_tpu_torch.parallel import (
    batched_frame_fn,
    device_put_batched,
    make_mesh,
    mesh as tmesh,
    pad_state_for_mesh,
    shard_state,
    spatial_frame_fn,
    stack_states,
    unshard_state,
    unstack_states,
)

from test_torch_general import _cfgs
from torch_parity import (
    consts_to_port,
    jittered,
    sim_to_jax,
    sim_to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CONSTS, UIN = sb.PhysicsConstants.default(), sb.UserInput.none()
BEAM_KEYS = ("beam_target_length", "beam_last_length", "beam_strain",
             "beam_stress", "beam_alive")


def _cpu_mesh(n, dp):
    return make_mesh(n, dp=dp, devices=["cpu"] * n)


def _world(w, h, spacing, seed, vel=2.0):
    """numpy fields of a jittered cloth whose beams yield and break."""
    jst, cfg = j_cloth(w=w, h=h, spacing=spacing)
    f = jittered(sim_state_to_numpy(j_pad(jst, 8)), seed, 1.0, vel)
    f = {k: None if v is None else v.copy() for k, v in f.items()}
    f["inc_beam"] = f["inc_sign"] = None
    rng = np.random.default_rng(seed + 1)
    m = f["beam_alive"].shape
    f["beam_yield_strain"] = rng.uniform(0.01, 0.05, m).astype(np.float32)
    f["beam_strain_limit"] = rng.uniform(0.04, 0.3, m).astype(np.float32)
    return f, cfg


def _jax_as_written(fn, *args):
    """JAX's jitted ``fn`` compiled without XLA's fusion and algebraic
    simplifier, so that its float32 expressions round as written."""
    return fn.lower(*args).compile(compiler_options={
        "xla_disable_hlo_passes": "fusion,algsimp"})(*args)


def _run_jax_sharded(js, jc, n, dp_axis=None, as_written=False):
    mesh = j_make_mesh(n, dp=1 if dp_axis is None else 2)
    step = j_spatial_frame_fn(jc, mesh, dp_axis=dp_axis, donate=False)
    args = (j_shard_state(js, mesh, dp_axis=dp_axis), CONSTS, UIN)
    return _jax_as_written(step, *args) if as_written else step(*args)


def _run_port_sharded(state, tc, n, dp=1, dp_axis=None):
    mesh = _cpu_mesh(n, dp)
    out = spatial_frame_fn(tc, mesh, dp_axis=dp_axis)(
        shard_state(state, mesh, dp_axis=dp_axis), consts_to_port(CONSTS),
        uin_to_port(UIN))
    return unshard_state(out)


def _port_frame(state, tc):
    return tstep.frame(state, consts_to_port(CONSTS), uin_to_port(UIN), tc)


def test_make_mesh_and_collectives():
    mesh = _cpu_mesh(8, None)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert j_make_mesh(8).shape == dict(mesh.shape)
    assert _cpu_mesh(4, None).shape == {"dp": 2, "sp": 2}
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        _cpu_mesh(8, 3)
    xs = [torch.full((2,), float(i)) for i in range(4)]
    got = tmesh.ppermute(xs, [(i, i + 1) for i in range(3)])
    assert [g.tolist() for g in got] == [[0, 0], [0, 0], [1, 1], [2, 2]]
    assert tmesh.all_gather(xs)[3].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    big = [torch.tensor([2**29, -7], dtype=torch.int32) for _ in range(3)]
    assert tmesh.psum(big)[1].tolist() == [3 * 2**29, -21]


def test_make_mesh_needs_its_devices(monkeypatch):
    """No silent CPU mesh: without ``devices=`` the mesh is CUDA's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4, devices=["cuda"] * 4)


def _query_world():
    f, _ = _world(8, 8, 12.0, seed=5)
    f["particle_alive"][[7, 20]] = False
    f["pos"][30] = f["pos"][31]                    # a coincident pair
    return f


@pytest.mark.parametrize("mode", ["allpairs", "grid"])
def test_collision_query_matches_jax(mode):
    f = _query_world()
    jst = sim_to_jax(f)
    _, cfg = j_cloth(w=8, h=8, spacing=12.0)
    jc, tc = _cfgs(cfg, collision_mode=mode, collision_tile=16,
                   particle_radius=8.0)
    idx = np.arange(8, 40)
    q_np = (f["pos"][idx], f["vel"][idx], f["particle_alive"][idx])
    ref = jax.jit(jcoll.collision_terms, static_argnames=("cfg",))(
        jst.pos, jst.vel, jst.particle_alive, CONSTS, cfg=jc,
        query=tuple(jax.numpy.asarray(a) for a in q_np)
        + (jax.numpy.asarray(idx, dtype=jax.numpy.int32),))
    st = sim_to_port(f)
    args = (st.pos, st.vel, st.particle_alive, consts_to_port(CONSTS), tc)
    q = tuple(torch.from_numpy(a) for a in q_np) + (torch.from_numpy(idx),)
    got = tcoll.collision_terms(*args, query=q)
    full = tcoll.collision_terms(*args)
    for g, fl, r in zip(got, full, ref):
        assert g.shape[0] == len(idx)
        assert torch.equal(g, fl[8:40])
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert np.abs(np.asarray(ref[0])).max() > 0, "particles collide"


def test_window_rejects_subset_query():
    f = _query_world()
    st = sim_to_port(f)
    _, cfg = j_cloth(w=8, h=8, spacing=12.0)
    _, tc = _cfgs(cfg, collision_mode="window", particle_radius=8.0)
    args = (st.pos, st.vel, st.particle_alive, consts_to_port(CONSTS), tc)
    idx = torch.arange(8, 40)
    with pytest.raises(NotImplementedError, match="full-set queries"):
        tcoll.collision_terms(*args, query=(st.pos[idx], st.vel[idx],
                                            st.particle_alive[idx], idx))
    n = st.pos.shape[0]
    full = tcoll.collision_terms(*args, query=(
        st.pos, st.vel, st.particle_alive, torch.arange(n)))
    for a, b in zip(full, tcoll.collision_terms(*args)):
        assert torch.equal(a, b)


def test_spatial_quantized_bit_exact_against_jax():
    """Collisions off, quantized forces: every particle and beam array
    bit-exact against JAX's sharded frame, beams yielding and breaking
    across shards."""
    f, cfg = _world(8, 8, 25.0, seed=3, vel=10.0)
    jc, tc = _cfgs(cfg, subticks=16, collision_mode="none",
                   force_mode="quantized")
    ref = sim_state_to_numpy(_run_jax_sharded(sim_to_jax(f), jc, 8,
                                              as_written=True))
    got = sim_state_to_numpy(_run_port_sharded(sim_to_port(f), tc, 8))
    for k in ("pos", "vel", "acc") + BEAM_KEYS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["beam_target_length"] != f["beam_target_length"]).any()
    assert got["beam_alive"].sum() < f["beam_alive"].sum(), "beams break"


@pytest.mark.parametrize("mode,force", [("allpairs", "quantized"),
                                        ("grid", "quantized"),
                                        ("allpairs", "segment")])
def test_spatial_matches_jax_and_single_device(mode, force):
    """tests/test_parallel.py:45-67's falling cloth, its tolerances, against
    JAX's sharded frame and the port's single-device frame."""
    jst, cfg = j_cloth(w=8, h=8, spacing=25.0)
    f = sim_state_to_numpy(j_pad(jst, 8))
    jc, tc = _cfgs(cfg, subticks=4, collision_mode=mode, collision_tile=64,
                   force_mode=force)
    ref = sim_state_to_numpy(_run_jax_sharded(sim_to_jax(f), jc, 8))
    got = sim_state_to_numpy(_run_port_sharded(sim_to_port(f), tc, 8))
    one = sim_state_to_numpy(_port_frame(sim_to_port(f), tc))
    for other in (ref, one):
        np.testing.assert_allclose(got["pos"], other["pos"], atol=2e-4)
        np.testing.assert_allclose(got["vel"], other["vel"], atol=5e-4)
        np.testing.assert_array_equal(got["beam_alive"], other["beam_alive"])


def _granular():
    """64 particles 18 apart with radius 10 (every neighbour overlaps) and
    random velocities, no beams."""
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"),
                 -1).reshape(-1, 2)
    pos = (300.0 + 18.0 * g + rng.uniform(-1, 1, g.shape)).astype(np.float32)
    vel = rng.normal(0, 3, g.shape).astype(np.float32)
    f = sim_state_to_numpy(tb.state_from_numpy(pos, vel, max_beams=8,
                                               device="cpu"))
    return {k: None if v is None else v.copy() for k, v in f.items()}


@pytest.mark.parametrize("mode", ["allpairs", "grid"])
def test_spatial_contacts(mode):
    """Slabs colliding across shards through ``query=``: bit-exact against
    the port's single-device frame (each particle sums the same pairs in
    the same order), and against JAX's sharded frame to the collision
    sums' order amplified by a frame of contacts: positions within 0.05
    (5e-5 of the world), velocities within 2e-3 of the largest speed."""
    f = _granular()
    jc, tc = _cfgs(sb.StaticConfig(subticks=16, collision_mode=mode,
                                   collision_tile=16, particle_radius=10.0))
    got = sim_state_to_numpy(_run_port_sharded(sim_to_port(f), tc, 8))
    one = sim_state_to_numpy(_port_frame(sim_to_port(f), tc))
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    ref = sim_state_to_numpy(_run_jax_sharded(sim_to_jax(f), jc, 8))
    vmax = np.abs(ref["vel"]).max()
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=0.05)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0,
                               atol=2e-3 * vmax)
    assert vmax > 50.0, "particles collide"


def test_batched_dp_matches_individual():
    _, cfg = j_cloth(w=6, h=6, spacing=25.0)
    jc, tc = _cfgs(cfg, subticks=4, collision_mode="allpairs",
                   collision_tile=64, force_mode="quantized")
    worlds = [j_cloth(w=6, h=6, spacing=s)[0] for s in (25.0, 30.0)]
    fs = [sim_state_to_numpy(w) for w in worlds]
    jmesh = j_make_mesh(4, dp=4)
    jout = j_batched_frame_fn(jc, jmesh)(
        j_device_put_batched(j_stack([worlds[i % 2] for i in range(4)]),
                             jmesh), CONSTS, UIN)
    refs = [sim_state_to_numpy(s) for s in j_unstack(jout)]
    mesh = _cpu_mesh(4, 4)
    states = [sim_to_port(fs[i % 2]) for i in range(4)]
    out = batched_frame_fn(tc, mesh)(
        device_put_batched(stack_states(states), mesh),
        consts_to_port(CONSTS), uin_to_port(UIN))
    assert len(out) == 4
    for i, got in enumerate(unstack_states(out)):
        one = _port_frame(sim_to_port(fs[i % 2]), tc)
        assert torch.equal(got.pos, one.pos) and torch.equal(got.vel, one.vel)
        np.testing.assert_allclose(got.pos.numpy(), refs[i]["pos"],
                                   atol=1e-5)


def test_dp_times_sp_mesh():
    """2-D dp×sp: a batch of two worlds, each in four slabs."""
    _, cfg = j_cloth(w=6, h=6, spacing=25.0)
    jc, tc = _cfgs(cfg, subticks=16, collision_mode="allpairs",
                   collision_tile=64, force_mode="quantized")
    fs = [jittered(sim_state_to_numpy(j_pad(j_cloth(w=6, h=6, spacing=s)[0],
                                            4)), 9, 1.0, 2.0)
          for s in (25.0, 30.0)]
    for f in fs:
        f["inc_beam"] = f["inc_sign"] = None
    ref = j_unstack(_run_jax_sharded(j_stack([sim_to_jax(f) for f in fs]),
                                     jc, 8, dp_axis="dp"))
    got = unstack_states(_run_port_sharded(
        stack_states([sim_to_port(f) for f in fs]), tc, 8, dp=2,
        dp_axis="dp"))
    for g, r, f in zip(got, ref, fs):
        one = sim_state_to_numpy(_port_frame(sim_to_port(f), tc))
        g = sim_state_to_numpy(g)
        np.testing.assert_allclose(g["pos"], np.asarray(r.pos), atol=2e-4)
        np.testing.assert_allclose(g["pos"], one["pos"], atol=2e-4)
        np.testing.assert_array_equal(g["beam_alive"], one["beam_alive"])


def test_spatial_breakage_across_shards():
    """A beam whose endpoints live on different shards breaks and stops
    pulling (tests/test_parallel.py:116-146's world)."""
    pos = np.array([[300.0, 800.0], [700.0, 800.0]] + [[50.0, 50.0]] * 6,
                   np.float32)
    vel = np.array([[-50.0, 0.0], [50.0, 0.0]] + [[0.0, 0.0]] * 6,
                   np.float32)
    st = tb.state_from_numpy(
        pos, vel=vel, beams=np.array([[0, 1]] * 8),
        beam_spring=np.array([0.04] * 8, np.float32),
        beam_strain_limit=np.array([0.2] * 8, np.float32),
        build_incidence=False, device="cpu")
    tc = tb.StaticConfig(subticks=8, collision_mode="none",
                         force_mode="quantized")
    mesh = _cpu_mesh(8, 1)
    step = spatial_frame_fn(tc, mesh)
    out = shard_state(pad_state_for_mesh(st, 8), mesh)
    for _ in range(4):
        out = step(out, consts_to_port(CONSTS), uin_to_port(UIN))
    got = unshard_state(out)
    assert not bool(got.beam_alive.any())
    one = st
    for _ in range(4):
        one = _port_frame(one, tc)
    assert torch.equal(got.pos, one.pos) and torch.equal(got.vel, one.vel)
