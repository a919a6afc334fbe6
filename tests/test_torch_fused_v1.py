"""The per-edge fused substep kernel K4 and its frames: the port's
``pack_lattice``/``fused_frame``/``fused_frame_far`` (K4's plain
version on CPU tensors) against the JAX package's (K4 in interpret
mode), with per-edge varied edge parameters.

Tolerances are the JAX package's own for its K4 against the XLA substep
(tests/test_fused_substep.py: pos rtol 1e-5 atol 1e-3 or 5e-3 with
breakage, vel atol 5e-3, acc rtol 1e-4 atol 5e-2, edge alive bit-exact,
target/last atol 1e-4; tests/test_farfield.py:300 for the far frame:
pos atol 1e-4, vel 1e-3): the port sums collisions in the XLA order,
JAX's K4 in its own.  Strain and stress on alive edges: rtol 1e-4,
atol 1e-4 (they are read off the same lengths and forces)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.ops.pallas import fused_substep as jfs
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.ops.stencil import lattice_substep as j_substep
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.ops.cuda import fused_substep as tfs
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_farfield import FF, RADIUS, hairpin
from test_fused_substep import scene
from torch_parity import (
    assert_states_match,
    consts_to_port,
    random_state,
    to_jax,
    to_port,
    uin_to_port,
    vary_edge_params,
)
from torch_threads import two_torch_threads  # noqa: F401


def _varied(ls, seed):
    """The JAX scene's numpy fields with per-edge varied parameters."""
    return vary_edge_params(lattice_state_to_numpy(ls),
                            np.random.default_rng(seed))


def _port_cfg(cfg):
    return tb.StaticConfig(bounds_size=cfg.bounds_size,
                           particle_radius=cfg.particle_radius,
                           subticks=cfg.subticks,
                           collision_mode=cfg.collision_mode,
                           force_mode=cfg.force_mode)


def _run_both(arrays, spec, cfg, consts, uin):
    js = to_jax(arrays)
    mut, immut = jfs.pack_lattice(js, tile_w=8)
    mut = jfs.fused_frame(mut, immut, consts, uin, spec, cfg, tile_w=8,
                          interpret=True)
    ref = lattice_state_to_numpy(jfs.unpack_lattice(mut, immut, js))
    ts = to_port(js)
    tmut, timm = tfs.pack_lattice(ts)
    before = tfs.K4_LAUNCHES
    tmut = tfs.fused_frame(
        tmut, timm, consts_to_port(consts), uin_to_port(uin),
        LatticeSpec(spec.width, spec.height,
                    collision_stencil=spec.collision_stencil),
        _port_cfg(cfg))
    assert tfs.K4_LAUNCHES == before  # the CPU runs the plain version
    return lattice_state_to_numpy(tfs.unpack_lattice(tmut, timm, ts)), ref


def _assert_edges(got, ref):
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        np.testing.assert_array_equal(eg["alive"], er["alive"],
                                      err_msg=f"class {c} alive")
        for k in ("target_length", "last_length"):
            np.testing.assert_allclose(eg[k], er[k], atol=1e-4,
                                       err_msg=f"class {c} {k}")
        live = er["alive"]
        for k in ("strain", "stress"):
            np.testing.assert_allclose(eg[k][live], er[k][live], rtol=1e-4,
                                       atol=1e-4, err_msg=f"class {c} {k}")


def test_pack_round_trip_matches_jax():
    """Per-edge varied parameters: the port's unpadded stacks equal the
    centre of JAX's padded ones, and unpack gives the state back."""
    arrays = random_state(12, 10, seed=7, varied=True)
    assert np.unique(arrays["edges"][0]["spring"]).size > 1
    js = to_jax(arrays)
    jmut, jimm = jfs.pack_lattice(js, tile_w=8)
    mut, immut = tfs.pack_lattice(to_port(js))
    assert tfs.raw_stacks is tfs.pack_lattice
    assert mut.is_contiguous() and tuple(mut.shape) == (26, 12, 10)
    assert tuple(immut.shape) == (22, 12, 10)
    ctr = (slice(None), slice(jfs.PAD_W, jfs.PAD_W + 12),
           slice(jfs.PAD_H, jfs.PAD_H + 10))
    np.testing.assert_array_equal(mut.numpy(), np.asarray(jmut)[ctr])
    np.testing.assert_array_equal(immut.numpy(), np.asarray(jimm)[ctr])
    back = lattice_state_to_numpy(tfs.unpack_lattice(mut, immut,
                                                     to_port(js)))
    for k in ("pos", "vel", "acc", "alive", "pinned"):
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    for eb, ea in zip(back["edges"], arrays["edges"]):
        for k in ea:
            np.testing.assert_array_equal(eb[k], ea[k], err_msg=k)


@pytest.mark.parametrize("stencil,force_mode", [
    pytest.param(0, "quantized", id="0"),
    pytest.param(2, "quantized", id="2"),
    pytest.param(1, "quantized", id="1"),
    pytest.param(3, "segment", id="3-float"),
])
def test_fused_frame_matches_jax(stencil, force_mode):
    w, h = 12, 10
    arrays = _varied(scene(w, h), seed=stencil)
    spec = JLatticeSpec(w, h, collision_stencil=stencil)
    cfg = StaticConfig(subticks=2, particle_radius=9.0,
                       collision_mode="allpairs" if stencil else "none",
                       force_mode=force_mode)
    got, ref = _run_both(arrays, spec, cfg, PhysicsConstants.default(),
                         UserInput.none())
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=1e-5, atol=5e-3)
    np.testing.assert_allclose(got["acc"], ref["acc"], rtol=1e-4, atol=5e-2)
    _assert_edges(got, ref)


@pytest.mark.parametrize("stencil,force_mode", [
    (1, "quantized"), (3, "segment"), (2, "segment")])
def test_k4_plain_matches_jax_substep(stencil, force_mode):
    """K4's wrapper on CPU tensors (its plain version) on a 37 x 45
    lattice, a multiple of no kernel tile, with per-edge varied
    parameters, against the JAX package's op-by-op stencil substep: edge
    target/last/alive bit-exact (both evaluate the same float32
    expressions op by op; JAX's K4 in interpret mode differs from both by
    a few ulps, whose maximum over this many edges passes the frame
    test's tolerances), particle planes within
    tests/test_torch_substep.py's."""
    w, h = 37, 45
    arrays = random_state(w, h, seed=20 + stencil, varied=True)
    jspec = JLatticeSpec(w, h, collision_stencil=stencil)
    jcfg = StaticConfig(subticks=64, collision_mode="allpairs",
                        particle_radius=4.0, force_mode=force_mode)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    ref = lattice_state_to_numpy(j_substep(
        to_jax(arrays), consts, uin, jspec, jcfg, update_observability=True))
    ts = to_port(to_jax(arrays))
    mut, immut = tfs.pack_lattice(ts)
    cvec = tb.consts_vector(consts_to_port(consts), uin_to_port(uin),
                            _port_cfg(jcfg), h)
    out = tfs.fused_substep_call(mut, immut, cvec, stencil=stencil,
                                 quantized=force_mode == "quantized")
    assert_states_match(
        lattice_state_to_numpy(tfs.unpack_lattice(out, immut, ts)), ref)


def test_fused_frame_breakage_and_user_input():
    w, h = 16, 8
    arrays = _varied(scene(w, h, spacing=20.0, seed=3, strain_limit=0.03),
                     seed=5)
    spec = JLatticeSpec(w, h, collision_stencil=1)
    cfg = StaticConfig(subticks=4, particle_radius=8.0)
    uin = UserInput.none()
    uin.mouse_active = jnp.asarray(True)
    uin.mouse_pos = jnp.asarray([200.0, 900.0], jnp.float32)
    uin.mouse_vel = jnp.asarray([30.0, 0.0], jnp.float32)
    uin.applied_force = jnp.asarray([0.2, 0.1], jnp.float32)
    got, ref = _run_both(arrays, spec, cfg, PhysicsConstants.default(), uin)
    broke = sum(int((~e["alive"]).sum()) for e in got["edges"])
    assert broke > 0
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-5, atol=5e-3)
    _assert_edges(got, ref)


def test_fused_frame_far_matches_jax():
    """The folded strip (tests/test_farfield.py:300 pattern), per-edge
    varied springs: the far lists differ in chunk grid (JAX builds it on
    its padded planes), but every pair in reach is in both."""
    ls = hairpin(spring=5.0)
    w, h = ls.shape
    arrays = _varied(ls, seed=9)
    spec = JLatticeSpec(w, h, collision_stencil=2)
    cfg = StaticConfig(subticks=2, collision_mode="allpairs",
                       particle_radius=RADIUS, force_mode="quantized")
    consts, uin = PhysicsConstants.default(), UserInput.none()
    ff = dataclasses.replace(FF, skin=8.0)

    js = to_jax(arrays)
    mut, immut = jfs.pack_lattice(js, tile_w=8)
    fl = jfs.rebuild_far_list_packed(mut, immut, s=2, ff=ff, radius=RADIUS)
    mut = jfs.fused_frame_far(mut, immut, fl, consts, uin, spec, cfg, ff,
                              tile_w=8, interpret=True)
    ref = lattice_state_to_numpy(jfs.unpack_lattice(mut, immut, js))

    tff = FarFieldSpec(max_pairs=ff.max_pairs,
                       max_tile_pairs=ff.max_tile_pairs, skin=ff.skin)
    ts = to_port(js)
    tmut, timm = tfs.pack_lattice(ts)
    tfl = tfs.rebuild_far_list_packed(tmut, timm, s=2, ff=tff, radius=RADIUS)
    assert tfl.counts()[0] > 0 and tfl.counts()[1] == 0
    tmut = tfs.fused_frame_far(tmut, timm, tfl, consts_to_port(consts),
                               uin_to_port(uin), LatticeSpec(w, h),
                               _port_cfg(cfg), tff)
    got = lattice_state_to_numpy(tfs.unpack_lattice(tmut, timm, ts))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=1e-3)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])

    # the rebuild trigger's inputs agree too
    jd, jv = jfs.packed_far_motion(mut, immut, fl)
    td, tv = tfs.packed_far_motion(tmut, timm, tfl)
    np.testing.assert_allclose([float(td), float(tv)],
                               [float(jd), float(jv)], rtol=1e-5, atol=1e-5)


def test_k4_wrapper_validates_inputs():
    arrays = random_state(8, 8, seed=0, varied=True)
    mut, immut = tfs.pack_lattice(to_port(to_jax(arrays)))
    cvec = tb.consts_vector(tb.PhysicsConstants(), tb.UserInput(),
                            tb.StaticConfig(), 8)
    kw = dict(stencil=2, quantized=True)
    with pytest.raises(ValueError):
        tfs.fused_substep_call(mut[:25], immut, cvec, **kw)
    with pytest.raises(ValueError):
        tfs.fused_substep_call(mut, immut[:21], cvec, **kw)
    with pytest.raises(TypeError):
        tfs.fused_substep_call(mut.double(), immut, cvec, **kw)
    with pytest.raises(ValueError):
        tfs.fused_substep_call(mut, immut, torch.cat([cvec, cvec]), **kw)
    with pytest.raises(ValueError):
        tfs.fused_substep_call(mut, immut, cvec, stencil=9, quantized=True)
    with pytest.raises(ValueError):
        tfs.fused_substep_call(mut, immut, cvec, far=torch.zeros(4, 8, 8),
                               **kw)
    # the wrapper on CPU tensors is the plain version, bit for bit
    assert torch.equal(tfs.fused_substep_call(mut, immut, cvec, **kw),
                       tfs.fused_substep_plain(mut, immut, cvec, **kw))


def test_fused_frames_jit_match_jax():
    """The compiled path-B frames, which run their functions on CPU
    tensors, against JAX's jitted frames: ``fused_frame_jit`` on the
    scene of ``test_fused_frame_breakage_and_user_input`` (the mouse
    grabbing, a keyboard force; its tolerances), ``fused_frame_far_jit``
    and ``packed_far_motion_jit`` on the folded strip (those of
    ``test_fused_frame_far_matches_jax``)."""
    w, h = 16, 8
    arrays = _varied(scene(w, h, spacing=20.0, seed=3, strain_limit=0.03),
                     seed=5)
    spec = JLatticeSpec(w, h, collision_stencil=1)
    cfg = StaticConfig(subticks=4, particle_radius=8.0)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    uin.mouse_active = jnp.asarray(True)
    uin.mouse_pos = jnp.asarray([200.0, 900.0], jnp.float32)
    uin.mouse_vel = jnp.asarray([30.0, 0.0], jnp.float32)
    uin.applied_force = jnp.asarray([0.2, 0.1], jnp.float32)
    js = to_jax(arrays)
    mut, immut = jfs.pack_lattice(js, tile_w=8)
    mut = jfs.fused_frame(mut, immut, consts, uin, spec, cfg, tile_w=8,
                          interpret=True)
    ref = lattice_state_to_numpy(jfs.unpack_lattice(mut, immut, js))
    ts = to_port(js)
    tmut, timm = tfs.pack_lattice(ts)
    tmut = tfs.fused_frame_jit(tmut, timm, consts_to_port(consts),
                               uin_to_port(uin), LatticeSpec(w, h, 1),
                               _port_cfg(cfg))
    got = lattice_state_to_numpy(tfs.unpack_lattice(tmut, timm, ts))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-5, atol=5e-3)
    _assert_edges(got, ref)

    ls = hairpin(spring=5.0)
    w, h = ls.shape
    arrays = _varied(ls, seed=9)
    spec = JLatticeSpec(w, h, collision_stencil=2)
    cfg = StaticConfig(subticks=2, collision_mode="allpairs",
                       particle_radius=RADIUS, force_mode="quantized")
    consts, uin = PhysicsConstants.default(), UserInput.none()
    ff = dataclasses.replace(FF, skin=8.0)
    js = to_jax(arrays)
    mut, immut = jfs.pack_lattice(js, tile_w=8)
    fl = jfs.rebuild_far_list_packed(mut, immut, s=2, ff=ff, radius=RADIUS)
    mut = jfs.fused_frame_far(mut, immut, fl, consts, uin, spec, cfg, ff,
                              tile_w=8, interpret=True)
    ref = lattice_state_to_numpy(jfs.unpack_lattice(mut, immut, js))
    tff = FarFieldSpec(max_pairs=ff.max_pairs,
                       max_tile_pairs=ff.max_tile_pairs, skin=ff.skin)
    ts = to_port(js)
    tmut, timm = tfs.pack_lattice(ts)
    tfl = tfs.rebuild_far_list_packed(tmut, timm, s=2, ff=tff, radius=RADIUS)
    tmut = tfs.fused_frame_far_jit(tmut, timm, tfl, consts_to_port(consts),
                                   uin_to_port(uin), LatticeSpec(w, h),
                                   _port_cfg(cfg), tff)
    got = lattice_state_to_numpy(tfs.unpack_lattice(tmut, timm, ts))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=1e-3)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
    jd, jv = jfs.packed_far_motion(mut, immut, fl)
    td, tv = tfs.packed_far_motion_jit(tmut, timm, tfl)
    np.testing.assert_allclose([float(td), float(tv)],
                               [float(jd), float(jv)], rtol=1e-5, atol=1e-5)
