"""The port's sharded dense lattice (``parallel/lattice_spatial.py``: a
halo exchange of ghost columns, then ``lattice_substep`` on each slab,
kernel K3's plain version under ``use_pallas``) against the JAX
package's ``lattice_spatial_frame_fn`` on its 8 virtual CPU devices, and
against the port's own single-device ``lattice_frame``: the counterparts
of tests/test_lattice_spatial.py.

- Against the port's single-device frame every plane is bit-exact: each
  cell's terms are evaluated from the same values in the same order.
- Against JAX's sharded frame: edge ``alive`` bit-exact, positions and
  velocities within tests/test_lattice_spatial.py's own tolerances
  against one device (pos atol 2e-4, vel 5e-4); the port sums collision
  offsets in the XLA order, JAX's jitted frame contracts some of them
  into fused multiply-adds."""

import dataclasses

import numpy as np
import pytest

import jax

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.models import cloth_lattice as j_cloth_lattice
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.parallel import make_mesh as j_make_mesh
from softbody_tpu.parallel.lattice_spatial import (
    lattice_spatial_frame_fn as j_frame_fn,
    shard_lattice as j_shard,
)
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_frame
from softbody_tpu_torch.parallel import make_mesh
from softbody_tpu_torch.parallel.lattice_spatial import (
    lattice_spatial_frame_fn,
    shard_lattice,
    unshard_lattice,
)

from torch_parity import consts_to_port, to_jax, to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CONSTS, UIN = PhysicsConstants.default(), UserInput.none()


def scene(w=32, h=12, spacing=18.0):
    """tests/test_lattice_spatial.py's cloth as numpy fields."""
    ls, _, _ = j_cloth_lattice(w=w, h=h, spacing=spacing)
    f = lattice_state_to_numpy(ls)
    f["vel"] = np.random.default_rng(0).normal(0, 6, (w, h, 2)).astype(
        np.float32)
    return f


def _port_cfg(cfg):
    return tb.StaticConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(tb.StaticConfig)})


def _run(f, w, h, stencil, cfg, n_dev, frames):
    """(port sharded, port single, JAX sharded) numpy fields."""
    tc = _port_cfg(cfg)
    spec = LatticeSpec(w, h, collision_stencil=stencil)
    consts, uin = consts_to_port(CONSTS), uin_to_port(UIN)
    mesh = make_mesh(n_dev, dp=1, devices=["cpu"] * n_dev)
    step = lattice_spatial_frame_fn(spec, tc, mesh)
    out = shard_lattice(to_port(to_jax(f)), mesh)
    one = to_port(to_jax(f))
    for _ in range(frames):
        out = step(out, consts, uin)
        one = lattice_frame(one, consts, uin, spec, tc)
    jmesh = j_make_mesh(n_dev, dp=1)
    jstep = j_frame_fn(JLatticeSpec(w, h, collision_stencil=stencil), cfg,
                       jmesh, donate=False)
    ref = j_shard(to_jax(f), jmesh)
    jstep = jstep.lower(ref, CONSTS, UIN).compile(compiler_options={
        "xla_disable_hlo_passes": "fusion,algsimp"})
    for _ in range(frames):
        ref = jstep(ref, CONSTS, UIN)
    return (lattice_state_to_numpy(unshard_lattice(out)),
            lattice_state_to_numpy(one), lattice_state_to_numpy(ref))


def _assert_equal(got, one):
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    for c, (eg, eo) in enumerate(zip(got["edges"], one["edges"])):
        for k in eg:
            np.testing.assert_array_equal(eg[k], eo[k], err_msg=f"{c} {k}")


@pytest.mark.parametrize("stencil,use_pallas", [(0, False), (2, False),
                                                (2, True)])
def test_sharded_matches_single_and_jax(stencil, use_pallas):
    w, h = 32, 12
    cfg = StaticConfig(subticks=4, particle_radius=10.0,
                       collision_mode="allpairs" if stencil else "none",
                       use_pallas=use_pallas)
    got, one, ref = _run(scene(w, h), w, h, stencil, cfg, 8, 3)
    _assert_equal(got, one)
    np.testing.assert_allclose(got["pos"], ref["pos"], atol=2e-4)
    np.testing.assert_allclose(got["vel"], ref["vel"], atol=5e-4)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def test_sharded_tearing_across_boundary():
    """Edges crossing slab boundaries break as on one device and as in
    JAX's sharded frame (tests/test_lattice_spatial.py:57-80's world)."""
    w, h = 16, 8
    f = scene(w, h, spacing=22.0)
    f["vel"] = f["vel"] * np.float32(4.0)
    for e in f["edges"]:
        e["strain_limit"] = np.full((w, h), 0.02, np.float32)
    cfg = StaticConfig(subticks=8, particle_radius=9.0)
    got, one, ref = _run(f, w, h, 1, cfg, 4, 1)
    _assert_equal(got, one)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
    full = sum(int(e["alive"].sum()) for e in f["edges"])
    assert sum(int(e["alive"].sum()) for e in got["edges"]) < full


def test_slab_checks():
    tc = tb.StaticConfig(subticks=4)
    mesh = make_mesh(8, dp=1, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible by 8"):
        lattice_spatial_frame_fn(LatticeSpec(36, 8), tc, mesh)
    with pytest.raises(ValueError, match="slab too narrow"):
        lattice_spatial_frame_fn(LatticeSpec(24, 8, collision_stencil=2),
                                 tc, mesh)
