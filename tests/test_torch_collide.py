"""The collision stencil kernel K3: the port's plain version (what the K3
wrapper runs on CPU tensors) against the JAX package's K3 in interpret
mode and against its XLA stencil, and the port's ``lattice_substep``
with ``use_pallas`` against the JAX package's.

Tolerances:
- against JAX's K3 (interpret mode): the same float32 ops in the same
  order, but XLA's CPU code rounds a few of them differently (measured:
  up to ~8 ulp in dax at |dax| ≈ 230); rtol 1e-5, atol 1e-4, NaN where
  JAX has NaN;
- against the XLA stencil (half offsets, another sum order): the JAX
  package's own rtol 1e-5, atol 1e-3 (tests/test_pallas.py);
- the substep: pos/vel rtol 1e-6, atol 1e-4, as tests/test_pallas.py
  holds K3's substep to the XLA substep."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.ops.pallas.collide_stencil import stencil_collisions_pallas
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.ops.stencil import _stencil_collisions as j_stencil
from softbody_tpu.ops.stencil import lattice_substep_jit
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.ops.cuda import collide_stencil
from softbody_tpu_torch.ops.cuda.collide_stencil import (
    collide_stencil_call,
    collide_stencil_plain,
    full_offsets,
)
from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_substep

from test_pallas import perturbed_lattice
from torch_parity import consts_to_port, to_port, uin_to_port

NAMES = ("dvx", "dvy", "dax", "day", "dyn")
CFG = StaticConfig(subticks=8, particle_radius=10.0)


def _planes(w, h, seed, dead_row=None):
    ls = perturbed_lattice(w, h, seed=seed)
    if dead_row is not None:
        alive = np.ones((w, h), bool)
        alive[dead_row, :] = False
        ls = dataclasses.replace(ls, alive=jnp.asarray(alive))
    return ls


def _port_call(ls, stencil, consts, fn=collide_stencil_call):
    p = to_port(ls)
    return fn(p.pos[..., 0], p.pos[..., 1], p.vel[..., 0], p.vel[..., 1],
              p.alive, radius=CFG.particle_radius, dt=CFG.dt,
              ecoeff=consts.ecoeff, friction=consts.friction,
              stencil=stencil)


def _jax_k3(ls, stencil, consts):
    w, h = ls.shape
    return stencil_collisions_pallas(
        ls.pos[..., 0], ls.pos[..., 1], ls.vel[..., 0], ls.vel[..., 1],
        ls.alive, jnp.float32(CFG.particle_radius), jnp.float32(CFG.dt),
        (consts.elasticity + 1.0) * 0.5, consts.friction,
        w=w, h=h, stencil=stencil, tile_w=8, tile_h=8, interpret=True)


@pytest.mark.parametrize("stencil", [1, 2])
def test_k3_plain_matches_jax_k3_and_xla(stencil):
    """12×9 (two tiles of 8×8 in W, a ragged edge), a dead row."""
    w, h = 12, 9
    ls = _planes(w, h, seed=stencil, dead_row=5)
    consts = PhysicsConstants.default()
    before = collide_stencil.K3_LAUNCHES
    got = _port_call(ls, stencil, consts_to_port(consts))
    assert collide_stencil.K3_LAUNCHES == before  # the CPU runs the plain
    ref_k3 = _jax_k3(ls, stencil, consts)
    ref_xla = j_stencil(ls, consts, JLatticeSpec(w, h,
                                                 collision_stencil=stencil),
                        CFG)
    for name, g, rk, rx in zip(NAMES, got, ref_k3, ref_xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(rk), rtol=1e-5,
                                   atol=1e-4, err_msg=f"{name} vs K3")
        np.testing.assert_allclose(g.numpy(), np.asarray(rx), rtol=1e-5,
                                   atol=1e-3, err_msg=f"{name} vs XLA")
    assert float(np.abs(got[1].numpy()).max()) > 0  # contacts fire
    assert np.abs(got[0].numpy()[5]).sum() == 0.0   # the dead row


def test_k3_plain_nonfinite_masks_like_k3():
    """K3 masks terms by multiplying with ``ovf``: a particle with an
    infinite velocity turns its neighbours' deltas to NaN (a ``where``
    would give 0).  The plain version must do the same."""
    w, h = 12, 9
    ls = _planes(w, h, seed=4)
    vel = np.array(ls.vel)
    vel[6, 4, 0] = np.inf
    ls = dataclasses.replace(ls, vel=jnp.asarray(vel))
    consts = PhysicsConstants.default()
    got = _port_call(ls, 2, consts_to_port(consts))
    ref = _jax_k3(ls, 2, consts)
    assert np.isnan(got[0].numpy()).sum() > 1
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4, equal_nan=True, err_msg=name)


def test_k3_coincident_nudge():
    """Two exactly coincident alive particles: the nudge
    ``sign(lin_i − lin_j)`` lands as ±1 on both."""
    ls = _planes(8, 8, seed=5)
    pos = np.array(ls.pos)
    pos[3, 3] = pos[3, 4]
    ls = dataclasses.replace(ls, pos=jnp.asarray(pos))
    consts = PhysicsConstants.default()
    got = _port_call(ls, 2, consts_to_port(consts))
    ref = _jax_k3(ls, 2, consts)
    assert got[4][3, 3].item() == -1.0 and got[4][3, 4].item() == 1.0
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_k3_wrapper_validates_inputs():
    ls = _planes(8, 8, seed=0)
    consts = consts_to_port(PhysicsConstants.default())
    p = to_port(ls)
    planes = (p.pos[..., 0], p.pos[..., 1], p.vel[..., 0], p.vel[..., 1],
              p.alive)
    kw = dict(radius=10.0, dt=CFG.dt, ecoeff=consts.ecoeff,
              friction=consts.friction)
    with pytest.raises(ValueError):
        collide_stencil_call(*planes, stencil=9, **kw)
    with pytest.raises(ValueError):
        collide_stencil_call(*planes, stencil=0, **kw)
    with pytest.raises(ValueError):
        collide_stencil_call(*planes[:4], p.alive.float(), stencil=2, **kw)
    with pytest.raises(ValueError):
        collide_stencil_call(planes[0].double(), *planes[1:], stencil=2,
                             **kw)
    assert len(full_offsets(2)) == 24 and full_offsets(1)[0] == (-1, -1)
    # the wrapper on CPU tensors is the plain version, bit for bit
    for a, b in zip(collide_stencil_call(*planes, stencil=2, **kw),
                    collide_stencil_plain(*planes, stencil=2, **kw)):
        assert torch.equal(a, b)


def test_lattice_substep_use_pallas_matches_jax():
    """One substep at 10×10 with ``use_pallas`` (collisions through K3's
    plain version here, JAX's K3 in interpret mode there)."""
    w, h = 10, 10
    ls = perturbed_lattice(w, h, spacing=16.0, seed=2)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    cfg = StaticConfig(subticks=8, particle_radius=10.0, use_pallas=True)
    ref = lattice_state_to_numpy(lattice_substep_jit(
        ls, consts, uin, JLatticeSpec(w, h, collision_stencil=2), cfg))
    got = lattice_state_to_numpy(lattice_substep(
        to_port(ls), consts_to_port(consts), uin_to_port(uin),
        LatticeSpec(w, h, collision_stencil=2),
        tb.StaticConfig(subticks=8, particle_radius=10.0, use_pallas=True)))
    for k in ("pos", "vel"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-4,
                                   err_msg=k)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
