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
    _scalars,
    collide_stencil_call,
    collide_stencil_plain,
    full_offsets,
    offset_terms,
)
from softbody_tpu_torch.ops.stencil import shifted
from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_substep

from test_pallas import perturbed_lattice
from torch_parity import consts_to_port, to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

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


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("stencil", [1, 2])
def test_k3_skip_of_pairs_apart_is_exact(stencil):
    """The facts K3's skip rests on (``csrc/collide_stencil.cu``), on the
    plain version's terms over hostile inputs (signed zeros, coincident
    and touching pairs, infinite and NaN velocities, dead particles
    holding garbage, a far-out alive particle): where a pair's d2 is
    finite and above (2r)² · 1.00001 and both velocities are finite, all
    five terms are ±0; the accumulators never hold −0; so summing with
    those pairs skipped gives the plain sums bit for bit (NaN where
    they are NaN)."""
    ls = _planes(12, 9, seed=6 + stencil, dead_row=4)
    p = to_port(ls)
    rng = np.random.default_rng(stencil)
    pos, vel = p.pos.clone(), p.vel.clone()
    alive = p.alive.clone()
    pos[2, 3] = pos[2, 4]                       # coincident
    pos[7, 2] = pos[7, 3] + torch.tensor([3.0, -4.0])   # touching
    vel[rng.random(vel.shape) < 0.1] = -0.0     # signed zeros
    vel[9, 1, 0] = float("inf")
    vel[1, 7, 1] = float("nan")
    pos[4, :3] = torch.tensor([float("nan"), float("inf")])
    pos[4, 3:6] = torch.tensor([1e30, -0.0])
    pos[10, 8] = torch.tensor([1e20, 5.0])      # alive, d2 overflows
    kw = dict(radius=CFG.particle_radius, dt=CFG.dt, ecoeff=0.6,
              friction=0.3)
    two_r, _ = _scalars(CFG.particle_radius, CFG.dt)
    thr = np.float32(two_r) * np.float32(two_r) * np.float32(1.00001)
    planes = (pos[..., 0], pos[..., 1], vel[..., 0], vel[..., 1], alive)
    vfin = torch.isfinite(vel).all(-1)
    z = torch.zeros_like(planes[0])
    acc, skipped_acc = [z] * 5, [z] * 5
    n_skip = 0
    for dx, dy in full_offsets(stencil):
        d2, terms = offset_terms(*planes, dx, dy, **kw)
        skip = ((d2 > float(thr)) & (d2 <= 3.4028234663852886e38) & vfin
                & shifted(vfin, dx, dy, True))
        n_skip += int(skip.sum())
        for t in terms:
            assert bool((t[skip] == 0).all())
        ops = (torch.sub,) * 4 + (torch.add,)
        acc = [op(a, t) for op, a, t in zip(ops, acc, terms)]
        skipped_acc = [torch.where(skip, a, op(a, t))
                       for op, a, t in zip(ops, skipped_acc, terms)]
        for a in acc:
            assert not bool(((a == 0) & torch.signbit(a)).any())
    assert n_skip > 0
    ref = collide_stencil_plain(*planes, stencil=stencil, **kw)
    assert any(bool(torch.isnan(r).any()) for r in ref)
    for a, s, r in zip(acc, skipped_acc, ref):
        assert torch.equal(torch.isnan(s), torch.isnan(r))
        nan = torch.isnan(r)
        assert torch.equal(_bits(s)[~nan], _bits(r)[~nan])
        assert torch.equal(_bits(a)[~nan], _bits(r)[~nan])


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
