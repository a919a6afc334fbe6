"""One dense-lattice substep: the port's ``lattice_substep`` and the K1
wrapper's plain version against the JAX package's eager
``lattice_substep`` (strict path).

Edge target/last/alive must match bit for bit: both evaluate the same
float32 expressions op by op (eager JAX does not contract into FMAs the
way a whole-program CPU jit does).  Particle planes get pos/vel/acc
atol 1e-4/1e-3/1e-2: ``pow`` and ``sqrt`` may differ by ulps between
XLA's CPU code and torch."""

import numpy as np
import pytest

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, UserInput
from softbody_tpu.models import tearing_cloth_lattice as j_tearing
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.ops.stencil import lattice_substep as j_substep
from softbody_tpu import StaticConfig as JStaticConfig
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    fused_substep2_call,
    pack_lattice2,
    unpack_lattice2,
)
from softbody_tpu_torch.ops.stencil import (
    LatticeSpec,
    lattice_frame,
    lattice_substep,
)
import torch

from torch_parity import (
    assert_states_match,
    consts_to_port,
    far_delta,
    random_state,
    to_jax,
    to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401


def _slit_cloth():
    js, jspec, jcfg, jconsts = j_tearing(
        n_particles=32 * 32, fall_speed=2.5, slits=2, strain_limit=0.22,
        yield_strain=0.18)
    arrays = lattice_state_to_numpy(js)
    # stir it so springs yield/break and particles collide this substep
    rng = np.random.default_rng(5)
    arrays["pos"] = (arrays["pos"] + rng.normal(0.0, 4.0, arrays["pos"].shape)
                     ).astype(np.float32)
    arrays["vel"] = rng.normal(0.0, 20.0, arrays["vel"].shape
                               ).astype(np.float32)
    return arrays, jspec, jcfg, jconsts


def _random_world():
    arrays = random_state(24, 40, seed=11)
    jspec = JLatticeSpec(24, 40, collision_stencil=2)
    jcfg = JStaticConfig(subticks=64, collision_mode="allpairs",
                         particle_radius=4.0)
    consts = PhysicsConstants.default()
    consts.drag_exp = jnp.float32(1.7)
    return arrays, jspec, jcfg, consts


SCENES = {"slit_cloth_32x32": _slit_cloth, "random_24x40": _random_world}


def _random_37x45(stencil, force_mode, seed):
    """A shape that is a multiple of no kernel tile, at another stencil
    radius and force mode."""
    arrays = random_state(37, 45, seed=seed)
    jspec = JLatticeSpec(37, 45, collision_stencil=stencil)
    jcfg = JStaticConfig(subticks=64, collision_mode="allpairs",
                         particle_radius=4.0, force_mode=force_mode)
    return arrays, jspec, jcfg, PhysicsConstants.default()


# the K1 wrapper's plain version also at stencils 1 and 3, on a ragged
# shape, and with float force sums (force_mode "segment")
K1_SCENES = dict(
    SCENES,
    random_37x45_s1=lambda: _random_37x45(1, "quantized", 13),
    random_37x45_s3_float=lambda: _random_37x45(3, "segment", 17),
    random_37x45_s2_float=lambda: _random_37x45(2, "segment", 19),
)


def _port_cfg(jcfg):
    return tb.StaticConfig(
        bounds_size=jcfg.bounds_size, particle_radius=jcfg.particle_radius,
        subticks=jcfg.subticks, collision_mode=jcfg.collision_mode,
        force_mode=jcfg.force_mode)


def _reference(arrays, jspec, jcfg, jconsts, uin, observe, fd):
    ref = j_substep(to_jax(arrays), jconsts, uin, jspec, jcfg,
                    update_observability=observe,
                    far_delta=None if fd is None else jnp.asarray(fd))
    return lattice_state_to_numpy(ref)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("with_far", [False, True])
@pytest.mark.parametrize("observe", [False, True])
def test_lattice_substep_matches_jax(scene, with_far, observe):
    arrays, jspec, jcfg, jconsts = SCENES[scene]()
    uin = UserInput.none()
    w, h = jspec.width, jspec.height
    fd = far_delta(w, h, seed=2) if with_far else None
    ref = _reference(arrays, jspec, jcfg, jconsts, uin, observe, fd)
    got = lattice_substep(
        to_port(to_jax(arrays)), consts_to_port(jconsts), uin_to_port(uin),
        LatticeSpec(w, h, collision_stencil=jspec.collision_stencil),
        _port_cfg(jcfg), update_observability=observe,
        far_delta=None if fd is None else torch.from_numpy(fd))
    assert_states_match(lattice_state_to_numpy(got), ref)


@pytest.mark.parametrize("scene", sorted(K1_SCENES))
@pytest.mark.parametrize("observe", [False, True])
def test_k1_plain_matches_jax(scene, observe):
    """The K1 wrapper on CPU tensors (its plain version) over the packed
    planes, with a far delta and mouse input, against the JAX stencil
    substep."""
    arrays, jspec, jcfg, jconsts = K1_SCENES[scene]()
    uin = UserInput(
        user_strength=jnp.float32(1.5), mouse_active=jnp.asarray(True),
        mouse_pos=jnp.asarray(arrays["pos"][5, 7], jnp.float32),
        mouse_vel=jnp.asarray([3.0, -1.0], jnp.float32),
        applied_force=jnp.asarray([0.25, 0.5], jnp.float32))
    w, h = jspec.width, jspec.height
    fd = far_delta(w, h, seed=4)
    ref = _reference(arrays, jspec, jcfg, jconsts, uin, observe, fd)

    state = to_port(to_jax(arrays))
    hot, obs, immut, ec = pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts_to_port(jconsts),
                                       uin_to_port(uin), _port_cfg(jcfg), h),
                      ec])
    out = fused_substep2_call(hot, immut, cvec,
                              stencil=jspec.collision_stencil,
                              quantized=jcfg.force_mode == "quantized",
                              far=torch.from_numpy(fd),
                              obs_in=obs if observe else None)
    hot2, obs2 = out if observe else (out, obs)
    got = lattice_state_to_numpy(unpack_lattice2(hot2, obs2, state))
    assert_states_match(got, ref, observed=observe)
    if not observe:  # the hot variant leaves the obs planes alone
        for eg, er in zip(got["edges"], arrays["edges"]):
            np.testing.assert_array_equal(eg["strain"], er["strain"])


def test_k1_wrapper_validates_inputs():
    state = to_port(to_jax(random_state(8, 8, seed=0)))
    hot, obs, immut, ec = pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(tb.PhysicsConstants(), tb.UserInput(),
                                       tb.StaticConfig(), 8), ec])
    kw = dict(stencil=2, quantized=True)
    with pytest.raises(ValueError):
        fused_substep2_call(hot[:17], immut, cvec, **kw)
    with pytest.raises(TypeError):
        fused_substep2_call(hot.double(), immut, cvec, **kw)
    with pytest.raises(ValueError):
        fused_substep2_call(hot, immut, cvec[:20], **kw)
    with pytest.raises(ValueError):
        fused_substep2_call(hot.transpose(1, 2).contiguous().transpose(1, 2),
                            immut, cvec, **kw)


def test_lattice_frame_matches_jax():
    """``lattice_frame`` (observing substeps in a loop) against the JAX
    substep applied eagerly as many times; after the first substep ulp
    differences in pow/sqrt feed the edge lengths, so everything is held
    to tolerance, and the alive masks must agree."""
    arrays, jspec, jcfg, jconsts = _slit_cloth()
    uin = UserInput.none()
    ref = to_jax(arrays)
    for _ in range(4):
        ref = j_substep(ref, jconsts, uin, jspec, jcfg)
    ref = lattice_state_to_numpy(ref)
    got = lattice_state_to_numpy(lattice_frame(
        to_port(to_jax(arrays)), consts_to_port(jconsts), uin_to_port(uin),
        LatticeSpec(jspec.width, jspec.height), _port_cfg(jcfg), n_sub=4))
    for k, tol in (("pos", 1e-3), ("vel", 5e-2)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
        np.testing.assert_allclose(eg["target_length"], er["target_length"],
                                   rtol=1e-5, atol=1e-5)
