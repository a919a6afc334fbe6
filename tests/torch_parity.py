"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py): the same numpy inputs go through
both packages."""

import numpy as np

import jax.numpy as jnp

from softbody_tpu.ops.stencil import EdgeClass as JEdgeClass
from softbody_tpu.ops.stencil import LatticeState as JLatticeState
from softbody_tpu_torch.convert import (
    constants_from_numpy,
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    user_input_from_numpy,
)


def to_port(jstate, device="cpu"):
    """JAX LatticeState → port LatticeState (through numpy)."""
    return lattice_state_from_numpy(**lattice_state_to_numpy(jstate),
                                    device=device)


def to_jax(arrays: dict) -> JLatticeState:
    """numpy fields (``lattice_state_to_numpy`` layout) → JAX state."""
    return JLatticeState(
        pos=jnp.asarray(arrays["pos"]), vel=jnp.asarray(arrays["vel"]),
        acc=jnp.asarray(arrays["acc"]), alive=jnp.asarray(arrays["alive"]),
        pinned=jnp.asarray(arrays["pinned"]),
        edges=tuple(JEdgeClass(**{k: jnp.asarray(v) for k, v in e.items()})
                    for e in arrays["edges"]),
    )


def consts_to_port(c):
    return constants_from_numpy(
        np.asarray(c.gravity), np.asarray(c.border_elasticity),
        np.asarray(c.border_friction), np.asarray(c.elasticity),
        np.asarray(c.friction), np.asarray(c.drag_coeff),
        np.asarray(c.drag_exp))


def uin_to_port(u):
    return user_input_from_numpy(
        np.asarray(u.user_strength), np.asarray(u.mouse_active),
        np.asarray(u.mouse_pos), np.asarray(u.mouse_vel),
        np.asarray(u.applied_force))


def vary_edge_params(arrays: dict, rng) -> dict:
    """Per-edge varied spring, damp, yield, limit and length (target and
    last lengths scale with the length), in place on numpy fields."""
    for e in arrays["edges"]:
        n = e["length"].shape
        scale = rng.uniform(0.9, 1.1, n).astype(np.float32)
        for k in ("length", "target_length", "last_length"):
            e[k] = (e[k] * scale).astype(np.float32)
        e["spring"] = (e["spring"] * rng.uniform(0.5, 1.5, n)
                       ).astype(np.float32)
        e["damp"] = (e["damp"] * rng.uniform(0.5, 1.5, n)).astype(np.float32)
        e["yield_strain"] = (e["yield_strain"] * rng.uniform(0.5, 1.5, n)
                             ).astype(np.float32)
        e["strain_limit"] = (e["strain_limit"] * rng.uniform(0.5, 1.5, n)
                             ).astype(np.float32)
    return arrays


def random_state(w, h, seed, spacing=10.0, jitter=3.0, varied=False):
    """numpy fields of a jittered, partly dead, partly yielded lattice:
    particles overlap (radius 4 at spacing 10), some edges yield and some
    break in one substep.  Edge parameters are uniform per class, or
    with ``varied`` per-edge (:func:`vary_edge_params`)."""
    from softbody_tpu.models import make_lattice

    rng = np.random.default_rng(seed)
    base = lattice_state_to_numpy(make_lattice(
        w, h, spacing, spring=120.0, damp=10.0, yield_strain=0.05,
        strain_limit=0.2))
    base["pos"] = (base["pos"] + rng.uniform(-jitter, jitter, (w, h, 2))
                   ).astype(np.float32)
    base["vel"] = rng.normal(0.0, 8.0, (w, h, 2)).astype(np.float32)
    base["acc"] = rng.normal(0.0, 1.0, (w, h, 2)).astype(np.float32)
    base["alive"] = rng.random((w, h)) > 0.05
    base["pinned"] = rng.random((w, h)) < 0.05
    # two exactly coincident particles (the nudge path)
    base["pos"][3, 3] = base["pos"][3, 4]
    for e in base["edges"]:
        n = (w, h)
        e["target_length"] = (e["length"] * rng.uniform(0.9, 1.1, n)
                              ).astype(np.float32)
        e["last_length"] = (e["length"] * rng.uniform(0.9, 1.1, n)
                            ).astype(np.float32)
        e["alive"] = e["alive"] & (rng.random(n) > 0.1)
        e["strain"] = rng.random(n).astype(np.float32)
        e["stress"] = rng.random(n).astype(np.float32)
    return vary_edge_params(base, rng) if varied else base


def far_delta(w, h, seed):
    return (np.random.default_rng(seed).normal(0.0, 0.5, (5, w, h))
            .astype(np.float32))


def assert_states_match(got, ref, *, pos=1e-4, vel=1e-3, acc=1e-2,
                        observed=True):
    """Port state ``got`` against JAX state ``ref`` (numpy dicts): edge
    target/last/alive bit-exact, particle planes within the given atol,
    strain/stress (when ``observed``) to float tolerance on alive edges."""
    for k, tol in (("pos", pos), ("vel", vel), ("acc", acc)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        for k in ("target_length", "last_length", "alive"):
            np.testing.assert_array_equal(eg[k], er[k],
                                          err_msg=f"class {c} {k}")
        if observed:
            live = er["alive"]
            for k in ("strain", "stress"):
                np.testing.assert_allclose(eg[k][live], er[k][live],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"class {c} {k}")


def sim_to_jax(fields: dict):
    """numpy fields (``sim_state_to_numpy`` layout) → JAX ``SimState``."""
    from softbody_tpu.state import SimState as JSimState

    return JSimState(**{k: None if v is None else jnp.asarray(v)
                        for k, v in fields.items()})


def sim_to_port(fields: dict, device="cpu"):
    """numpy fields → port ``SimState`` on ``device``."""
    from softbody_tpu_torch.convert import sim_state_from_numpy

    return sim_state_from_numpy(**fields, device=device)


def jittered(fields: dict, seed: int, pos_jitter: float, vel_scale: float):
    """A copy of numpy state fields with uniform position jitter and
    normal velocities, both from ``seed``."""
    rng = np.random.default_rng(seed)
    out = dict(fields)
    shape = fields["pos"].shape
    out["pos"] = (fields["pos"] + rng.uniform(-pos_jitter, pos_jitter, shape)
                  ).astype(np.float32)
    out["vel"] = rng.normal(0.0, vel_scale, shape).astype(np.float32)
    return out
