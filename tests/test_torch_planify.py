"""The port's planified path (``softbody_tpu_torch/ops/planify.py``)
against the JAX package's, on the CPU at small sizes: ``cloth(12, 12)``,
``multi_blob(4)``, the long-beam scene and the flat strip of
tests/test_planify.py (its far-armed fold: tests/test_torch_planify_far.py).

- The embedding (maps, spec, planes, exception list) bit-exact.
- Substeps from one JAX ``PlanifiedState`` carried across
  (``convert.planified_state_from_numpy``), against JAX's EAGER
  ``planified_substep`` (a jitted JAX frame rounds a few sums
  otherwise): with quantized forces and collisions off the edge and
  exception state bit-exact, particle planes within
  ``torch_parity.assert_states_match``'s defaults; with collisions on,
  tests/test_torch_lattice_backend.py's pos atol 5e-3, vel atol 5e-2;
  K3's plain version against JAX's K3 in interpret mode to rtol 1e-5 /
  atol 1e-4 (tests/test_torch_collide.py)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.models import cloth, multi_blob
from softbody_tpu.models.scenes import _build as j_build
from softbody_tpu.ops import planify as jplanify
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    planified_state_from_numpy,
    planified_state_to_numpy,
    sim_state_to_numpy,
)
from softbody_tpu_torch.ops import planify as tplanify

from torch_parity import (
    assert_states_match,
    consts_to_port,
    sim_to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

CONSTS, UIN = PhysicsConstants.default(), UserInput.none()


def _long_beams():
    """tests/test_planify.py:163-200: two 800-unit beams pulled apart
    (they must break) and two short ones (they must not)."""
    pos = np.array([[100.0, 500.0], [900.0, 500.0],
                    [100.0, 520.0], [900.0, 520.0]], np.float32)
    beams = np.array([[0, 1], [2, 3], [0, 2], [1, 3]], np.int32)
    lengths = np.linalg.norm(pos[beams[:, 0]] - pos[beams[:, 1]],
                             axis=1).astype(np.float32)
    props = {"spring": np.full(4, 1.0, np.float32),
             "damp": np.full(4, 0.1, np.float32),
             "yield_strain": np.full(4, 10.0, np.float32),
             "strain_limit": np.full(4, 0.01, np.float32)}
    vel = np.zeros((4, 2), np.float32)
    vel[0] = vel[2] = (-50.0, 0.0)
    vel[1] = vel[3] = (50.0, 0.0)
    return dataclasses.replace(j_build(pos, beams, lengths, props),
                               vel=jnp.asarray(vel))


NX, NY, SP = 24, 2, 12.0


def _flat_strip():
    """tests/test_planify.py:211-233: a flat 24 × 2 strip, spacing 12."""
    pos = np.array([[100.0 + i * SP, 500.0 + j * SP]
                    for i in range(NX) for j in range(NY)], np.float32)
    beams = []
    for i in range(NX):
        for j in range(NY):
            p = i * NY + j
            if i + 1 < NX:
                beams.append([p, p + NY])
            if j + 1 < NY:
                beams.append([p, p + 1])
    beams = np.asarray(beams, np.int32)
    lengths = np.linalg.norm(pos[beams[:, 0]] - pos[beams[:, 1]],
                             axis=1).astype(np.float32)
    m = len(beams)
    props = {"spring": np.full(m, 50.0, np.float32),
             "damp": np.full(m, 5.0, np.float32),
             "yield_strain": np.full(m, 10.0, np.float32),
             "strain_limit": np.full(m, 10.0, np.float32)}
    return j_build(pos, beams, lengths, props)


def _jittered(js, seed):
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 10, np.asarray(js.vel).shape).astype(np.float32)
    return dataclasses.replace(js, vel=jnp.asarray(vel))


SCENES = {
    "cloth": (lambda: _jittered(cloth(w=12, h=12, spacing=20.0)[0], 3),
              dict(collision_stencil=4)),
    "blobs": (lambda: _jittered(multi_blob(n_blobs=4,
                                           blob_radius=30.0)[0], 4),
              dict(collision_stencil=4, chunk_multiple=16)),
    "long_beams": (_long_beams, dict(dense_reach=1)),
    "strip": (_flat_strip, dict(collision_stencil=3, chunk_multiple=16)),
}


def _both(name):
    """The scene embedded by both packages: ``(jax (ps, spec, aux), port
    (ps, spec, aux), port flat state)``."""
    build, kw = SCENES[name]
    js = build()
    ts = sim_to_port(sim_state_to_numpy(js))
    return jplanify.planify(js, **kw), tplanify.planify(ts, **kw), ts


def _equal_fields(got: dict, ref: dict, label: str):
    for k, v in ref.items():
        if isinstance(v, list):
            for c, (eg, er) in enumerate(zip(got[k], v)):
                _equal_fields(eg, er, f"{label} {k}[{c}]")
        elif isinstance(v, dict):
            _equal_fields(got[k], v, f"{label} {k}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{label} {k}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_planify_matches_jax(name):
    """Maps, spec and every plane and exception field bit-exact; the
    port's ``unplanify ∘ planify`` is the identity."""
    (jps, jspec, jaux), (tps, tspec, taux), ts = _both(name)
    assert (tspec.width, tspec.height, tspec.edge_offsets,
            tspec.collision_stencil) == (jspec.width, jspec.height,
                                         jspec.edge_offsets,
                                         jspec.collision_stencil)
    for k in ("cell_of", "beam_class", "beam_cell"):
        np.testing.assert_array_equal(getattr(taux, k), getattr(jaux, k),
                                      err_msg=k)
    assert taux.n_exceptions == jaux.n_exceptions
    if name == "long_beams":
        assert taux.n_exceptions >= 2, "long beams should not embed densely"
    _equal_fields(planified_state_to_numpy(tps),
                  planified_state_to_numpy(jps), name)
    back = sim_state_to_numpy(tplanify.unplanify(tps, ts, taux))
    _equal_fields(back, sim_state_to_numpy(ts), "round trip")


def _substeps(name, collide, use_pallas=False, n=2):
    """``n`` eager substeps of both packages from one JAX embedding (with
    collisions at a radius that makes mesh neighbours overlap)."""
    (jps, spec, _aux), (_tps, tspec, _taux), _ts = _both(name)
    kw = dict(subticks=8, collision_mode="allpairs" if collide else "none",
              particle_radius=10.5 if collide else 8.0,
              force_mode="quantized", use_pallas=use_pallas)
    tps = planified_state_from_numpy(**planified_state_to_numpy(jps),
                                     device="cpu")
    for _ in range(n):
        jps = jplanify.planified_substep(jps, CONSTS, UIN, spec,
                                         StaticConfig(**kw))
        tps = tplanify.planified_substep(tps, consts_to_port(CONSTS),
                                         uin_to_port(UIN), tspec,
                                         tb.StaticConfig(**kw))
    return planified_state_to_numpy(tps), planified_state_to_numpy(jps)


@pytest.mark.parametrize("name", ["blobs", "cloth", "long_beams"])
def test_planified_substeps_match_jax(name):
    """Quantized, collisions off: the exception pass's int32 planes enter
    one integer sum, so edge and exception state are bit-exact."""
    got, ref = _substeps(name, collide=False)
    assert_states_match(got["lat"], ref["lat"])
    _equal_fields(got["x"], ref["x"], "exceptions")


@pytest.mark.parametrize("name", ["blobs", "cloth"])
def test_planified_substeps_with_collisions_match_jax(name):
    """Collisions through the half-offset stencil."""
    got, ref = _substeps(name, collide=True)
    np.testing.assert_allclose(got["lat"]["pos"], ref["lat"]["pos"], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got["lat"]["vel"], ref["lat"]["vel"], rtol=0,
                               atol=5e-2)
    _equal_fields(got["x"], ref["x"], "exceptions")


def test_planified_substep_k3_matches_jax_interpret():
    """``use_pallas``: K3's plain version (full offsets) against JAX's K3
    in interpret mode, one substep of the blobs."""
    got, ref = _substeps("blobs", collide=True, use_pallas=True, n=1)
    for k, atol in (("pos", 1e-4), ("vel", 1e-4)):
        np.testing.assert_allclose(got["lat"][k], ref["lat"][k], rtol=1e-5,
                                   atol=atol, err_msg=k)


def test_exception_beams_break():
    """The long beams break through the exception pass and surface in
    ``unplanify``; the short ones hold (compute.wgsl:117-121)."""
    _j, (ps, spec, aux), ts = _both("long_beams")
    cfg = tb.StaticConfig(subticks=8, collision_mode="none",
                          particle_radius=5.0, force_mode="quantized")
    ps = tplanify.planified_frame(ps, tb.PhysicsConstants(), tb.UserInput(),
                                  spec, cfg)
    alive = tplanify.unplanify(ps, ts, aux).beam_alive.numpy()[:4]
    assert not alive[0] and not alive[1], f"long beams did not break: {alive}"
    assert alive[2] and alive[3], f"short beams broke: {alive}"
