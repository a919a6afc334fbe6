"""The dense stencil backend: the port's ``LatticeBackend`` (Verlet
trigger, detection-only count, bucket crop, ``lattice_frame_far``; K3's
plain version with ``use_pallas``) against the JAX package's
``LatticeBackend`` on the folded strip, and the device rule of the
port's entry points.

Far stats must be equal.  The state is held to the tolerances of the
fused backend's parity test (tests/test_torch_frame.py, from
tests/test_fused4.py:136-139: pos atol 5e-3, vel atol 5e-2): the far
apply sums in another f32 order."""

import numpy as np
import pytest
import torch

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.engine.backends import LatticeBackend as JLatticeBackend
from softbody_tpu.models import make_lattice as j_make_lattice
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.farfield import rebuild_far_list as j_rebuild
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.ops.stencil import lattice_frame_far_jit
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    lattice_state_from_numpy,
    lattice_state_to_numpy,
)
from softbody_tpu_torch.engine import (
    FusedLatticeBackend,
    LatticeBackend,
    PlanifiedBackend,
)
from softbody_tpu_torch.models import (
    cloth_lattice,
    make_lattice,
    tearing_cloth_lattice,
)
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    empty_far_list,
    rebuild_far_list,
)
from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_frame_far

from test_farfield import RADIUS, hairpin
from torch_parity import (
    consts_to_port,
    random_state,
    to_jax,
    to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

FF = dict(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)


def _cfgs(use_pallas):
    kw = dict(subticks=8, collision_mode="allpairs", particle_radius=RADIUS,
              force_mode="quantized", use_pallas=use_pallas)
    return StaticConfig(**kw), tb.StaticConfig(**kw)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_backend_matches_jax_lattice_backend(use_pallas):
    """Two frames of the folded strip through both backends' ``step``."""
    ls = hairpin()
    w, h = ls.shape
    state = to_port(ls)  # before JAX's frame donates ``ls``
    jcfg, tcfg = _cfgs(use_pallas)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    jbe = JLatticeBackend(JLatticeSpec(w, h, collision_stencil=2), jcfg,
                          farfield=JFarFieldSpec(**FF))
    ref = ls
    for _ in range(2):
        ref = jbe.step(ref, consts, uin)
    ref = lattice_state_to_numpy(ref)

    be = LatticeBackend(LatticeSpec(w, h, collision_stencil=2), tcfg,
                        farfield=FarFieldSpec(**FF), device="cpu")
    for _ in range(2):
        state = be.step(state, consts_to_port(consts), uin_to_port(uin))
    got = lattice_state_to_numpy(state)

    assert be.far_stats() == jbe.far_stats()
    assert be.far_stats()["far_pairs"] > 0, "the fold must yield far pairs"
    assert be.far_stats()["far_overflow"] == 0
    assert be.far_chunks == jbe.far_chunks
    assert np.isfinite(got["pos"]).all()
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
    n_beams = sum(int(e["alive"].sum()) for e in ref["edges"])
    assert be.counts(state) == (int(ref["alive"].sum()), n_beams)


def test_backend_flat_lattice_skips_compaction():
    """An unfolded lattice with jittered velocities: every rebuild is
    found empty by the detection-only count, and the frames stay
    near-field only; the same stats and chunks as JAX's backend."""
    w, h = 16, 16
    arrays = lattice_state_to_numpy(j_make_lattice(w, h, 10.0, spring=5.0,
                                                   damp=0.0))
    arrays["vel"] = np.random.default_rng(1).normal(
        0.0, 2.0, (w, h, 2)).astype(np.float32)
    jcfg, tcfg = _cfgs(False)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    jbe = JLatticeBackend(JLatticeSpec(w, h), jcfg,
                          farfield=JFarFieldSpec(**FF))
    js = to_jax(arrays)
    ts = to_port(js)
    be = LatticeBackend(LatticeSpec(w, h), tcfg, farfield=FarFieldSpec(**FF),
                        device="cpu")
    for _ in range(2):
        js = jbe.step(js, consts, uin)
        ts = be.step(ts, consts_to_port(consts), uin_to_port(uin))
    assert be.far_stats() == jbe.far_stats()
    assert be.far_stats()["far_pairs"] == 0
    assert be.far_rebuilds > 1 and be.far_chunks == jbe.far_chunks
    assert be._far_active is None
    np.testing.assert_allclose(lattice_state_to_numpy(ts)["pos"],
                               np.asarray(js.pos), rtol=0, atol=5e-3)


def test_lattice_frame_far_matches_jax():
    """A frame with one fixed list (tests/test_farfield.py:210 pattern)."""
    ls = hairpin()
    w, h = ls.shape
    jcfg, tcfg = _cfgs(False)
    consts, uin = PhysicsConstants.default(), UserInput.none()
    ff = dict(FF, skin=8.0)
    ts = to_port(ls)  # before JAX's frame donates ``ls``
    jfl = j_rebuild(ls.pos, ls.alive, s=2, ff=JFarFieldSpec(**ff),
                    radius=RADIUS)
    ref = lattice_frame_far_jit(ls, jfl, consts, uin,
                                JLatticeSpec(w, h, collision_stencil=2),
                                jcfg, JFarFieldSpec(**ff))
    tfl = rebuild_far_list(ts.pos, ts.alive, s=2, ff=FarFieldSpec(**ff),
                           radius=RADIUS)
    got = lattice_frame_far(ts, tfl, consts_to_port(consts),
                            uin_to_port(uin), LatticeSpec(w, h), tcfg,
                            FarFieldSpec(**ff))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel), rtol=0,
                               atol=1e-3)


def test_backend_rejects_state_on_other_device():
    ls = hairpin()
    _jcfg, tcfg = _cfgs(False)
    be = LatticeBackend(LatticeSpec(*ls.shape), tcfg, device="cpu")
    be.device = torch.device("cuda")  # as if built on the card
    with pytest.raises(ValueError):
        be.step(to_port(ls), tb.PhysicsConstants(), tb.UserInput())


ENTRY_POINTS = {
    "LatticeBackend": lambda: LatticeBackend(LatticeSpec(4, 4),
                                             tb.StaticConfig()),
    "FusedLatticeBackend": lambda: FusedLatticeBackend(LatticeSpec(4, 4),
                                                       tb.StaticConfig()),
    "make_lattice": lambda: make_lattice(4, 4, 10.0),
    "tearing_cloth_lattice": lambda: tearing_cloth_lattice(n_particles=16),
    "cloth_lattice": lambda: cloth_lattice(w=4, h=4),
    "lattice_state_from_numpy": lambda: lattice_state_from_numpy(
        **random_state(6, 6, seed=0)),
    "empty_far_list": lambda: empty_far_list(4, 4, FarFieldSpec()),
    "PlanifiedBackend": lambda: PlanifiedBackend(tb.StaticConfig()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without ``device`` the port runs on the card; with no card it
    raises and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    assert tb.config.resolve_device("cpu") == torch.device("cpu")
