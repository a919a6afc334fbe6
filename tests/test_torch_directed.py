"""The port's directed-CSR engine (``softbody_tpu_torch/ops/directed.py``)
on the CPU: its tables equal the JAX package's ``build_directed``, and
its substep equals the port's flat substep (``ops/step.py``) bit for bit
under quantized forces (the JAX package's own claim,
softbody_tpu/ops/directed.py:19-24: per-slot ``trunc(±f·65536)`` summed
in int32 equals the flat path's integer totals), for each broad phase."""

import numpy as np
import pytest

from softbody_tpu.models import multi_blob
from softbody_tpu.ops.directed import build_directed as j_build_directed
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import sim_state_to_numpy
from softbody_tpu_torch.ops import step as gstep
from softbody_tpu_torch.ops.directed import (
    build_directed,
    directed_beam_pass,
    directed_frame,
    directed_to_sim,
)
from softbody_tpu_torch.ops.forces import accumulate_forces, beam_forces

from torch_parity import jittered, sim_to_jax, sim_to_port
from torch_threads import two_torch_threads  # noqa: F401

TABLES = ("partner", "slot_sign", "slot_alive", "spring", "damp",
          "yield_strain", "strain_limit", "length", "target", "last",
          "strain", "stress")


def _blobs(seed=5):
    """``multi_blob(4)`` jittered so that beams stretch, yield and break
    and particles collide, a few beams dead."""
    fields = jittered(sim_state_to_numpy(multi_blob(
        n_blobs=4, blob_radius=30.0)[0]), seed, pos_jitter=4.0,
        vel_scale=40.0)
    fields["beam_alive"] = fields["beam_alive"] & (
        np.random.default_rng(seed).random(fields["beam_alive"].shape) > 0.05)
    fields["beam_yield_strain"] = np.full_like(fields["beam_length"], 0.05)
    fields["beam_strain_limit"] = np.full_like(fields["beam_length"], 0.3)
    return fields


def test_build_directed_matches_jax():
    fields = _blobs()
    ds, slot_edge = build_directed(sim_to_port(fields))
    jds, jslot_edge = j_build_directed(sim_to_jax(fields))
    np.testing.assert_array_equal(slot_edge, np.asarray(jslot_edge))
    for k in TABLES:
        np.testing.assert_array_equal(getattr(ds, k).numpy(),
                                      np.asarray(getattr(jds, k)), err_msg=k)


@pytest.mark.parametrize("mode", ["allpairs", "grid", "window"])
def test_directed_matches_flat_substeps(mode):
    """Three substeps: the beam force totals of the first bit-exact
    against the flat pass, then the directed frame's particle and beam
    state against the flat substeps', bit for bit."""
    fields = _blobs()
    cfg = tb.StaticConfig(subticks=8, collision_mode=mode,
                          particle_radius=8.0, force_mode="quantized")
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    flat = sim_to_port(fields)
    ds, slot_edge = build_directed(flat)

    force, _upd = directed_beam_pass(ds, cfg)
    ref_force = accumulate_forces(flat, beam_forces(flat, cfg)[0], cfg)
    np.testing.assert_array_equal(force.numpy(), ref_force.numpy())

    ref = flat
    for _ in range(3):
        ref = gstep.substep(ref, consts, uin, cfg)
    got = directed_to_sim(directed_frame(ds, consts, uin, cfg, n_sub=3),
                          flat, slot_edge)
    got, ref = sim_state_to_numpy(got), sim_state_to_numpy(ref)
    assert not np.array_equal(got["beam_alive"], fields["beam_alive"])
    for k in ("pos", "vel", "acc", "beam_target_length", "beam_last_length",
              "beam_alive", "beam_strain", "beam_stress"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
