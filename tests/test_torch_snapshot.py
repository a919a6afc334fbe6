"""Snapshots of the port (``softbody_tpu_torch/snapshot.py``) against the
JAX package's (``softbody_tpu/snapshot.py``): for the same state (carried
across by ``convert``) both write the same v0, v1 and L1 bytes, each
package's loader reads the other's bytes back to the same state, and
both reject the same malformed or oversized snapshots.  Byte-exact: the
formats are fixed layouts of float32 and integer fields."""

import numpy as np
import pytest

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants as JConsts
from softbody_tpu import snapshot as jsnap
from softbody_tpu import state_from_numpy as j_state_from_numpy
from softbody_tpu.models import make_lattice as j_make_lattice
from softbody_tpu_torch import snapshot as tsnap
from softbody_tpu_torch.config import PhysicsConstants
from softbody_tpu_torch.convert import (
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    sim_state_to_numpy,
)

from torch_parity import (
    consts_to_port,
    random_state,
    sim_to_jax,
    sim_to_port,
    to_jax,
)
from torch_threads import two_torch_threads  # noqa: F401

CONSTS_8 = np.float32([0.25, -0.75, 0.3, 0.4, 0.6, 0.15, 0.002, 2.5])


def _general_fields(n_extra=0):
    """A JAX general state read out to numpy: four beams with varied
    parameters, strain and stress; one dead particle (its beam is dropped
    on save) and one dead beam; ``n_extra`` free particles more."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(50, 950, (5 + n_extra, 2)).astype(np.float32)
    vel = rng.normal(0, 3, pos.shape).astype(np.float32)
    beams = np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.int32)
    st = j_state_from_numpy(
        pos, vel, acc=rng.normal(0, 1, pos.shape).astype(np.float32),
        beams=beams, beam_spring=np.float32([10, 20, 30, 40]),
        beam_damp=np.float32([1, 2, 3, 4]),
        beam_yield_strain=np.float32([0.5, 0.6, 0.7, 0.8]),
        beam_strain_limit=np.float32([2, 3, 4, 5]), max_particles=8 + n_extra,
        max_beams=6)
    st.beam_strain = jnp.asarray(rng.random(6).astype(np.float32))
    st.beam_stress = jnp.asarray(rng.random(6).astype(np.float32))
    st.beam_alive = st.beam_alive.at[1].set(False)
    st.particle_alive = st.particle_alive.at[4].set(False)
    return sim_state_to_numpy(st)


def _same_general(a, b):
    """Two loaded general states (numpy fields) are equal."""
    for k, v in a.items():
        if v is None:
            assert b[k] is None, k
        else:
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["v0", "v1"])
def test_general_snapshot_bytes_and_loaders_match(fmt):
    fields = _general_fields()
    jc, tc = JConsts.from_array(CONSTS_8), PhysicsConstants.from_array(
        CONSTS_8)
    jbuf = jsnap.save_snapshot(sim_to_jax(fields), jc, format=fmt)
    tbuf = tsnap.save_snapshot(sim_to_port(fields), tc, format=fmt)
    assert tbuf == jbuf
    assert (tbuf[:4] == b"SBT1") == (fmt == "v1")
    # each loader on the other's bytes, at a capacity and without
    for kw in ({}, dict(max_particles=16, max_beams=8)):
        js, jc2 = jsnap.load_snapshot(tbuf, **kw)
        ts, tc2 = tsnap.load_snapshot(jbuf, device="cpu", **kw)
        _same_general(sim_state_to_numpy(ts), sim_state_to_numpy(js))
        np.testing.assert_array_equal(tc2.to_array(), np.asarray(
            jc2.to_array()))
    np.testing.assert_array_equal(tc2.to_array(), CONSTS_8)
    assert int(ts.beam_count) == 2  # the dead beam and the dead end's


def test_v0_capacity_and_auto_format_match():
    """Past the u16 header's 2730 particles both refuse v0 and write the
    same v1 under ``auto``."""
    fields = _general_fields(n_extra=tsnap.V0_MAX_PARTICLES)
    jc, tc = JConsts.default(), PhysicsConstants()
    for save, state, c in ((jsnap.save_snapshot, sim_to_jax(fields), jc),
                           (tsnap.save_snapshot, sim_to_port(fields), tc)):
        with pytest.raises(ValueError):
            save(state, c, format="v0")
    assert tsnap.save_snapshot(sim_to_port(fields), tc) == \
        jsnap.save_snapshot(sim_to_jax(fields), jc)


def test_lattice_snapshot_bytes_and_loaders_match():
    arrays = random_state(9, 7, seed=4)
    jc = JConsts.from_array(CONSTS_8)
    jbuf = jsnap.save_lattice_snapshot(to_jax(arrays), jc)
    tbuf = tsnap.save_lattice_snapshot(
        lattice_state_from_numpy(**arrays, device="cpu"),
        PhysicsConstants.from_array(CONSTS_8))
    assert tbuf == jbuf and tbuf[:4] == b"SBL1"
    ts, tc = tsnap.load_lattice_snapshot(jbuf, device="cpu")
    js, _jc = jsnap.load_lattice_snapshot(tbuf)
    got, ref = lattice_state_to_numpy(ts), lattice_state_to_numpy(js)
    for k in ("pos", "vel", "acc", "alive", "pinned"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    for eg, er in zip(got["edges"], ref["edges"]):
        for k in er:
            np.testing.assert_array_equal(eg[k], er[k], err_msg=k)
    np.testing.assert_array_equal(tc.to_array(), CONSTS_8)


def _rejections():
    """(label, bytes, loader name, kwargs) that both packages reject."""
    fields = _general_fields()
    v0 = jsnap.save_snapshot(sim_to_jax(fields), JConsts.default(),
                             format="v0")
    v1 = jsnap.save_snapshot(sim_to_jax(fields), JConsts.default(),
                             format="v1")
    l1 = jsnap.save_lattice_snapshot(j_make_lattice(4, 3, 10.0),
                                     JConsts.default())
    huge = l1[:4] + np.uint32([100_000, 100_000]).tobytes() + l1[12:]
    return [
        ("capacity", v0, "load_snapshot", dict(max_particles=3)),
        ("beam capacity", v1, "load_snapshot", dict(max_beams=1)),
        ("v0 truncated", v0[:-7], "load_snapshot", {}),
        ("v0 header only", v0[:20], "load_snapshot", {}),
        ("v1 truncated", v1[:-3], "load_snapshot", {}),
        ("L1 as general", l1, "load_snapshot", {}),
        ("v0 as lattice", v0, "load_lattice_snapshot", {}),
        ("L1 truncated", l1[:-1], "load_lattice_snapshot", {}),
        ("L1 too large", huge, "load_lattice_snapshot", {}),
    ]


def test_both_packages_reject_the_same_snapshots():
    for _label, buf, loader, kw in _rejections():
        with pytest.raises(jsnap.SnapshotError):
            getattr(jsnap, loader)(buf, **kw)
        with pytest.raises(tsnap.SnapshotError):
            getattr(tsnap, loader)(buf, device="cpu", **kw)


def test_constants_array_layout_matches():
    """``PhysicsConstants.to_array``/``from_array`` keep the 8-float
    layout of the metadata buffer (engineMapping.ts:260) in both."""
    j = JConsts.from_array(CONSTS_8)
    t = PhysicsConstants.from_array(CONSTS_8)
    np.testing.assert_array_equal(t.to_array(), np.asarray(j.to_array()))
    assert t == consts_to_port(j)
    np.testing.assert_array_equal(PhysicsConstants().to_array(),
                                  np.asarray(JConsts.default().to_array()))


def test_loaders_default_to_cuda(monkeypatch):
    import torch

    fields = _general_fields()
    buf = jsnap.save_snapshot(sim_to_jax(fields), JConsts.default())
    l1 = jsnap.save_lattice_snapshot(j_make_lattice(4, 3, 10.0),
                                     JConsts.default())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnap.load_snapshot(buf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnap.load_lattice_snapshot(l1)
