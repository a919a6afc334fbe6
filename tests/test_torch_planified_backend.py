"""The port's ``PlanifiedBackend`` on the CPU, against the JAX package's
where the two compute the same bytes (the embedding, snapshots, fault
injection, render packets) and against JAX's eager planified substeps
for a frame; then behind ``Engine`` on the worker thread.

A frame is held to tests/test_torch_lattice_backend.py's pos atol 5e-3,
vel atol 5e-2 (the collision sums' order); bytes, packets and corrupted
states bit for bit (NaN-aware: compared as bit patterns)."""

import time

import numpy as np
import pytest
import torch

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.engine.backends import PlanifiedBackend as JPlanifiedBackend
from softbody_tpu.models import multi_blob
from softbody_tpu.ops import planify as jplanify
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import sim_state_to_numpy
from softbody_tpu_torch.engine import Engine, EngineOptions, PlanifiedBackend
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.planify import unplanify

from torch_parity import consts_to_port, sim_to_jax, sim_to_port, uin_to_port

CFG = dict(subticks=8, collision_mode="allpairs", particle_radius=8.0,
           force_mode="quantized")
FIELDS = ("pos", "particle_alive", "beam_a", "beam_b", "beam_alive",
          "beam_strain", "beam_stress")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n_blobs=4, radius=30.0):
    """``multi_blob`` as numpy fields (built by the JAX package)."""
    return sim_state_to_numpy(multi_blob(n_blobs=n_blobs,
                                         blob_radius=radius)[0])


def _same_bits(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype.kind == "f":
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def test_round_trip_packet_and_step():
    """pack → unpack is the identity; counts and the render packet (the
    device gather) equal ``unplanify``'s and JAX's; one frame equals
    JAX's eager substeps from the same embedding."""
    fields = _blobs()
    ts = sim_to_port(fields)
    be = PlanifiedBackend(tb.StaticConfig(**CFG), device="cpu")
    ps = be.pack_state(ts)
    back = sim_state_to_numpy(be.unpack_state(ps))
    for k, v in fields.items():
        if v is not None:
            _same_bits(back[k], v, k)
    assert be.counts(ps) == (int(fields["particle_alive"].sum()),
                             int(fields["beam_alive"].sum()))

    jbe = JPlanifiedBackend(StaticConfig(**CFG))
    jps = jbe.pack_state(sim_to_jax(fields))
    assert (be.spec.width, be.spec.height, be.spec.edge_offsets) == (
        jbe._spec.width, jbe._spec.height, jbe._spec.edge_offsets)
    pkt = be.packet_arrays(be.extract(ps))
    for i, (a, b) in enumerate(zip(pkt, jbe.extract(jps))):
        _same_bits(a, b, FIELDS[i])

    consts, uin = PhysicsConstants.default(), UserInput.none()
    ps = be.step(ps, consts_to_port(consts), uin_to_port(uin))
    for s in range(CFG["subticks"]):
        jps = jplanify.planified_substep(
            jps, consts, uin, jbe._spec, StaticConfig(**CFG),
            update_observability=s == CFG["subticks"] - 1)
    got = sim_state_to_numpy(be.unpack_state(ps))
    ref = sim_state_to_numpy(jbe.unpack_state(jps))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)
    np.testing.assert_array_equal(got["beam_alive"], ref["beam_alive"])
    pkt = be.packet_arrays(be.extract(ps))
    flat = sim_state_to_numpy(be.unpack_state(ps))
    for i, name in enumerate(FIELDS):
        _same_bits(pkt[i], flat[name], name)


def test_snapshot_bytes_match_jax():
    """``save`` writes the JAX package's bytes for the same world; each
    package's backend loads the other's."""
    fields = _blobs(2, 25.0)
    consts = PhysicsConstants.default()
    be = PlanifiedBackend(tb.StaticConfig(**CFG), device="cpu")
    jbe = JPlanifiedBackend(StaticConfig(**CFG))
    buf = be.save(be.pack_state(sim_to_port(fields)), consts_to_port(consts))
    jbuf = jbe.save(jbe.pack_state(sim_to_jax(fields)), consts)
    assert buf == jbuf
    ps, _consts = be.load(jbuf)
    got = sim_state_to_numpy(be.unpack_state(ps))
    jps, _jc = jbe.load(buf)
    ref = sim_state_to_numpy(jbe.unpack_state(jps))
    for k in ("pos", "vel", "beam_alive", "beam_target_length"):
        _same_bits(got[k], ref[k], k)
    assert be.load(b"not a snapshot") is None


@pytest.mark.parametrize("seed", [0, 2])
def test_corrupt_matches_jax(seed):
    """Under one seed the same bits flip as in the JAX package (seed 2
    changes JAX's re-embedded layout; the port keeps its layout, the flat
    state is the same)."""
    fields = _blobs(2, 25.0)
    be = PlanifiedBackend(tb.StaticConfig(**CFG), device="cpu")
    jbe = JPlanifiedBackend(StaticConfig(**CFG))
    ps = be.corrupt(be.pack_state(sim_to_port(fields)),
                    np.random.default_rng(seed))
    jps = jbe.corrupt(jbe.pack_state(sim_to_jax(fields)),
                      np.random.default_rng(seed))
    got = sim_state_to_numpy(be.unpack_state(ps))
    ref = sim_state_to_numpy(jbe.unpack_state(jps))
    for k, v in ref.items():
        if v is not None:
            _same_bits(got[k], v, k)
    assert any(not np.array_equal(got[k], fields[k]) for k in ("pos", "vel"))
    pkt = be.packet_arrays(be.extract(ps))
    for i, name in enumerate(FIELDS):
        _same_bits(pkt[i], got[name], name)


def test_far_armed_stats():
    """Far-armed: the fixed-cadence far frame, an embedding aligned to the
    chunk grid, and four stats (``far_active`` too) that reset on read."""
    ff = FarFieldSpec(max_pairs=128, max_tile_pairs=32, skin=10.0,
                      horizon=4)
    be = PlanifiedBackend(tb.StaticConfig(**CFG), farfield=ff, device="cpu")
    ps = be.pack_state(sim_to_port(_blobs()))
    assert be.spec.height % (ff.chunk * ff.tile_chunks) == 0
    assert be.spec.width % ff.chunk == 0
    for _ in range(2):
        ps = be.step(ps, tb.PhysicsConstants(), tb.UserInput())
    assert torch.isfinite(ps.lat.pos).all()
    st = be.far_stats()
    assert st["far_rebuilds"] == 4 and st["far_overflow"] == 0, st
    assert 0 <= st["far_active"] <= st["far_pairs"], st
    assert be.far_stats() == {}


def test_engine_on_planified_backend():
    """``Engine(backend=PlanifiedBackend(device="cpu"))`` steps on its
    worker thread; paused, its packet equals ``unplanify`` of the
    worker's state bit for bit; the snapshot round trip and corruption
    leave it stepping."""
    be = PlanifiedBackend(tb.StaticConfig(**CFG), device="cpu")
    flat = sim_to_port(_blobs())
    opts = EngineOptions(subticks=8, collision_mode="allpairs",
                         particle_radius=8.0, target_fps=30.0)
    with Engine(be.pack_state(flat), options=opts, backend=be) as eng:
        _wait(eng, 2)
        eng.set_hidden(True)
        n = _wait(eng, 0).frame_index
        time.sleep(0.3)
        n = _wait(eng, n).frame_index
        pkt = eng.render_packet()
        assert pkt.frame_index == n
        ref = sim_state_to_numpy(unplanify(eng._worker._state, flat,
                                           be.aux))
        for name in FIELDS:
            _same_bits(getattr(pkt, name), ref[name], name)
        buf = eng.save_snapshot()
        assert eng.load_snapshot(buf)
        assert eng.save_snapshot() == buf
        eng.corrupt_buffers()
        eng.set_hidden(False)
        _wait(eng, n + 2)
        assert eng.error is None


def _wait(eng, n, timeout=60.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = eng.stats()
        if st.frame_index >= n:
            return st
        time.sleep(0.01)
    raise TimeoutError(f"engine only reached frame {eng.stats().frame_index}")
