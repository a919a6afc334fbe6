"""The port's runtime (``softbody_tpu_torch/engine``) on the CPU: the
worker thread, the message protocol, the decoupled readback, snapshots
through the engine, fault injection; case by case the counterparts of
tests/test_engine.py, plus the backends' host surfaces against the JAX
package's on states built once (corrupt under one seed, render packets),
and the fused far-field engine's four far stats.

Torch runs on two threads here, and engines are paced (``target_fps``)
wherever a case does not need flat-out stepping, so the file leaves the
other cores to the tests beside it; every wait has a timeout."""

import threading
import time

import numpy as np
import pytest
import torch

from softbody_tpu import PhysicsConstants as JConsts
from softbody_tpu import StaticConfig as JStaticConfig
from softbody_tpu import state_from_numpy as j_state_from_numpy
from softbody_tpu.config import clamp_constants as j_clamp_constants
from softbody_tpu.config import clamp_value as j_clamp_value
from softbody_tpu.engine import backends as jbackends
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
import softbody_tpu_torch as tb
from softbody_tpu_torch.config import clamp_constants, clamp_value
from softbody_tpu_torch.convert import (
    lattice_state_to_numpy,
    sim_state_to_numpy,
)
from softbody_tpu_torch.engine import (
    Engine,
    EngineOptions,
    FifoLock,
    FusedLatticeBackend,
    LatticeBackend,
    LatticeEngine,
    SimBackend,
)
from softbody_tpu_torch.models import cloth_lattice
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec
from softbody_tpu_torch.snapshot import save_snapshot

from test_farfield import hairpin
from test_torch_frame import HAIRPIN_CFG, HAIRPIN_FF
from torch_parity import random_state, sim_to_jax, sim_to_port, to_jax, to_port

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_state():
    pos = np.array([[300.0, 500.0], [340.0, 500.0], [700.0, 300.0]],
                   np.float32)
    return tb.state_from_numpy(pos, beams=np.array([[0, 1]], np.int32),
                               beam_spring=10.0, beam_damp=2.0, device="cpu")


def small_engine(target_fps=100.0, **kw):
    opts = EngineOptions(subticks=8, collision_mode="allpairs",
                         target_fps=target_fps, **kw)
    return Engine(small_state(), options=opts, device="cpu")


def wait_frames(eng, n, timeout=WAIT_S):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = eng.stats()
        if st.frame_index >= n:
            return st
        time.sleep(0.01)
    raise TimeoutError(f"engine only reached frame {eng.stats().frame_index}")


def lattice_engine(fused=False, farfield=None, **kw):
    ls, spec, cfg = cloth_lattice(w=8, h=8, spacing=20.0, pin_top=True,
                                  spring=5.0, device="cpu")
    opts = EngineOptions(subticks=8, particle_radius=cfg.particle_radius,
                         target_fps=50.0, **kw)
    return LatticeEngine(ls, spec, options=opts, fused=fused,
                         farfield=farfield, device="cpu")


def test_engine_steps_and_reports_stats():
    with small_engine() as eng:
        st = wait_frames(eng, 5)
        assert st.particle_count == 3
        assert st.beam_count == 1
        assert st.frame_index >= 5
        assert st.far_active == 0
    assert eng.destroyed


def test_render_packet_decoupled():
    with small_engine() as eng:
        wait_frames(eng, 3)
        pkt = eng.render_packet()
        assert pkt is not None
        assert pkt.pos.shape == (3, 2)
        assert np.isfinite(pkt.pos).all()
        f1 = pkt.frame_index
        wait_frames(eng, f1 + 3)
        pkt2 = eng.render_packet()
        assert pkt2.frame_index > f1
        assert pkt2.pos[2, 1] < 300.0  # gravity pulls the free particle
        pkt3 = eng.render_packet_rpc()
        assert pkt3 is not None and pkt3.frame_index >= pkt2.frame_index
        assert pkt3.beam_a.dtype == np.int32


def test_render_packet_polling_never_stalls_stepping():
    """Host-thread readback: polling render_packet() flat-out does not
    serialize against the frame loop — frames keep advancing and every
    packet is consistent.  (How fast they advance is the interpreter's
    call: the worker's eager frame and this loop take turns on the GIL,
    and on a loaded machine a frame can take a second; the wait is
    bounded instead.)"""
    with small_engine(target_fps=None) as eng:
        wait_frames(eng, 2)
        f0 = eng.stats().frame_index
        seen = [f0]
        t_end = time.monotonic() + WAIT_S
        while seen[-1] < f0 + 3:
            assert time.monotonic() < t_end, f"stepping stalled at {seen[-1]}"
            pkt = eng.render_packet()  # no sleep: poll flat-out
            assert pkt is not None
            assert pkt.pos.shape[0] == pkt.particle_alive.shape[0]
            assert pkt.beam_a.shape == pkt.beam_b.shape
            seen.append(pkt.frame_index)
        assert seen == sorted(seen)
        assert eng.error is None


def test_physics_constants_rpc():
    with small_engine() as eng:
        eng.set_physics_constants(tb.PhysicsConstants(gravity=(0.0, 3.0)))
        got = eng.get_physics_constants()
        assert got.gravity == (0.0, 3.0)
        wait_frames(eng, 10)
        assert eng.render_packet().pos[2, 1] > 300.0  # floats up


def test_snapshot_roundtrip_through_engine():
    with small_engine() as eng:
        wait_frames(eng, 3)
        buf = eng.save_snapshot()
        assert isinstance(buf, (bytes, bytearray))
        st0 = eng.stats()
        assert eng.load_snapshot(buf)
        wait_frames(eng, st0.frame_index + 2)
        assert eng.error is None


def test_snapshot_too_large_returns_false():
    with small_engine(max_particles=2) as eng:
        pos = np.random.default_rng(0).uniform(50, 950, (10, 2))
        buf = save_snapshot(tb.state_from_numpy(pos, device="cpu"),
                            tb.PhysicsConstants())
        assert eng.load_snapshot(buf) is False
        assert eng.error is None


def test_input_affects_simulation():
    with small_engine() as eng:
        eng.keyboard_force = 5.0
        eng.key_down("d")  # push +x
        wait_frames(eng, 12)
        assert eng.render_packet().pos[2, 0] > 700.0


def test_visibility_pause():
    with small_engine() as eng:
        wait_frames(eng, 2)
        eng.set_hidden(True)
        time.sleep(0.3)
        f1 = eng.stats().frame_index
        time.sleep(0.3)
        f2 = eng.stats().frame_index
        assert f2 == f1  # paused
        eng.set_hidden(False)
        wait_frames(eng, f2 + 2)


def test_corrupt_buffers_survival():
    """Random bit garbage in every buffer (≙ corruptBuffers,
    engineWorker.ts:599-617) does not kill the engine loop."""
    with small_engine() as eng:
        wait_frames(eng, 2)
        for _ in range(5):
            eng.corrupt_buffers()
        wait_frames(eng, eng.stats().frame_index + 5)
        assert eng.error is None
        assert eng.render_packet().pos.shape == (3, 2)


def test_fifo_lock_ordering():
    lock = FifoLock()
    order = []

    def worker(i):
        with lock:
            order.append(i)
            time.sleep(0.01)

    with lock:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
            time.sleep(0.02)  # enforce arrival order
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert order == [0, 1, 2, 3, 4]


def test_lattice_engine_backend():
    """The dense stencil backend behind the engine: packets with the
    static topology, the L1 snapshot round trip, a general snapshot
    refused, corruption survived."""
    with lattice_engine() as eng:
        st = wait_frames(eng, 3)
        assert st.particle_count == 64
        assert st.beam_count > 150
        pkt = eng.render_packet()
        assert pkt.pos.shape == (64, 2)
        assert pkt.beam_a.shape == pkt.beam_alive.shape
        assert np.isfinite(pkt.pos).all()
        buf = eng.save_snapshot()
        assert buf[:4] == b"SBL1"
        assert eng.load_snapshot(buf)
        other = save_snapshot(tb.state_from_numpy(np.float32([[1.0, 2.0]]),
                                                  device="cpu"),
                              tb.PhysicsConstants())
        assert eng.load_snapshot(other) is False
        eng.corrupt_buffers()
        wait_frames(eng, eng.stats().frame_index + 2)
        assert eng.error is None


def test_initial_state_reset_slot():
    """≙ the reference's reset and set-initial-state buttons
    (main.ts:262-276)."""
    with small_engine() as eng:
        wait_frames(eng, 2)
        eng.set_initial_state()
        pkt0 = eng.render_packet()
        wait_frames(eng, pkt0.frame_index + 10)
        pkt1 = eng.render_packet()
        assert not np.allclose(pkt0.pos, pkt1.pos)
        assert eng.reset()
        wait_frames(eng, eng.stats().frame_index + 1)
        pkt2 = eng.render_packet()
        assert np.abs(pkt2.pos - pkt0.pos).max() < np.abs(
            pkt1.pos - pkt0.pos).max()


def test_constants_clamping():
    c = tb.PhysicsConstants(gravity=(99.0, -99.0), elasticity=7.0,
                            drag_exp=0.0)
    cc = clamp_constants(c)
    assert cc.gravity == (10.0, -10.0)
    assert cc.elasticity == 1.0 and cc.drag_exp == 1.0
    assert clamp_value("subticks", 63) == 64
    assert clamp_value("subticks", 1) == 2
    assert clamp_value("particle_radius", 1234.0) == 500.0
    # the JAX package's clamps, value for value
    jc = JConsts.default()
    jc.gravity = np.float32([99.0, -99.0])
    jc.elasticity, jc.drag_exp = np.float32(7.0), np.float32(0.0)
    np.testing.assert_array_equal(
        cc.to_array(), np.asarray(j_clamp_constants(jc).to_array()))
    for name in ("friction", "drag_coeff", "keyboard_force", "gravity_x"):
        for v in (-3.0, 0.0371, 0.5, 9.99, 1e9):
            assert clamp_value(name, v) == j_clamp_value(name, v)


def test_fused_lattice_engine_backend():
    """``LatticeEngine(fused=True)``: K1's plain version behind the
    engine — stepping, packets, the L1 round trip, the reset slot."""
    ls, spec, _cfg = cloth_lattice(w=8, h=8, spacing=20.0, device="cpu")
    opts = EngineOptions(subticks=4, particle_radius=8.0, target_fps=50.0)
    with LatticeEngine(ls, spec, options=opts, fused=True, tile_w=8,
                       device="cpu") as eng:
        st = wait_frames(eng, 3)
        assert st.particle_count == 64
        pkt = eng.render_packet()
        assert pkt.pos.shape == (64, 2)
        assert np.isfinite(pkt.pos).all()
        buf = eng.save_snapshot()
        assert buf[:4] == b"SBL1"
        assert eng.load_snapshot(buf)
        eng.set_initial_state()
        wait_frames(eng, eng.stats().frame_index + 2)
        assert eng.reset()
        assert eng.error is None


def test_fused_far_field_engine_reports_far_active():
    """The fused backend's far stats carry a fourth key, ``far_active``:
    ``stats()`` takes it (the JAX package's EngineStats has no such field
    and its worker fails there).  The folded strip of
    tests/test_farfield.py has far pairs from the first rebuild."""
    spec = LatticeSpec(*hairpin().shape)
    opts = EngineOptions(subticks=HAIRPIN_CFG["subticks"],
                         particle_radius=HAIRPIN_CFG["particle_radius"],
                         target_fps=50.0)
    with LatticeEngine(to_port(hairpin()), spec, options=opts, fused=True,
                       farfield=FarFieldSpec(**HAIRPIN_FF),
                       device="cpu") as eng:
        t_end = time.monotonic() + WAIT_S
        st = eng.stats()
        while st.far_rebuilds == 0 and time.monotonic() < t_end:
            time.sleep(0.05)  # the stats window resets on each read
            st = eng.stats()
        assert st.far_rebuilds >= 1 and st.far_overflow == 0
        assert st.far_active == st.far_pairs > 0
        # bit garbage in the packed planes: the far-field frame goes on
        for _ in range(3):
            eng.corrupt_buffers()
        wait_frames(eng, eng.stats().frame_index + 2)
        assert eng.error is None


def test_recreate_preserves_state_on_option_change():
    """≙ the reference's apply-options flow (main.ts:137-146): a new
    compile-time option rebuilds the engine around a snapshot, on the
    same device."""
    with small_engine() as eng:
        wait_frames(eng, 3)
        eng.set_initial_state()
        pkt0 = eng.render_packet()
        assert eng.options.subticks == 8
        new = eng.recreate(subticks=32)
        assert eng.destroyed
    try:
        assert new.options.subticks == 32 and new.device.type == "cpu"
        wait_frames(new, 1)
        pkt1 = new.render_packet()
        # carried over, not reset: in free fall x stays and y keeps falling
        assert pkt1.pos.shape == pkt0.pos.shape
        assert np.array_equal(pkt1.pos[:, 0], pkt0.pos[:, 0])
        assert (pkt1.pos[:, 1] < pkt0.pos[:, 1]).all()
        assert (pkt1.pos[:, 1] > 0).all()
        assert new.reset()  # the initial-state slot survives
        assert new.error is None
    finally:
        new.destroy()


def test_recreate_lattice_engine():
    eng = lattice_engine()
    try:
        wait_frames(eng, 2)
        new = eng.recreate(particle_radius=6.0)
        assert eng.destroyed
    finally:
        eng.destroy()
    try:
        st = wait_frames(new, 1)
        assert st.particle_count == 64
        assert new.options.particle_radius == 6.0
        assert new.error is None
    finally:
        new.destroy()


def test_broad_phase_overflow_surfaced():
    """Grid cell-capacity truncation is observable through the engine: a
    crowded cell overflows a tiny capacity; a roomy one reports 0."""
    pos = np.full((32, 2), 505.0, np.float32)
    for cap, expect_over in ((4, True), (64, False)):
        opts = EngineOptions(subticks=2, collision_mode="grid",
                             grid_cell_capacity=cap, target_fps=50.0)
        with Engine(tb.state_from_numpy(pos, device="cpu"), options=opts,
                    device="cpu") as eng:
            wait_frames(eng, 1)
            got = eng.broad_phase_overflow()
            assert (got > 0) if expect_over else (got == 0), (cap, got)


def test_worker_error_surfaces_as_runtime_error():
    """An error in the worker stops it; the next acked message raises
    ``RuntimeError`` from it at once, not after the ack's timeout."""
    with small_engine() as eng:
        wait_frames(eng, 1)
        eng._worker.backend.counts = None  # GET_STATS now fails
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="worker died"):
            eng.stats()
        assert time.monotonic() - t0 < 10.0
        assert isinstance(eng.error, TypeError)


def test_engines_default_to_cuda(monkeypatch):
    ls, spec, _cfg = cloth_lattice(w=4, h=4, spacing=20.0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(small_state())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LatticeEngine(ls, spec)


# ---- the backends' host surfaces against the JAX package's -------------


def _backends(arrays, spec_kw=None):
    """A port and a JAX backend of each lattice kind over the same
    world (the JAX fused one strict, ``kernel_variants=()``)."""
    w, h = arrays["pos"].shape[:2]
    spec, jspec = LatticeSpec(w, h), JLatticeSpec(w, h)
    cfg, jcfg = tb.StaticConfig(subticks=8), JStaticConfig(subticks=8)
    return {
        "dense": (LatticeBackend(spec, cfg, device="cpu"),
                  jbackends.LatticeBackend(jspec, jcfg)),
        "fused": (FusedLatticeBackend(spec, cfg, device="cpu",
                                      kernel_variants=()),
                  jbackends.FusedLatticeBackend(jspec, jcfg, tile_w=8,
                                                kernel_variants=())),
    }


def _nan_aware_equal(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype.kind == "f":
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("seed", [0, 7])
def test_lattice_corrupt_matches_jax(seed):
    """``corrupt`` on both lattice backends: under one seed of
    ``np.random.default_rng`` the same bits flip as in the JAX package
    (NaN-aware: compared as bit patterns)."""
    arrays = random_state(16, 8, seed=2)
    for kind, (be, jbe) in _backends(arrays).items():
        st, jst = to_port(to_jax(arrays)), to_jax(arrays)
        if kind == "fused":
            st, jst = be.pack_state(st), jbe.pack_state(jst)
        st = be.corrupt(st, np.random.default_rng(seed))
        jst = jbe.corrupt(jst, np.random.default_rng(seed))
        if kind == "fused":
            st, jst = be.unpack_state(st), jbe.unpack_state(jst)
        got, ref = lattice_state_to_numpy(st), lattice_state_to_numpy(jst)
        flipped = 0
        for k in ("pos", "vel", "acc"):
            _nan_aware_equal(got[k], ref[k], f"{kind} {k}")
            flipped += int((got[k] != arrays[k]).sum())
        for c, (eg, er, e0) in enumerate(zip(got["edges"], ref["edges"],
                                             arrays["edges"])):
            for k in ("target_length", "last_length", "alive"):
                _nan_aware_equal(eg[k], er[k], f"{kind} class {c} {k}")
                flipped += int((eg[k] != e0[k]).sum())
        assert flipped > 0, kind


@pytest.mark.parametrize("seed", [1, 3, 12])
def test_sim_corrupt_matches_jax(seed):
    """``SimBackend.corrupt`` under one seed flips the same bits as the
    JAX package's, the alive masks too when the draw picks them."""
    rng = np.random.default_rng(9)
    pos = rng.uniform(50, 950, (12, 2)).astype(np.float32)
    beams = np.stack([np.arange(11), np.arange(1, 12)], -1).astype(np.int32)
    fields = sim_state_to_numpy(j_state_from_numpy(pos, beams=beams))
    cfg, jcfg = tb.StaticConfig(subticks=8), JStaticConfig(subticks=8)
    got = sim_state_to_numpy(SimBackend(cfg, device="cpu").corrupt(
        sim_to_port(fields), np.random.default_rng(seed)))
    ref = sim_state_to_numpy(jbackends.SimBackend(jcfg).corrupt(
        sim_to_jax(fields), np.random.default_rng(seed)))
    for k, v in ref.items():
        if v is not None:
            _nan_aware_equal(got[k], v, k)


def test_packet_arrays_match_jax():
    """Render packets of both lattice backends and the general one equal
    the JAX package's, beam by beam in its topology order."""
    arrays = random_state(16, 8, seed=3)
    for kind, (be, jbe) in _backends(arrays).items():
        st, jst = to_port(to_jax(arrays)), to_jax(arrays)
        if kind == "fused":
            st, jst = be.pack_state(st), jbe.pack_state(jst)
        got = be.packet_arrays(be.extract(st))
        ref = jbe.packet_arrays(jbe.extract(jst))
        assert len(got) == len(ref) == 7
        for i, (a, b) in enumerate(zip(got, ref)):
            _nan_aware_equal(a, b, f"{kind} field {i}")
    st = small_state()
    be = SimBackend(tb.StaticConfig(), device="cpu")
    jbe = jbackends.SimBackend(JStaticConfig())
    got = be.packet_arrays(be.extract(st))
    ref = jbe.packet_arrays(jbe.extract(sim_to_jax(sim_state_to_numpy(st))))
    for i, (a, b) in enumerate(zip(got, ref)):
        _nan_aware_equal(a, b, f"general field {i}")
