"""The compiled frames (``softbody_tpu_torch/ops/compiled.py``) on the
CPU.

- JAX parity: the port's ``frame_jit``, ``substep_jit``,
  ``lattice_frame_jit``, ``lattice_frame_far_jit``, ``lattice_substep_jit``
  and the compiled ``directed_frame`` on ``device="cpu"`` (where they run
  their functions) against the JAX package's jitted functions on the
  same numpy inputs.  Tolerances: tests/test_torch_general_frame.py's
  (pos atol 2e-3, vel atol 4e-3, beam liveness equal): XLA's CPU jit
  contracts and reorders float sums that the port evaluates op by op.
  K3 is not on this path here: JAX runs ``use_pallas=False`` on the CPU,
  as its own tests do.
- The cache's logic, driven through a stand-in graph (``RecordingGraph``:
  its capture runs the function once and keeps it, its replay runs it
  again on the static inputs and writes the results into the captured
  outputs, as a CUDA graph's replay overwrites them): the user input
  lifted (a drag replays one graph; tests/test_torch_drag.py drags
  every compiled family), two states alternating through one graph, the first
  call advancing the state once, the launch counters counting replays,
  a function that writes into its inputs refused, the bound, and the
  dense backend's chunks keyed by length and list capacity."""

import dataclasses

import numpy as np
import pytest
import torch

import softbody_tpu as sb
from softbody_tpu.models import tearing_cloth_lattice as j_tearing
from softbody_tpu.models import scenes as jscenes
from softbody_tpu.ops.directed import build_directed as j_build_directed
from softbody_tpu.ops.directed import directed_frame as j_directed_frame
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.farfield import rebuild_far_list as j_rebuild
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.ops.stencil import lattice_frame_far_jit as j_frame_far
from softbody_tpu.ops.stencil import lattice_frame_jit as j_lattice_frame
from softbody_tpu.ops.stencil import lattice_substep_jit as j_lsubstep
from softbody_tpu.ops.step import frame_jit as j_frame_jit
from softbody_tpu.ops.step import substep_jit as j_substep_jit
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    lattice_state_to_numpy,
    sim_state_to_numpy,
)
from softbody_tpu_torch.engine import LatticeBackend
from softbody_tpu_torch.models import scenes as tscenes
from softbody_tpu_torch.ops import compiled, step as tstep
from softbody_tpu_torch.ops.cuda import collide_stencil, fused_substep2
from softbody_tpu_torch.ops.directed import (
    build_directed,
    directed_frame,
    directed_frame_jit,
)
from softbody_tpu_torch.ops.farfield import FarFieldSpec, rebuild_far_list
from softbody_tpu_torch.ops.stencil import (
    LatticeSpec,
    lattice_frame,
    lattice_frame_far,
    lattice_frame_far_jit,
    lattice_frame_jit,
    lattice_substep_jit,
)

from test_farfield import RADIUS, hairpin
from test_torch_directed import _blobs
from test_torch_general import _cfgs
from torch_capture import RecordingGraph
from torch_parity import (
    consts_to_port,
    jittered,
    random_state,
    sim_to_jax,
    sim_to_port,
    to_jax,
    to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

POS_ATOL, VEL_ATOL = 2e-3, 4e-3


def _hold(got, ref, alive="beam_alive"):
    np.testing.assert_array_equal(got[alive], ref[alive])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0,
                               atol=VEL_ATOL)


def _cloth_fields(seed=3):
    jst, cfg = jscenes.cloth(8, 8)
    return jittered(sim_state_to_numpy(jst), seed, 0.5, 3.0), cfg


def _lattice_edges_alive(arrays):
    return np.stack([e["alive"] for e in arrays["edges"]])


def _hold_lattice(got, ref):
    g, r = dict(got), dict(ref)
    g["edges alive"] = _lattice_edges_alive(got)
    r["edges alive"] = _lattice_edges_alive(ref)
    _hold(g, r, alive="edges alive")


# ---------------------------------------------------------------------------
# JAX parity


def test_frame_jit_matches_jax():
    """Two frames of the jittered ``cloth(8, 8)`` at 16 subticks."""
    f, cfg = _cloth_fields()
    jc, tc = _cfgs(cfg, subticks=16)
    consts, uin = sb.PhysicsConstants.default(), sb.UserInput.none()
    js = sim_to_jax(f)
    for _ in range(2):
        js = j_frame_jit(js, consts, uin, jc)
    tconsts, tuin = consts_to_port(consts), uin_to_port(uin)
    ts = sim_to_port(f)
    for _ in range(2):
        ts = tstep.frame_jit(ts, tconsts, tuin, tc)
    got = sim_state_to_numpy(ts)
    _hold(got, sim_state_to_numpy(js))
    eager = sim_state_to_numpy(tstep.run_frames(sim_to_port(f), tconsts,
                                                tuin, tc, 2))
    for k in ("pos", "vel", "acc", "beam_alive", "beam_target_length"):
        np.testing.assert_array_equal(got[k], eager[k], err_msg=k)


def test_substep_jit_matches_jax():
    """Eight substeps of the jittered cloth, all pairs, quantized."""
    f, cfg = _cloth_fields(seed=4)
    jc, tc = _cfgs(cfg, collision_mode="allpairs", collision_tile=32)
    consts, uin = sb.PhysicsConstants.default(), sb.UserInput.none()
    js, ts = sim_to_jax(f), sim_to_port(f)
    for _ in range(8):
        js = j_substep_jit(js, consts, uin, jc)
        ts = tstep.substep_jit(ts, consts_to_port(consts), uin_to_port(uin),
                               tc)
    _hold(sim_state_to_numpy(ts), sim_state_to_numpy(js))


def _lattice_48():
    """A 48 × 48 lattice, jittered so that springs yield and particles
    collide (``torch_parity.random_state``), and its configurations."""
    arrays = random_state(48, 48, seed=11, jitter=1.0)
    jcfg = sb.StaticConfig(subticks=8, collision_mode="allpairs",
                           particle_radius=RADIUS, force_mode="quantized")
    tcfg = tb.StaticConfig(subticks=8, collision_mode="allpairs",
                           particle_radius=RADIUS, force_mode="quantized")
    return arrays, JLatticeSpec(48, 48), LatticeSpec(48, 48), jcfg, tcfg


def test_lattice_frame_jit_matches_jax():
    """The 48 × 48 slit tearing cloth, 16 substeps (a quarter frame: the
    jitted frame's contracted sums part from the port's by ~2e-3 in
    velocity there, ~9e-3 after 64)."""
    js, jspec, jcfg, consts = j_tearing(
        n_particles=48 * 48, fall_speed=2.5, slits=2, strain_limit=0.22,
        yield_strain=0.18)
    arrays = lattice_state_to_numpy(js)
    _jc, tcfg = _cfgs(jcfg)
    uin = sb.UserInput.none()
    ref = j_lattice_frame(to_jax(arrays), consts, uin, jspec, jcfg,
                          n_sub=16)
    got = lattice_frame_jit(to_port(to_jax(arrays)), consts_to_port(consts),
                            uin_to_port(uin), LatticeSpec(48, 48), tcfg,
                            n_sub=16)
    _hold_lattice(lattice_state_to_numpy(got), lattice_state_to_numpy(ref))


def test_lattice_substep_jit_matches_jax():
    arrays, jspec, tspec, jcfg, tcfg = _lattice_48()
    consts, uin = sb.PhysicsConstants.default(), sb.UserInput.none()
    ref = lattice_state_to_numpy(j_lsubstep(to_jax(arrays), consts, uin,
                                            jspec, jcfg))
    got = lattice_state_to_numpy(lattice_substep_jit(
        to_port(to_jax(arrays)), consts_to_port(consts), uin_to_port(uin),
        tspec, tcfg))
    _hold_lattice(got, ref)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def test_lattice_frame_far_jit_matches_jax():
    """The small fold (the hairpin strip), far-armed with one list for
    the frame."""
    ls = hairpin()
    w, h = ls.shape
    ts = to_port(ls)  # before JAX's frame donates ``ls``
    kw = dict(subticks=8, collision_mode="allpairs", particle_radius=RADIUS,
              force_mode="quantized")
    ff = dict(max_pairs=512, max_tile_pairs=64, skin=8.0, horizon=8)
    consts, uin = sb.PhysicsConstants.default(), sb.UserInput.none()
    jfl = j_rebuild(ls.pos, ls.alive, s=2, ff=JFarFieldSpec(**ff),
                    radius=RADIUS)
    ref = j_frame_far(ls, jfl, consts, uin, JLatticeSpec(w, h),
                      sb.StaticConfig(**kw), JFarFieldSpec(**ff))
    tfl = rebuild_far_list(ts.pos, ts.alive, s=2, ff=FarFieldSpec(**ff),
                           radius=RADIUS)
    assert tfl.counts()[0] > 0, "the fold must yield far pairs"
    got = lattice_frame_far_jit(ts, tfl, consts_to_port(consts),
                                uin_to_port(uin), LatticeSpec(w, h),
                                tb.StaticConfig(**kw), FarFieldSpec(**ff))
    _hold_lattice(lattice_state_to_numpy(got), lattice_state_to_numpy(ref))


def test_directed_frame_matches_jax():
    """The jittered blobs, 4 substeps of the directed frame (JAX's is
    jitted and donating; the port's compiled one runs its loop here)."""
    fields = _blobs()
    cfg = sb.StaticConfig(subticks=8, collision_mode="grid",
                          particle_radius=8.0, force_mode="quantized")
    _jc, tcfg = _cfgs(cfg)
    consts, uin = sb.PhysicsConstants.default(), sb.UserInput.none()
    jds, _ = j_build_directed(sim_to_jax(fields))
    ds, _ = build_directed(sim_to_port(fields))
    ref = j_directed_frame(jds, consts, uin, cfg, n_sub=4)
    got = directed_frame(ds, consts_to_port(consts), uin_to_port(uin),
                         tcfg, n_sub=4)
    assert directed_frame_jit is directed_frame
    np.testing.assert_array_equal(got.slot_alive.numpy(),
                                  np.asarray(ref.slot_alive))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=0, atol=VEL_ATOL)


def test_cpu_calls_run_the_function():
    """On CPU tensors the compiled frame is the function itself: no
    capture, the same bits, the input untouched."""
    f, cfg = _cloth_fields()
    _jc, tc = _cfgs(cfg, subticks=4)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    before = tstep.frame_jit.stats()
    st = sim_to_port(f)
    got = tstep.frame_jit(st, consts, uin, tc)
    ref = tstep.frame(sim_to_port(f), consts, uin, tc)
    assert tstep.frame_jit.stats() == before
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    np.testing.assert_array_equal(st.pos.numpy(), f["pos"])


# ---------------------------------------------------------------------------
# the cache's logic, through a stand-in graph


def _recording(fn, static):
    return compiled.Compiled(fn, static_argnames=static,
                             graph_cls=RecordingGraph)


def _cloth(side=6, subticks=4):
    st, cfg = tscenes.cloth(side, side, device="cpu")
    f = jittered(sim_state_to_numpy(st), 2, 0.5, 3.0)
    return f, dataclasses.replace(cfg, subticks=subticks)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(compiled.tensors(a),
                                                 compiled.tensors(b)))


def test_mouse_drag_misses_and_matches_eager():
    """A drag: four frames, each with another mouse position and
    velocity, one miss and one capture (the user input is lifted into
    the graph's inputs, as ``jax.jit`` traces it), each frame equal to
    the eager frame; the last input again replays.  -0.0 and 0.0 are one
    key too (their bits reach the graph as data), and each frame still
    equals the eager frame bit for bit."""
    f, cfg = _cloth()
    frame = _recording(tstep.frame, ("cfg",))
    consts = tb.PhysicsConstants()
    st = ref = sim_to_port(f)
    for i in range(4):
        uin = tb.UserInput(mouse_active=True, user_strength=2.0,
                           mouse_pos=(200.0 + 10 * i, 500.0),
                           mouse_vel=(30.0, -5.0 * i))
        st = frame(st, consts, uin, cfg)
        ref = tstep.frame(ref, consts, uin, cfg)
        assert _same(st, ref), f"drag frame {i}"
    assert frame.stats() == {"misses": 1, "captures": 1, "replays": 4,
                             "graphs": 1}
    frame(st, consts, uin, cfg)
    assert frame.stats()["misses"] == 1 and frame.stats()["replays"] == 5
    for zero in (-0.0, 0.0):
        uin = tb.UserInput(mouse_active=True, mouse_vel=(zero, 0.0),
                           mouse_pos=tuple(st.pos[5].tolist()))
        assert _same(frame(st, consts, uin, cfg),
                     tstep.frame(st, consts, uin, cfg)), zero
    assert frame.stats()["misses"] == 1 and frame.stats()["replays"] == 7


def test_two_states_alternate_through_one_graph():
    """Two independent states through the same compiled frame in turns:
    one capture, and each trajectory equals its eager one, every
    returned state intact after the other state's calls."""
    f, cfg = _cloth()
    g = jittered(f, 9, 2.0, 20.0)
    frame = _recording(tstep.frame, ("cfg",))
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    runs = {"a": [sim_to_port(f)], "b": [sim_to_port(g)]}
    for _ in range(3):
        for k in ("a", "b"):
            runs[k].append(frame(runs[k][-1], consts, uin, cfg))
    assert frame.stats()["captures"] == 1
    assert frame.stats()["replays"] == 6
    for k, fields in (("a", f), ("b", g)):
        ref = sim_to_port(fields)
        for i in range(1, 4):
            ref = tstep.frame(ref, consts, uin, cfg)
            assert _same(runs[k][i], ref), f"state {k} frame {i}"
    assert not torch.equal(runs["a"][3].pos, runs["b"][3].pos)


def test_first_call_advances_once_and_passes_inputs_through():
    """Warm-up, capture and the first replay together advance the state
    by one frame; the input stays valid; an unchanged field comes back
    as the caller's own tensor, a changed one as a new tensor."""
    f, cfg = _cloth()
    frame = _recording(tstep.frame, ("cfg",))
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    st = sim_to_port(f)
    got = frame(st, consts, uin, cfg)
    assert _same(got, tstep.frame(sim_to_port(f), consts, uin, cfg))
    np.testing.assert_array_equal(st.pos.numpy(), f["pos"])
    assert got.beam_length is st.beam_length
    assert got.pos is not st.pos


def test_launch_counters_count_replays():
    """A frame whose 'kernels' bump K3's counter once a substep and K1's
    instance counter once a frame: the counters read the replays' launches
    only, not the warm-up's or the capture's."""
    inst = next(iter(fused_substep2.K1_INSTANCE_LAUNCHES))

    def fn(state, consts, uin, cfg):
        for _ in range(cfg.subticks):
            collide_stencil.K3_LAUNCHES += 1
            state = tstep.substep(state, consts, uin, cfg)
        fused_substep2.K1_INSTANCE_LAUNCHES[inst] += 1
        return state

    f, cfg = _cloth()
    frame = _recording(fn, ("cfg",))
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    k3 = collide_stencil.K3_LAUNCHES
    k1 = fused_substep2.K1_INSTANCE_LAUNCHES[inst]
    st = sim_to_port(f)
    for _ in range(3):
        st = frame(st, consts, uin, cfg)
    assert collide_stencil.K3_LAUNCHES - k3 == 3 * cfg.subticks
    assert fused_substep2.K1_INSTANCE_LAUNCHES[inst] - k1 == 3


def test_frame_writing_its_input_is_refused():
    def fn(state, consts, uin, cfg):
        state.vel.mul_(0.5)
        return tstep.frame(state, consts, uin, cfg)

    f, cfg = _cloth()
    with pytest.raises(RuntimeError, match="writes into its inputs"):
        _recording(fn, ("cfg",))(sim_to_port(f), tb.PhysicsConstants(),
                                 tb.UserInput(), cfg)
    with pytest.raises(ValueError, match="no arguments"):
        compiled.Compiled(tstep.frame, static_argnames=("spec",))


def test_cache_is_bounded(monkeypatch):
    """Keys that differ in a static argument (the substeps of ``cfg``):
    at most ``MAX_GRAPHS`` graphs kept, the least recently used dropped
    (the last call's key was dropped, so it misses again)."""
    monkeypatch.setattr(compiled, "MAX_GRAPHS", 2)
    f, cfg = _cloth(subticks=2)
    frame = _recording(tstep.frame, ("cfg",))
    consts, uin, st = tb.PhysicsConstants(), tb.UserInput(), sim_to_port(f)
    for n in (2, 4, 6, 2):
        frame(st, consts, uin, dataclasses.replace(cfg, subticks=n))
    assert frame.stats() == {"misses": 4, "captures": 4, "replays": 4,
                             "graphs": 2}


def test_lattice_backend_graphs_per_chunk_and_capacity():
    """The dense backend's far-armed frames on the folded strip through
    stand-in graphs: equal to the backend stepping eagerly bit for bit,
    with the same rebuilds and chunks, one graph per (chunk length, list
    capacity) met, and repeated keys replayed."""
    ls = hairpin()
    w, h = ls.shape
    cfg = tb.StaticConfig(subticks=8, collision_mode="allpairs",
                          particle_radius=RADIUS, force_mode="quantized")
    spec = LatticeSpec(w, h, collision_stencil=2)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    eager = LatticeBackend(spec, cfg, farfield=ff, device="cpu")
    eager._frame, eager._frame_far = lattice_frame, lattice_frame_far
    graphs = LatticeBackend(spec, cfg, farfield=ff, device="cpu")
    graphs._frame = _recording(lattice_frame, ("spec", "cfg", "n_sub"))
    graphs._frame_far = _recording(lattice_frame_far,
                                   ("spec", "cfg", "ffspec", "n_sub"))
    a = b = to_port(ls)
    for _ in range(3):
        a = eager.step(a, consts, uin)
        b = graphs.step(b, consts, uin)
        assert _same(a, b)
    assert graphs.far_stats() == eager.far_stats()
    assert graphs.far_chunks == eager.far_chunks
    assert eager.far_stats()["far_pairs"] > 0
    st = graphs._frame_far.stats()
    assert st["replays"] + graphs._frame.stats()["replays"] \
        == graphs.far_chunks
    assert 1 <= st["captures"] < st["replays"]
