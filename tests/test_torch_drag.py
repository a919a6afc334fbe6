"""A mouse drag and a slider through the compiled frames, on the CPU.

A compiled frame (``ops/compiled.py``) lifts the float and bool leaves
of its arguments (every field of ``PhysicsConstants`` and ``UserInput``)
into a buffer it copies before each replay, as ``jax.jit`` traces them:
so a drag replays one graph.  Each family runs here through a stand-in
graph (``test_torch_compiled.RecordingGraph``: its replay runs the
function again on the capture's static inputs): four frames with the
mouse grabbing at a new position and velocity, another user strength and
keyboard force each frame, then one frame with another friction (a
slider).  Each takes one capture and four replays after it, and every
frame equals the function run eagerly on the same inputs bit for bit: a
value still read on the host at capture would replay the captured
frame's input and part from it.  The first drag frame differs from a
frame without input (the input reaches the physics).

The families: the general frame (``step.frame_jit``), the dense
far-armed frame (``stencil.lattice_frame_far_jit``), the fused frame
(``fused_substep2.fused_frame4_jit`` in two blocks), the planified
far-armed frame (``planify.planified_frame_far_jit``, on the fold with
−0.0 velocities) and path B (``fused_substep.fused_frame_jit``)."""

import dataclasses

import numpy as np
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import planified_state_from_numpy
from softbody_tpu_torch.ops import compiled
from softbody_tpu_torch.ops import planify as tplanify
from softbody_tpu_torch.ops import step as tstep
from softbody_tpu_torch.ops.cuda import fused_substep as tfs
from softbody_tpu_torch.ops.cuda import fused_substep2 as P
from softbody_tpu_torch.ops.farfield import FarFieldSpec, rebuild_far_list
from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_frame_far_jit

from kernel_cases import same_bits
from test_farfield import RADIUS, hairpin
from test_torch_compiled import RecordingGraph, _cloth
from test_torch_frame import HAIRPIN_CFG, HAIRPIN_FF
from test_torch_planify_far import FOLD_CFG, FOLD_FF, _fold, _port_spec
from torch_parity import random_state, sim_to_port, to_jax, to_port
from torch_threads import two_torch_threads  # noqa: F401

N_DRAG = 4


def _recording(jit):
    """``jit`` (a ``compiled.Compiled``) with its static arguments and host
    decisions, captured by the stand-in graph."""
    return compiled.Compiled(jit.fn, static_argnames=jit.static_argnames,
                             decide=jit.decide, graph_cls=RecordingGraph)


def _same(a, b) -> bool:
    """Every tensor of ``a`` equal to ``b``'s bit for bit, NaN where NaN
    (a particle the grab flings out of the world turns NaN)."""
    ta, tb_ = list(compiled.tensors(a)), list(compiled.tensors(b))
    return len(ta) == len(tb_) and all(
        same_bits(x, y) if x.is_floating_point() else torch.equal(x, y)
        for x, y in zip(ta, tb_))


def _inputs(anchor):
    """The drag's ``(consts, uin)`` per frame: the mouse grabbing near
    ``anchor`` (a particle's position), moving, with another strength and
    keyboard force each frame; then the last input with a friction
    slider moved."""
    consts = tb.PhysicsConstants()
    out = []
    for i in range(N_DRAG):
        out.append((consts, tb.UserInput(
            mouse_active=True, user_strength=1.0 + 0.5 * i,
            mouse_pos=(anchor[0] + 3.0 * i, anchor[1] - 2.0 * i),
            mouse_vel=(12.0 - 5.0 * i, -3.0 * i),
            applied_force=(0.2 * i, -0.1 * i))))
    out.append((dataclasses.replace(consts, friction=0.4), out[-1][1]))
    return out


def _drag(jit, run, state, anchor):
    """The drag through ``jit``'s recording twin and through its function
    in turns; ``run(fn, state, consts, uin)`` returns the new state (and
    whatever else the frame returns)."""
    rec = _recording(jit)
    got = ref = state
    for i, (consts, uin) in enumerate(_inputs(anchor)):
        got = run(rec, got, consts, uin)
        ref = run(jit.fn, ref, consts, uin)
        assert _same(got, ref), f"drag frame {i}"
        if i == 0:
            still = run(jit.fn, state, consts, tb.UserInput())
            assert not _same(got, still), "the input changed nothing"
    assert rec.stats() == {"misses": 1, "captures": 1,
                           "replays": N_DRAG + 1, "graphs": 1}


def test_general_frame_drag_replays_one_graph():
    f, cfg = _cloth()
    st = sim_to_port(f)
    _drag(tstep.frame_jit, lambda fn, s, c, u: fn(s, c, u, cfg), st,
          st.pos[5].tolist())


def test_lattice_frame_far_drag_replays_one_graph():
    ls = hairpin()
    w, h = ls.shape
    cfg = tb.StaticConfig(**HAIRPIN_CFG)
    ff = FarFieldSpec(**HAIRPIN_FF)
    spec = LatticeSpec(w, h)
    st = to_port(ls)
    fl = rebuild_far_list(st.pos, st.alive, s=2, ff=ff, radius=RADIUS)
    assert fl.counts()[0] > 0

    def run(fn, s, c, u):
        return fn(s, fl, c, u, spec, cfg, ff, n_sub=2)

    _drag(lattice_frame_far_jit, run, st, st.pos[w // 2, 1].tolist())


def test_fused_frame4_drag_replays_one_graph():
    """Two blocks of two substeps, each block rebuilding; the fold's far
    pairs found."""
    tl = to_port(hairpin())
    w, h = tl.shape
    hot, obs, immut, ec = P.pack_lattice2(tl)
    cfg = tb.StaticConfig(**HAIRPIN_CFG)
    ff = FarFieldSpec(**dict(HAIRPIN_FF, horizon=2))
    spec = LatticeSpec(w, h)

    def run(fn, s, c, u):
        hot_, obs_, st = fn(s[0], s[1], immut, ec, c, u, spec, cfg, ff,
                            n_sub=4, buckets=(16,), band_impl="plain")
        assert int(st[0]) == 2 and int(st[1]) > 0
        return hot_, obs_

    _drag(P.fused_frame4_jit, run, (hot, obs),
          tl.pos[w // 2, 1].tolist())


def test_planified_frame_far_drag_replays_one_graph():
    """The fold with its zero velocities −0.0 (a zero delta plane added
    to a −0.0 would give +0.0; the collision sums it joins are never
    −0.0): two rebuilds a frame, its far pairs found."""
    fields, spec, _aux = _fold()
    lat = dict(fields["lat"])
    vel = np.array(lat["vel"])
    vel[vel == 0.0] = -0.0
    lat["vel"] = vel
    ps = planified_state_from_numpy(**dict(fields, lat=lat), device="cpu")
    assert bool(torch.signbit(ps.lat.vel).any())
    tspec, cfg = _port_spec(spec), tb.StaticConfig(**FOLD_CFG)
    ff = FarFieldSpec(**FOLD_FF)

    def run(fn, s, c, u):
        ps_, st = fn(s, c, u, tspec, cfg, ff)
        assert int(st[0]) == 2 and int(st[1]) > 0
        return ps_

    alive = ps.lat.alive.reshape(-1)
    anchor = ps.lat.pos.reshape(-1, 2)[alive][0].tolist()
    _drag(tplanify.planified_frame_far_jit, run, ps, anchor)


def test_fused_frame_path_b_drag_replays_one_graph():
    arrays = random_state(12, 10, seed=7, varied=True)
    ts = to_port(to_jax(arrays))
    mut, immut = tfs.pack_lattice(ts)
    cfg = tb.StaticConfig(subticks=2, particle_radius=9.0,
                          collision_mode="allpairs")
    spec = LatticeSpec(12, 10, collision_stencil=2)
    _drag(tfs.fused_frame_jit, lambda fn, s, c, u: fn(s, immut, c, u, spec,
                                                      cfg),
          mut, ts.pos[6, 5].tolist())
