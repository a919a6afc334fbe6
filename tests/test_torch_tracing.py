"""The port's tracer (``utils/profiling.py``): host spans, device marks in
the captured frames, and whether tracing is on as part of a compiled
frame's key.  CPU tests through ``torch_capture.RecordingGraph`` (a
stand-in graph that runs the function again on replay), and one card
test (marker ``cuda``: ``python -m pytest tests/test_torch_tracing.py -m
cuda --noconftest`` there).  JAX-free."""

import dataclasses
import functools

import pytest
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.engine.backends import (
    FusedLatticeBackend,
    PlanifiedBackend,
)
from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
from softbody_tpu_torch.models.scenes import self_colliding_cloth
from softbody_tpu_torch.ops import compiled
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec
from softbody_tpu_torch.utils import profiling
from torch_capture import RecordingGraph
from torch_threads import two_torch_threads  # noqa: F401

CALL_CHILDREN = ["compiled.key", "compiled.lock", "compiled.fill",
                 "compiled.replay", "compiled.out"]


@pytest.fixture(autouse=True)
def empty_log():
    """Each test starts and ends with the tracer off and its log empty."""
    assert not profiling.enabled()
    profiling.drain()
    yield
    profiling.drain()
    assert not profiling.enabled()


@pytest.fixture
def ranges(monkeypatch):
    """A count of the ``record_function`` ranges the tracer opens."""
    opened = []
    real = profiling.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    return opened


def _recording(jit):
    """``jit`` (a ``compiled.Compiled``) captured by the stand-in graph."""
    return compiled.Compiled(jit.fn, static_argnames=jit.static_argnames,
                             decide=jit.decide, graph_cls=RecordingGraph)


def _marked(x, n_marks: int = 3):
    """A frame function with device marks around its two layers."""
    profiling.device_mark("a", x)
    y = x * 2.0
    for _ in range(n_marks - 2):
        profiling.device_mark("b", y)
    y = y + 1.0
    profiling.device_mark("end", y)
    return y


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent == parent.id]


def test_tracing_off_records_nothing_and_opens_no_range(ranges):
    assert profiling.span("a") is profiling.span("b")
    jit = compiled.Compiled(_marked, graph_cls=RecordingGraph)
    x = torch.arange(4.0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("frame"):
            profiling.device_mark("rebuild", x)
            jit(x)
            jit(x)
    got = profiling.drain()
    assert got.spans == [] and got.marks == {} and ranges == []
    assert jit.stats()["misses"] == 1
    # the same under tracing: every span a profiler range
    with profiling.tracing():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("frame"):
                jit(x)
    spans = profiling.drain().spans
    assert sorted(ranges) == sorted(s.name for s in spans)
    assert "compiled.call" in ranges


def test_nested_spans_carry_parent_and_frame_ids():
    x = torch.zeros(2)
    with profiling.tracing():
        with profiling.span("frame") as top:
            with profiling.span("a") as a:
                profiling.device_mark("first", x)
                with profiling.span("b") as b:
                    profiling.device_mark("second", x)
            profiling.device_mark("end", x)
        with profiling.span("next") as nxt:
            pass
    got = profiling.drain()
    assert [s.name for s in got.spans] == ["b", "a", "frame", "next"]
    assert (top.parent, a.parent, b.parent) == (None, top.id, a.id)
    assert top.frame == a.frame == b.frame == top.id
    assert nxt.frame == nxt.id != top.id and nxt.parent is None
    assert all(s.end_ns >= s.start_ns for s in got.spans)
    assert b.start_ns >= a.start_ns and b.end_ns <= a.end_ns
    marks = got.marks[top.id]
    assert [label for label, _ns in marks] == ["first", "second", "end"]
    split = got.split()[top.id]
    assert set(split) == {"first", "second"}
    assert sum(split.values()) == pytest.approx(
        (marks[-1][1] - marks[0][1]) / 1e6)


def test_a_compiled_call_spans_its_phases_and_a_capture_on_a_miss_only():
    jit = compiled.Compiled(_marked, graph_cls=RecordingGraph)
    x = torch.arange(4.0)
    with profiling.tracing():
        first = jit(x)
        second = jit(x)
    assert torch.equal(first, second)
    spans = profiling.drain().spans
    calls = [s for s in spans if s.name == "compiled.call"]
    assert len(calls) == 2 and all(c.parent is None for c in calls)
    want = CALL_CHILDREN[:2] + ["compiled.capture"] + CALL_CHILDREN[2:]
    assert _children(spans, calls[0]) == want
    assert _children(spans, calls[1]) == CALL_CHILDREN
    assert all(s.frame == c.frame for c in calls for s in spans
               if s.parent == c.id)


def test_tracing_is_part_of_the_key():
    """A graph captured with tracing off holds no marks; turning tracing
    on captures another, and turning it off again replays the first."""
    jit = compiled.Compiled(_marked, graph_cls=RecordingGraph)
    x = torch.arange(4.0)
    ref = jit(x)
    with profiling.tracing():
        traced = jit(x)
        again = jit(x)
    assert jit.stats()["misses"] == 2
    after = jit(x)
    assert jit.stats() == {"misses": 2, "captures": 2, "replays": 4,
                           "graphs": 2}
    assert all(torch.equal(ref, y) for y in (traced, again, after))
    marks = profiling.drain().marks
    assert [[label for label, _ns in m] for m in marks.values()] == [
        ["a", "b", "end"]] * 2


def test_a_frame_with_more_marks_than_the_buffer_raises(monkeypatch):
    monkeypatch.setattr(profiling.Marks, "CAPACITY", 4)
    x = torch.arange(4.0)
    fits = compiled.Compiled(functools.partial(_marked, n_marks=4),
                             graph_cls=RecordingGraph)
    over = compiled.Compiled(functools.partial(_marked, n_marks=5),
                             graph_cls=RecordingGraph)
    with profiling.tracing():
        fits(x)
        with pytest.raises(RuntimeError, match="more than 4 device marks"):
            over(x)


# ------------------------------------------------- the cells' two frames


@functools.lru_cache(maxsize=None)
def _fused():
    """The folded strip, far-armed: 5 substeps in blocks of 2, 2, 1, far
    pairs found."""
    spec = LatticeSpec(16, 8, collision_stencil=2)
    cfg = tb.StaticConfig(subticks=5, particle_radius=5.0)
    ff = FarFieldSpec(skin=8.0, horizon=2, max_pairs=128, max_tile_pairs=32)
    return spec, cfg, ff, 3


def _fused_backend(device, recorded):
    spec, cfg, ff, blocks = _fused()
    be = FusedLatticeBackend(spec, cfg, farfield=ff, device=device)
    if recorded:
        be._frame4 = _recording(be._frame4)
    state = be.pack_state(folded_strip_lattice(16, 8, device=device))
    return be, state, cfg.subticks, blocks


@functools.lru_cache(maxsize=None)
def _planified_scene():
    flat, cfg = self_colliding_cloth(600, device="cpu")
    cfg = dataclasses.replace(cfg, subticks=6)
    ff = FarFieldSpec(skin=3.0 * cfg.particle_radius, horizon=4,
                      max_pairs=512)
    return flat, cfg, ff


def _planified_backend(device, recorded):
    flat, cfg, ff = _planified_scene()
    be = PlanifiedBackend(cfg, collision_stencil=3, farfield=ff,
                          device=device)
    if recorded:
        be._frame_far = _recording(be._frame_far)
    return be, be.pack_state(flat), cfg.subticks, 2


BACKENDS = {"fused_frame4": _fused_backend,
            "planified_frame_far": _planified_backend}


@pytest.mark.parametrize("recorded", [False, True],
                         ids=["eager", "captured"])
@pytest.mark.parametrize("frame", sorted(BACKENDS))
def test_frame_marks_each_layer_and_traced_outputs_are_bit_identical(
        frame, recorded):
    be, state, n_sub, blocks = BACKENDS[frame]("cpu", recorded)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    ref = be.step(state, consts, uin)
    profiling.drain()
    with profiling.tracing():
        got = be.step(state, consts, uin)
    log = profiling.drain()
    assert all(torch.equal(a, b) for a, b in zip(compiled.tensors(ref),
                                                 compiled.tensors(got)))
    steps = [s for s in log.spans if s.name == "backend.step"]
    assert len(steps) == 1
    labels = [label for label, _ns in log.marks[steps[0].id]]
    assert labels.count("rebuild") == blocks
    assert labels.count("far_apply") == labels.count("substep") == n_sub
    assert labels[0] == "rebuild" and labels[-1] == "end"
    assert labels.count("end") == 1
    names = {s.name for s in log.spans}
    assert {"backend.step", "backend.stats"} <= names
    assert ("compiled.replay" in names) == recorded
    assert be.far_stats()["far_rebuilds"] == 2 * blocks
    assert "backend.far_stats" not in names


@pytest.mark.cuda
def test_captured_traced_frame_stamps_rise_and_output_matches_untraced():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sb_stamp has no CPU mode)")
    be, state, n_sub, blocks = _fused_backend("cuda", False)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    ref = be.step(state, consts, uin)
    with profiling.tracing():
        be.step(state, consts, uin)          # the traced capture
        profiling.drain()
        got = be.step(state, consts, uin)
    log = profiling.drain()
    assert be._frame4.stats()["misses"] == 2
    assert all(torch.equal(a, b) for a, b in zip(compiled.tensors(ref),
                                                 compiled.tensors(got)))
    (marks,) = log.marks.values()
    assert len(marks) == blocks + 2 * n_sub + 1
    stamps = [ns for _label, ns in marks]
    assert all(b >= a for a, b in zip(stamps, stamps[1:]))
    assert stamps[-1] > stamps[0]
