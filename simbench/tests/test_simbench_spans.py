"""The readers of the program's spans (``simbench/spans.py``): the idle
gaps put down to the innermost program span, the compiled call's host
time without its captures, and the traced episodes on the host, which
leave tracing off and give no device reading there."""

import types

import pytest

from simbench import harness, spans
from softbody_tpu_torch.utils import profiling

from .conftest import HostCard, HostCell


def test_idle_gaps_go_to_the_innermost_span():
    # µs: a call holding a fill then a replay; a gap outside any span
    program = [(0, 100, "compiled.call"), (10, 40, "compiled.fill"),
               (40, 90, "compiled.replay"), (200, 300, "backend.stats")]
    ops = [(0, 15), (20, 30), (35, 45), (60, 70), (95, 110), (150, 160),
           (170, 180)]
    got = spans.idle_by_span(ops, program, frames=2)
    # 15→20 and 30→35 in the fill, 45→60 in the replay, 70→95 in the
    # replay, 110→150 and 160→170 in no span
    assert got["by_span"] == pytest.approx(
        {"compiled.fill": 0.010 / 2, "compiled.replay": 0.040 / 2})
    assert got["ms"] == pytest.approx(0.025)
    assert spans.idle_by_span([], program, 2) == {"ms": 0.0, "by_span": {}}
    # a graph's own range (its first to last mark) holds no host idle
    inside = spans.idle_by_span(ops, program, 2, graphs=[(35, 72)])
    assert inside["by_span"] == pytest.approx(
        {"compiled.fill": 0.010 / 2, "compiled.replay": 0.025 / 2})


def test_idle_is_the_median_episodes():
    # µs: three episodes, each ending with its far-stats read
    program = [(0, 50, "compiled.call"), (50, 60, "backend.far_stats"),
               (100, 150, "compiled.call"), (150, 160, "backend.far_stats"),
               (200, 250, "compiled.call"), (250, 260, "backend.far_stats")]
    ops = [(0, 10), (20, 30), (100, 110), (140, 150), (200, 210),
           (215, 220)]
    eps = spans.by_episode(ops, program)
    assert [len(o) for o, _s in eps] == [2, 2, 2]
    assert [len(s) for _o, s in eps] == [2, 2, 2]
    idle = [spans.idle_by_span(o, s, frames=1) for o, s in eps]
    assert [i["ms"] for i in idle] == pytest.approx([0.010, 0.030, 0.005])
    assert spans.median_episode(idle)["ms"] == pytest.approx(0.010)
    assert spans.median_episode(idle[:2])["ms"] == pytest.approx(0.010)
    assert spans.median_episode([]) is None
    assert spans.by_episode(ops, program[:1]) == []


def test_graph_ranges_take_each_frames_stamps():
    stamps = [(5, 6), (1, 2), (3, 4), (10, 11), (12, 13)]
    assert spans.graph_ranges(stamps, [3, 2]) == [(1, 6), (10, 13)]
    assert spans.graph_ranges(stamps[:4], [3, 2]) == [(1, 6)]


def test_innermost_segments_of_nested_spans():
    segs = spans.innermost([(0, 10, "a"), (0, 4, "b"), (6, 10, "c")])
    assert segs == [(0, 4, "b"), (4, 6, "a"), (6, 10, "c")]


def _span(name, i, parent, frame, start, end):
    return profiling.Span(name, i, parent, frame, start * 10**6,
                          end * 10**6)


def test_replay_host_leaves_out_the_capture():
    log = [_span("compiled.capture", 3, 2, 1, 1, 5),
           _span("compiled.call", 2, 1, 1, 0, 7),
           _span("backend.step", 1, None, 1, 0, 8),
           _span("compiled.call", 5, 4, 4, 10, 12),
           _span("backend.step", 4, None, 4, 10, 13),
           _span("compiled.call", 7, 6, 6, 20, 23.5),
           _span("backend.step", 6, None, 6, 20, 24)]
    assert spans.replay_host_ms(log) == pytest.approx(3.0)
    assert spans.replay_host_ms([]) is None
    self_ms = spans.host_self_ms(log, frames=3)
    assert self_ms["backend.step"] == pytest.approx((1 + 1 + 0.5) / 3)
    assert self_ms["compiled.capture"] == pytest.approx(4.0 / 3)


class _Fall(HostCell):
    frames = 1


def test_traced_episodes_on_the_host(bench):
    """The fall at a small size, one frame an episode: every frame marks
    each layer, the compiled call is timed, and tracing is off again; on
    a card that is not CUDA the readers give nothing."""
    cell = _Fall("cloth1m-fall", bench)
    card = HostCard()
    sim = cell.config.Sim(7, card.device)
    loop = cell.loop.Loop(sim, cell.mix, 7, card)
    loop.setup()
    got = spans._marks(loop, sim, profiling)
    host = spans._host(loop, sim, profiling)
    assert not profiling.enabled()
    assert len(got["split"]) == loop.frames
    for frame in got["split"]:
        assert set(frame) == {"rebuild", "far_apply", "substep"}
        assert all(v > 0 for v in frame.values())
    assert host["replay_host_ms"] > 0    # on the CPU the call runs the frame
    assert host["host_self_ms"]["backend.step"] > 0
    # the profiled episodes, each in the trace: no device operations on
    # the CPU, so no gap
    assert host["idle_episodes"] == [0.0] * spans.PROFILED_EPISODES
    assert host["idle"] == {"ms": 0.0, "by_span": {}}
    ctx = harness.Context(cell, sim, loop, types.SimpleNamespace())
    assert spans.readings(ctx) is None
    assert spans.in_own_process("cloth1m-fall", 7) is None   # no card
    for name in ("rebuild_frame_ms", "replay_host_ms",
                 "idle_in_program_ms"):
        assert cell.reader(name).read(ctx) is None
