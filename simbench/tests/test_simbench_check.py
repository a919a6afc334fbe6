"""The check at a small size on the CPU: the program's frames pass the
cells' limits, the bfloat16 control fails them, and a run whose timed
path is broken underneath comes out not correct."""

import dataclasses
import io
import json

import pytest
import torch

from simbench import check, control, harness
from simbench.reference import physics

from .conftest import HostCard, HostCell, on_host

CELLS = ("cloth1m-tear", "cloth100k-fold", "cloth1m-fall")


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_the_control_fails(name, bench):
    cell = on_host(harness.Cell(name, bench))
    limits = control.frame_limits(cell)
    assert limits
    rows = control.readings(cell, 2147483659, False, HostCard())
    prog = [r for r in rows if r.get("kind") == "program"]
    low = [r for r in rows if r.get("kind") == "control"]
    assert prog and len(prog) == len(low)
    for p, c in zip(prog, low):
        assert p["correct"] and check.judge(p, limits)[0], p
        assert not c["correct"] and not check.judge(c, limits)[0], c
    run = [r for r in rows if r.get("kind") == "run"][0]
    assert run["start_diff"] == 0


def _with_particles(state, fn):
    """``state`` with its position and velocity planes ``(px, py, vx,
    vy)`` replaced by ``fn`` of them: the packed lattice's hot planes or
    the planified state's lattice."""
    if isinstance(state, tuple):
        hot, obs = state
        hot = hot.clone()
        hot[:4] = torch.stack(fn(*hot[:4].clone()))
        return hot, obs
    lat = state.lat
    px, py, vx, vy = fn(lat.pos[..., 0].clone(), lat.pos[..., 1].clone(),
                        lat.vel[..., 0].clone(), lat.vel[..., 1].clone())
    return dataclasses.replace(state, lat=dataclasses.replace(
        lat, pos=torch.stack([px, py], -1), vel=torch.stack([vx, vy], -1)))


def _planes(state):
    if isinstance(state, tuple):
        return tuple(state[0][:4])
    lat = state.lat
    return (lat.pos[..., 0], lat.pos[..., 1], lat.vel[..., 0],
            lat.vel[..., 1])


def _unchanged(sim, state, out):
    """The frame returns its state."""
    return state


def _half(sim, state, out):
    """Half of the world (the first half of the plane's columns) left out
    of the frame: its particles keep their state."""
    old = _planes(state)

    def fn(*new):
        w = new[0].shape[0]
        return tuple(torch.cat([o[: w // 2], n[w // 2:]])
                     for o, n in zip(old, new))
    return _with_particles(out, fn)


def _altered(sim, state, out):
    """The frame's answer altered where it is produced: every position
    moved by a quarter of a spacing."""
    return _with_particles(out, lambda px, py, vx, vy: (
        px + 0.25 * sim.spacing, py, vx, vy))


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(name, fault, bench, monkeypatch):
    """The harness's look for a card is skipped (the run is on the CPU);
    the rest of a run drives a frame function broken as ``fault``."""

    class Broken(HostCell):
        pass

    Broken.fault = staticmethod(FAULTS[fault])
    Broken.frames = 2   # two frames an episode: the check needs no more
    monkeypatch.setattr(harness, "Cell", Broken)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(name, 77, 0.01, False, bench=bench, card=HostCard(),
                     out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is False, err.getvalue()[-2000:]


def _pair_world(pos, lin):
    """Two particles, no beam."""
    n = pos.shape[0]
    z = torch.zeros(0)
    zi = torch.zeros(0, dtype=torch.long)
    return physics.World(
        pos=pos, vel=torch.zeros_like(pos), acc=torch.zeros_like(pos),
        alive=torch.ones(n, dtype=torch.bool),
        pinned=torch.zeros(n, dtype=torch.bool), lin=lin, a=zi, b=zi,
        length=z, target=z, last=z, spring=z, damp=z, yield_strain=z,
        strain_limit=z, beam_alive=torch.zeros(0, dtype=torch.bool))


def test_stencil_contacts_leave_out_the_far_pairs():
    """Two overlapping particles far apart in the lattice's index space
    meet in the whole reference and not in its stencil-only twin; two
    stencil neighbours meet in both."""
    c = physics.Consts(radius=1.0, dt=1 / 64, bounds=1000.0,
                       gravity=(0.0, 0.0), border_elasticity=0.5,
                       border_friction=0.2, elasticity=0.5, friction=0.1,
                       drag_coeff=0.0, drag_exp=2.0, subticks=4)
    pos = torch.tensor([[500.0, 500.0], [501.0, 500.0]])
    h = 100
    far = _pair_world(pos, torch.tensor([0, 50 * h + 50]))
    whole = physics.contacts(far, c)
    stencil = physics.contacts(far, c, near=(2, h))
    assert float(whole[2].abs().sum()) > 0
    assert float(sum(t.abs().sum() for t in stencil)) == 0
    close = _pair_world(pos, torch.tensor([0, 2 * h + 1]))
    assert torch.equal(physics.contacts(close, c, near=(2, h))[2],
                       physics.contacts(close, c)[2])


def test_far_miss_share_tells_a_frame_without_its_far_contacts():
    """The program on the whole frame reads 0, the program on the
    stencil-only frame reads 1 and fails the cells' limit; where the far
    contacts move nothing the number is 0."""
    n = 100
    ref = _pair_world(torch.rand(n, 2) * 100, torch.arange(n))
    shifted = ref.pos.clone()
    shifted[:10, 0] += 0.5
    ref_near = ref.replace(pos=shifted)
    sound = ref.replace(pos=ref.pos + 1e-4)
    assert check.far_numbers(sound, ref, ref_near, 1.0) == {
        "far_moved": 10.0, "far_miss_share": 0.0}
    assert check.far_numbers(ref_near, ref, ref_near, 1.0)[
        "far_miss_share"] == 1.0
    assert check.far_numbers(sound, ref, ref, 1.0)["far_miss_share"] == 0.0
    limits = {"far_miss_share": harness.load_json(
        "workloads", "cloth1m-tear.json")["check"]["limits"][
            "far_miss_share"]}
    assert not check.judge(check.far_numbers(ref_near, ref, ref_near, 1.0),
                           limits)[0]
    assert check.judge(check.far_numbers(sound, ref, ref_near, 1.0),
                       limits)[0]
