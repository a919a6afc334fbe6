"""The comparison that decides ``correct``.

The program's frames are held against the plain reference
(``simbench/reference``), frame by frame from the program's own state:
a frame of 64 substeps of a tearing, colliding sheet is chaotic, and
one ulp of input parts a frame by O(1) at a few particles, so the
reference cannot follow a whole episode on its own.  Each compared
frame starts from the program's state before it; the reference runs
the frame in float32 and the numbers below measure how far the
program's state after it lies from the reference's.  The start (the
scene and the seed's jitter as the program holds them) is compared
with the reference's own scene, exactly.

Where a configuration has a collision stencil (``near``), the reference
runs each compared frame a second time with only the stencil's contacts.
The particles that the two reference frames place more than a tenth of
a spacing apart are those that the far contacts (pairs outside the
stencil, the far field's work) move; ``far_miss_share`` is the share of
them that the program's frame leaves nearer to the stencil-only frame
than to the whole one.  A frame whose far apply is left out reads near
1 there, while the chaos of a sound frame moves only a few of them.

Each number has a limit in the cell's file; a number above its limit,
or not finite, makes the run not correct."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from simbench.reference import physics

# the fields of the start compared exactly
START_FIELDS = ("pos", "vel", "acc", "alive", "pinned", "length", "target",
                "last", "spring", "damp", "yield_strain", "strain_limit",
                "beam_alive")


def start_diff(prog: physics.World, ref: physics.World) -> int:
    """Elements of the start that differ from the reference's scene
    (bitwise for floats), over :data:`START_FIELDS`; a shape that
    differs counts its whole field."""
    n = 0
    for k in START_FIELDS:
        a, b = getattr(prog, k), getattr(ref, k)
        if a.shape != b.shape:
            n += max(a.numel(), b.numel())
            continue
        if a.dtype.is_floating_point:
            a = a.contiguous().view(torch.int32)
            b = b.contiguous().view(torch.int32)
        n += int((a != b).sum())
    return n


def quantile(x: torch.Tensor, q: float) -> float:
    """The ``q`` quantile of ``x`` (linear between order statistics),
    computed on the host in float64 (``torch.quantile`` refuses large
    inputs)."""
    v = torch.sort(x.reshape(-1).double().cpu()).values
    if v.numel() == 0:
        return 0.0
    pos = q * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def frame_numbers(prog: physics.World, ref: physics.World,
                  spacing: float) -> Dict[str, float]:
    """How far the program's state after a frame lies from the
    reference's: position error per live particle in lattice spacings
    (its median, 99th percentile and maximum, and the share of particles
    off by more than a tenth of a spacing), velocity error's median in
    spacings per unit time, and the beams whose liveness differs.  A
    non-finite program state reads ``inf``."""
    live = ref.alive
    dp = (prog.pos - ref.pos)[live]
    err = torch.sqrt((dp * dp).sum(-1)) / spacing
    err = torch.where(torch.isfinite(err), err, torch.inf)
    dv = (prog.vel - ref.vel)[live]
    verr = torch.sqrt((dv * dv).sum(-1)) / spacing
    verr = torch.where(torch.isfinite(verr), verr, torch.inf)
    return {
        "pos_err_p50": quantile(err, 0.5),
        "pos_err_p99": quantile(err, 0.99),
        "pos_err_max": float(err.max()) if err.numel() else 0.0,
        "pos_off_share": float((err > 0.1).double().mean()),
        "vel_err_p50": quantile(verr, 0.5),
        "beams_flipped": float((prog.beam_alive != ref.beam_alive).sum()),
    }


FAR_MOVE = 0.1   # spacings: the far contacts move a particle by more


def far_numbers(prog: physics.World, ref: physics.World,
                ref_near: physics.World, spacing: float) -> Dict[str, float]:
    """``far_moved``: live particles that the far contacts move by more
    than :data:`FAR_MOVE` spacings in the reference (the whole frame
    against its stencil-only twin); ``far_miss_share``: the share of
    them whose program position lies no nearer to the whole frame than
    to the stencil-only one (0 where none moved; a non-finite program
    position counts as a miss)."""
    live = ref.alive
    moved = torch.sqrt(((ref_near.pos - ref.pos)[live] ** 2).sum(-1))
    d = moved > FAR_MOVE * spacing
    p = prog.pos[live][d]
    to_ref = torch.sqrt(((p - ref.pos[live][d]) ** 2).sum(-1))
    to_near = torch.sqrt(((p - ref_near.pos[live][d]) ** 2).sum(-1))
    miss = ~(to_ref < to_near)
    n = int(d.sum())
    return {"far_moved": float(n),
            "far_miss_share": float(miss.double().mean()) if n else 0.0}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the compared frames."""
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    have a limit; a number that is missing or not finite fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def compare_frames(pairs, consts: physics.Consts, spacing: float,
                   near=None) -> List[Dict[str, float]]:
    """For each ``(before, after)`` pair of program worlds: the
    reference's float32 frame from ``before``, held against ``after``;
    with ``near`` (a collision stencil, see ``physics.contacts``) the far
    contacts' numbers too."""
    rows = []
    for before, after in pairs:
        ref = physics.frame(before, consts)
        row = frame_numbers(after, ref, spacing)
        if near is not None:
            ref_near = physics.frame(before, consts, near=near)
            row.update(far_numbers(after, ref, ref_near, spacing))
            del ref_near
        rows.append(row)
        del ref
    return rows


@dataclasses.dataclass
class Inputs:
    """What the check holds against the reference, taken from the
    program before its state is freed: numbers compared as they are (the
    start, the far list's overflow), the ``(before, after)`` worlds of
    the compared frames, and the reference's constants, the lattice
    spacing and the collision stencil (``near``)."""

    numbers: Dict[str, float]
    pairs: list
    consts: physics.Consts
    spacing: float
    near: Optional[tuple] = None

    def compare(self) -> Dict[str, float]:
        """Every number of the check: the given ones, each frame
        number's worst over the compared frames, and how many frames
        were compared."""
        rows = compare_frames(self.pairs, self.consts, self.spacing,
                              self.near)
        out = dict(self.numbers)
        out.update(worst(rows))
        out["frames_compared"] = float(len(rows))
        return out
