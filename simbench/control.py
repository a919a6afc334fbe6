"""The readings the check's limits are set from, at a cell's own size
on the card: ``python3 -m simbench.control --workload <cell> --seeds
1,2,3 [--faults]``.

For each seed it runs the cell's configuration through its traffic mix
once (set-up, then one episode, every frame kept) and holds frames drawn
as a run draws them against the float32 reference, frame by frame from
the program's own state:

- ``program``: the program's frame (the lower readings);
- ``control``: the reference in bfloat16 put in the program's place
  (the upper readings: the nearest precision below the configuration's
  float32);
- with ``--faults``, the program broken underneath: ``unchanged`` (the
  frame returns its state), ``half`` (half of the particles keep their
  state), ``no_far`` (the far apply left out: the same backend without
  its far field, where the configuration arms one).

Each row says whether the cell's limits judge that frame correct.
Prints one JSON line per seed, frame and kind on standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from simbench import check, harness
from simbench.reference import physics


def fault_frame(kind: str, sim, before, after):
    """The program's frame from ``before`` broken as ``kind`` says."""
    if kind == "unchanged":
        return sim.world(before)
    if kind == "half":
        a, b = sim.world(after), sim.world(before)
        n = a.pos.shape[0]
        keep = torch.arange(n, device=a.pos.device) < n // 2
        return a.replace(**{
            k: torch.where(keep[:, None], getattr(b, k), getattr(a, k))
            for k in ("pos", "vel", "acc")})
    if kind == "no_far":
        return sim.world(sim.step_without_far(before))
    raise ValueError(kind)


FRAME_LIMITS = ("pos_err_p50", "pos_err_p99", "pos_err_max",
                "pos_off_share", "vel_err_p50", "beams_flipped",
                "far_miss_share")


def frame_limits(cell: harness.Cell) -> dict:
    """The cell's limits on the numbers one compared frame gives."""
    return {k: v for k, v in cell.spec["check"]["limits"].items()
            if k in FRAME_LIMITS}


def readings(cell: harness.Cell, seed: int, faults: bool, card,
             control_frames=None, all_frames: bool = False) -> list:
    """One JSON row per compared frame and kind (with ``correct``: the
    frame judged by the cell's limits through ``check.judge``), then one
    row for the run.  ``all_frames`` compares every frame of the episode
    instead of those a run draws."""
    t0 = time.perf_counter()
    sim = cell.config.Sim(seed, card.device)
    loop = cell.loop.Loop(sim, cell.mix, seed, card)
    loop.setup()
    keep = dict.fromkeys(range(loop.frames))
    loop.episode(keep=keep)
    stats = sim.far_stats()
    chk = cell.spec["check"]
    sample = (list(range(loop.frames)) if all_frames
              else loop.sample(chk["frames"], 1).get(0, []))
    pairs = [keep[k] for k in sample]
    if loop.before_start is not None:
        pairs.append((loop.before_start, loop.start))
    setup_s = time.perf_counter() - t0
    out = []
    consts, spacing = sim.ref_consts, sim.spacing
    near = getattr(sim, "near", None)
    limits = frame_limits(cell)
    for i, (k, (before, after)) in enumerate(zip(sample + ["checkpoint"],
                                                 pairs)):
        wb = sim.world(before)
        t1 = time.perf_counter()
        ref = physics.frame(wb, consts)
        ref_near = (physics.frame(wb, consts, near=near)
                    if near is not None else None)
        ref_s = time.perf_counter() - t1

        def numbers(world):
            row = check.frame_numbers(world, ref, spacing)
            if ref_near is not None:
                row.update(check.far_numbers(world, ref, ref_near, spacing))
            return row

        rows = {"program": numbers(sim.world(after))}
        low_s = None
        if control_frames is None or i < control_frames:
            t1 = time.perf_counter()
            low = physics.frame(wb, consts, dtype=torch.bfloat16)
            low_s = time.perf_counter() - t1
            rows["control"] = numbers(low)
            del low
        if faults:
            for kind in ("unchanged", "half") + (
                    ("no_far",) if hasattr(sim, "step_without_far") else ()):
                rows[kind] = numbers(fault_frame(kind, sim, before, after))
        for kind, nums in rows.items():
            out.append({"seed": seed, "frame": k, "kind": kind,
                        "correct": check.judge(nums, limits)[0], **nums})
        out[-1].update(ref_s=ref_s, control_s=low_s)
        del ref, ref_near
    out.append({"seed": seed, "kind": "run", "setup_s": setup_s,
                "far_stats": stats,
                "start_diff": check.start_diff(sim.world(sim.initial),
                                               sim.ref_world)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m simbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--control-frames", type=int, default=None,
                   help="frames a seed holds the control on (all "
                   "compared frames by default)")
    p.add_argument("--all-frames", action="store_true",
                   help="compare every frame of the episode")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("simbench.control: no CUDA device", file=sys.stderr)
        return 2
    card = harness.Card()
    card.start(sys.stderr)
    cell = harness.Cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        for row in readings(cell, seed, a.faults, card, a.control_frames,
                            a.all_frames):
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
