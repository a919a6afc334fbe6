"""Command-line interface (port of ``softbody_tpu/cli.py``) — the
programmatic app shell (component C9; the reference's UI wiring,
main.ts, becomes CLI verbs).

Verbs:

- ``run``      step a scene, print live stats (≙ the FPS overlay)
- ``render``   step + write PNG frames (≙ the render pass + canvas)
- ``snapshot`` create / inspect snapshot files (≙ main.ts:49-87)
- ``play``     interactive terminal viewer (tui.py)
- ``scenes``   list built-in scene families

Every verb runs on ``--device`` (default ``cuda``; without a card that
raises, and ``--device cpu`` runs the plain torch versions).  The verbs
keep the JAX CLI's arguments, JSON lines and behaviour, including what
it ignores: ``run --path lattice`` steps without the far field,
``render`` and ``play`` with ``--path planified`` run the general
engine.  ``run`` and ``render`` step through the compiled frames
(``frame_jit``, ``lattice_frame_jit``: CUDA graphs on the card), ``play``
through the engines' backends, which use the same.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Optional

import torch

from .config import PhysicsConstants, UserInput, resolve_device


def _warm_readback(dev: torch.device) -> None:
    """One device-to-host copy up front (the JAX CLI pays its first
    readback here)."""
    torch.zeros(8, device=dev).cpu()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_scene(args, dev):
    from .models import SCENES

    if args.scene not in SCENES:
        sys.exit(f"unknown scene {args.scene!r}; try: {', '.join(SCENES)}")
    kwargs = {}
    if args.n is not None:
        if args.scene in ("self_colliding_cloth", "tearing_cloth"):
            kwargs["n_particles"] = args.n
        elif args.scene == "multi_blob":
            kwargs["n_blobs"] = args.n
        elif args.scene == "cloth":
            side = max(2, int(args.n ** 0.5))
            kwargs["w"] = kwargs["h"] = side
    state, cfg = SCENES[args.scene](**kwargs, device=dev)

    overrides = {}
    if args.collision is not None:
        overrides["collision_mode"] = args.collision
    if args.subticks is not None:
        overrides["subticks"] = args.subticks
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return state, cfg


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "torch versions)")


def _common_scene_args(p):
    p.add_argument("--scene", default="default", help="scene family name")
    p.add_argument("--n", type=int, default=None,
                   help="scene size (particles / blobs / cloth side²)")
    p.add_argument("--collision", choices=["none", "allpairs", "grid"],
                   default=None)
    p.add_argument("--subticks", type=int, default=None)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--path", choices=["general", "lattice", "planified"],
                   default="general",
                   help="engine path: general gather, dense lattice "
                        "(cloth / tearing_cloth), or planified — any "
                        "topology spatially embedded onto the dense "
                        "stencil path (ops/planify.py)")
    _device_arg(p)


def _build_lattice_scene(args, dev):
    """Dense-path builders for lattice-shaped scenes."""
    from .models import cloth_lattice, tearing_cloth_lattice

    consts = None
    if args.scene == "tearing_cloth":
        state, spec, cfg, consts = tearing_cloth_lattice(
            n_particles=args.n or 1_000_000, device=dev
        )
    elif args.scene == "cloth":
        side = max(2, int((args.n or 1024) ** 0.5))
        state, spec, cfg = cloth_lattice(w=side, h=side, device=dev)
    else:
        sys.exit(f"--path lattice supports cloth/tearing_cloth, not {args.scene!r}")
    if args.subticks is not None:
        cfg = dataclasses.replace(cfg, subticks=args.subticks)
    if consts is None:
        consts = PhysicsConstants.default()
    return state, spec, cfg, consts


def cmd_run(args) -> int:
    from .ops.step import frame_jit
    from .utils.profiling import Profiler, device_trace, drain, tracing

    dev = resolve_device(args.device)
    _warm_readback(dev)
    if args.path == "lattice":
        # the JAX CLI steps the lattice without the far field whatever
        # --farfield says (softbody_tpu/cli.py:107-119)
        from .ops.stencil import lattice_frame_jit

        state, spec, cfg, consts = _build_lattice_scene(args, dev)
        w, h = state.shape
        n = w * h
        m = sum(int(e.alive.sum()) for e in state.edges)

        def step(s):
            return lattice_frame_jit(s, consts, uin, spec, cfg)

        def beams_alive(s):
            return sum(int(e.alive.sum()) for e in s.edges)
    elif args.path == "planified":
        from .engine.backends import PlanifiedBackend

        flat, cfg = _build_scene(args, dev)
        consts = PhysicsConstants.default()
        n = int(flat.particle_count)
        m = int(flat.beam_count)
        ff = None
        if getattr(args, "farfield", False):
            from .ops.farfield import FarFieldSpec

            # fold contacts that develop after the pack-time embedding
            ff = FarFieldSpec(skin=3.0 * cfg.particle_radius, horizon=8)
        backend = PlanifiedBackend(cfg, farfield=ff, device=dev)
        state = backend.pack_state(flat)

        def step(s):
            return backend.step(s, consts, uin)

        def beams_alive(s):
            return backend.counts(s)[1]
    else:
        state, cfg = _build_scene(args, dev)
        consts = PhysicsConstants.default()
        n = int(state.particle_count)
        m = int(state.beam_count)

        def step(s):
            return frame_jit(s, consts, uin, cfg)

        def beams_alive(s):
            return int(s.beam_alive.sum())

    uin = UserInput.none()
    print(f"scene={args.scene} path={args.path} particles={n} beams={m} "
          f"collision={cfg.collision_mode} subticks={cfg.subticks}",
          file=sys.stderr)
    prof = Profiler(cfg.subticks, n)
    trace_dir = getattr(args, "trace", None)
    # --trace: the program's spans and device marks on (the tracer is part
    # of a captured frame's key, so the warm-up captures the traced graph)
    with tracing() if trace_dir else contextlib.nullcontext():
        # warm-up frame (the JAX CLI's compile; here the graph's capture)
        state = step(state)
        _sync(dev)
        prof.start()
        report_every = max(1, args.frames // 10)
        with device_trace(trace_dir):
            for f in range(args.frames):
                state = step(state)
                if (f + 1) % report_every == 0:
                    _sync(dev)
                    prof.stop()
                    prof.frames = f + 1
                    print(
                        f"frame {f+1}/{args.frames}  "
                        f"{prof.substeps_per_sec:,.0f} substeps/s  "
                        f"{prof.particle_substeps_per_sec:,.3g} "
                        "particle-substeps/s",
                        file=sys.stderr,
                    )
                    prof.start()
            _sync(dev)
        prof.stop()
    drain()
    p = state.pos.reshape(-1, 2)
    print(json.dumps({
        "scene": args.scene,
        "path": args.path,
        "frames": args.frames,
        "substeps_per_sec": round(prof.substeps_per_sec, 1),
        "particle_substeps_per_sec": round(prof.particle_substeps_per_sec, 1),
        "beams_alive": beams_alive(state),
        "finite": bool(torch.isfinite(p).all()),
    }))
    return 0


def cmd_render(args) -> int:
    from .ops.step import frame_jit
    from .viz import render_state, save_png

    dev = resolve_device(args.device)
    _warm_readback(dev)
    uin = UserInput.none()
    if args.path == "lattice":
        from .models import lattice_to_simstate
        from .ops.stencil import lattice_frame_jit

        lstate, spec, cfg, consts = _build_lattice_scene(args, dev)

        def advance(s):
            return lattice_frame_jit(s, consts, uin, spec, cfg)

        def renderable(s):
            return lattice_to_simstate(s, build_incidence=False, device=dev)

        state = lstate
    else:
        # --path planified renders on the general engine, as the JAX CLI
        # does (softbody_tpu/cli.py:206-227)
        state, cfg = _build_scene(args, dev)
        consts = PhysicsConstants.default()

        def advance(s):
            return frame_jit(s, consts, uin, cfg)

        def renderable(s):
            return s

    os.makedirs(args.out, exist_ok=True)
    prev = None
    written = 0
    for f in range(args.frames):
        state = advance(state)
        if f % args.every == 0:
            img = render_state(renderable(state), cfg,
                               resolution=args.resolution,
                               prev_frame=prev if args.trails else None)
            prev = img
            path = os.path.join(args.out, f"frame_{f:05d}.png")
            save_png(path, img)
            written += 1
    print(json.dumps({"frames_written": written, "out": args.out}))
    return 0


def cmd_snapshot(args) -> int:
    from .snapshot import load_snapshot, save_snapshot

    dev = resolve_device(args.device)
    _warm_readback(dev)
    if args.action == "create":
        ns = argparse.Namespace(scene=args.scene, n=args.n, collision=None,
                                subticks=None)
        state, cfg = _build_scene(ns, dev)
        buf = save_snapshot(state, PhysicsConstants.default(), format=args.format)
        with open(args.file, "wb") as f:
            f.write(buf)
        print(json.dumps({"file": args.file, "bytes": len(buf)}))
    elif args.action == "info":
        with open(args.file, "rb") as f:
            buf = f.read()
        state, consts = load_snapshot(buf, device=dev)
        print(json.dumps({
            "format": "v1" if buf[:4] == b"SBT1" else "v0",
            "particles": int(state.particle_count),
            "beams": int(state.beam_count),
            "constants": [round(float(x), 6) for x in consts.to_array()],
        }))
    return 0


def cmd_play(args) -> int:
    """Interactive terminal viewer (≙ the reference's live canvas +
    controls; see tui.py)."""
    from .engine.engine import Engine, LatticeEngine
    from .engine.protocol import EngineOptions
    from .tui import play

    dev = resolve_device(args.device)
    _warm_readback(dev)
    if args.path == "lattice":
        state, spec, cfg, consts = _build_lattice_scene(args, dev)
        opts = EngineOptions(
            particle_radius=cfg.particle_radius, subticks=cfg.subticks,
            collision_mode=cfg.collision_mode, use_pallas=cfg.use_pallas,
        )
        ff = None
        if args.farfield:
            from .ops.farfield import FarFieldSpec

            ff = FarFieldSpec()
        eng = LatticeEngine(state, spec, consts, opts, farfield=ff,
                            device=dev)
    else:
        # --path planified (and its --farfield) plays on the general
        # engine, as the JAX CLI does (softbody_tpu/cli.py:285-303)
        state, cfg = _build_scene(args, dev)
        opts = EngineOptions(
            particle_radius=cfg.particle_radius, subticks=cfg.subticks,
            collision_mode=cfg.collision_mode,
        )
        eng = Engine(state, PhysicsConstants.default(), opts, device=dev)
    try:
        play(eng, fps=args.fps, duration=args.duration)
    except KeyboardInterrupt:
        pass
    finally:
        eng.destroy()
    return 0


def cmd_scenes(args) -> int:
    from .models import SCENES

    for name, fn in SCENES.items():
        print(f"{name:24s} {fn.__doc__.splitlines()[0] if fn.__doc__ else ''}")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="softbody_tpu_torch",
        description="softbody engine, PyTorch + CUDA port (one NVIDIA H100)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="step a scene and report throughput")
    _common_scene_args(p)
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler Chrome trace (Perfetto) "
                   "with the program's spans beside the kernels")
    p.add_argument("--farfield", action="store_true",
                   help="arm far-field self-collision (planified path)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("render", help="step a scene and write PNG frames")
    _common_scene_args(p)
    p.add_argument("--out", default="frames")
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--trails", action="store_true",
                   help="alpha-0.4 trail effect like the reference")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("snapshot", help="create/inspect snapshot files")
    p.add_argument("action", choices=["create", "info"])
    p.add_argument("file")
    p.add_argument("--scene", default="default")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--format", default="auto", choices=["auto", "v0", "v1"])
    _device_arg(p)
    p.set_defaults(fn=cmd_snapshot)

    p = sub.add_parser(
        "play", help="interactive terminal viewer (WASD/arrows/space)"
    )
    _common_scene_args(p)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--duration", type=float, default=None,
                   help="auto-quit after N seconds (demos/tests)")
    p.add_argument("--farfield", action="store_true",
                   help="enable far-field self-collision (lattice path)")
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("scenes", help="list scene families")
    _device_arg(p)
    p.set_defaults(fn=cmd_scenes)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
