#!/usr/bin/env python3
"""Time named variants of the port's K2 and K3 sources beside another
checkout's kernels, in turns, on one NVIDIA GPU.

Each variant is this tree's ``softbody_tpu_torch/csrc`` with a few
textual edits (``VARIANTS``): a design step left out, or a choice made
otherwise.  The script writes each variant's sources under ``--out``,
builds them (``ops/cuda/_lib.build``), holds every variant bit-exact
against the plain versions, and times it in turns with the parent's
kernel (parent, variant, variant, parent) on the inputs the paths give
the kernels: K2 at the bench path's final state (frames 3-10 of
``chip_smoke.py``'s main path), K3 on path A's state after
``chip_smoke.PATH_A_FRAMES`` frames, through the interleaved views of the
state (the parent: its four contiguous copies and its kernel).

    python3 kernel_variants.py --parent DIR [--out DIR] [NAME ...]

``--parent DIR``: the root of another checkout of this repo (for example
the parent commit from ``git archive``).  Needs one CUDA device and
``nvcc``; refuses to run without a device.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import softbody_tpu_torch as tb
from softbody_tpu_torch.engine import LatticeBackend
from softbody_tpu_torch.models import tearing_cloth_lattice
from softbody_tpu_torch.ops.cuda import _lib
from softbody_tpu_torch.ops.cuda.fused_substep2 import PX, PY, VX, VY
from softbody_tpu_torch.ops.farfield import FarFieldSpec

K2_SRC = "band_detect.cu"
K3_SRC = "collide_stencil.cu"
# name -> (kernel, [(source, text, replacement), ...])
VARIANTS = {
    "this tree": ("K2 K3", []),
    "K3 without the skip": ("K3", [(
        K3_SRC, "const bool fast = __syncthreads_and(vel_finite) && "
        "consts_finite;", "const bool fast = __syncthreads_and(vel_finite) "
        "&& consts_finite && false;")]),
    "K3 radius at run time": ("K3", [(
        K3_SRC, "case 2: return collide_stencil_kernel<PAIRS, 2>;",
        "case 2: return collide_stencil_kernel<PAIRS, 0>;")]),
    "K3 4-byte copies of the views": ("K3", [(
        K3_SRC, "interleaved(p) ? k3_kernel<true>(stencil)",
        "false ? k3_kernel<true>(stencil)")]),
    "K2 exact compares only": ("K2", [(
        K2_SRC, "if (nearest < rb) {", "if (true) {")]),
    "K2 8 cells per thread": ("K2", [(
        K2_SRC, "constexpr int CX = 4;", "constexpr int CX = 8;")]),
}


def _variant_csrc(name: str, edits, out: Path) -> Path:
    d = out / name.replace(" ", "_") / "softbody_tpu_torch" / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_lib.CSRC, d)
    for src, text, repl in edits:
        p = d / src
        body = p.read_text()
        if body.count(text) != 1:
            raise AssertionError(f"variant {name!r}: {text!r} not found once "
                                 f"in {src}")
        p.write_text(body.replace(text, repl))
    return d


def _k3_inputs(dev):
    """Path A's state after PATH_A_FRAMES frames: the interleaved views,
    alive and the K3 keywords."""
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=cs.N_PARTICLES, device=dev)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    be = LatticeBackend(spec, cfg, farfield=FarFieldSpec(), device=dev)
    for _ in range(cs.PATH_A_FRAMES):
        state = be.step(state, consts, tb.UserInput())
    views = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
             state.vel[..., 1])
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=spec.collision_stencil)
    return views, state.alive, kw


def _raw_k3_strided(lib, views, alive, radius, dt, ecoeff, friction,
                    stencil):
    out = torch.empty((5,) + tuple(alive.shape), device=alive.device)
    strides = np.ascontiguousarray([v.stride() for v in views], np.int64)
    two_r, inv_dt2 = cs.collide_stencil._scalars(radius, dt)
    _lib.check(lib.sb_collide_stencil_strided(
        *(v.data_ptr() for v in views), strides.ctypes.data,
        alive.data_ptr(), out.data_ptr(), two_r, inv_dt2,
        float(np.float32(ecoeff)), float(np.float32(friction)),
        alive.shape[0], alive.shape[1], stencil, cs._stream()), "K3")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=Path("_checkout/variants"))
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs._card()
    cs.log(card)
    parent = _lib.bind(_lib.build(args.parent / "softbody_tpu_torch" /
                                  "csrc")[0])
    libs = {}
    for name in args.names:
        kernels, edits = VARIANTS[name]
        path, _secs, report = _lib.build(_variant_csrc(name, edits,
                                                       args.out))
        libs[name] = (kernels, _lib.bind(path))
        regs = [ln.split(":", 1)[1].strip() for ln in report.splitlines()
                if "Used" in ln]
        cs.log(f"{name}: built ({'; '.join(regs[:8])})")

    state, spec, cfg, consts, spacing = cs._scene(cs.N_PARTICLES, dev)
    run = cs.run_main_path(state, spec, cfg, consts, spacing)
    hot, alive = run["packed"][0], run["be"]._immut[0] > 0
    *k2_planes, offsets = cs._band_inputs(
        hot[PX], hot[PY], hot[VX], hot[VY], alive, cfg, run["be"].ff,
        spec.collision_stencil)
    del run
    views, k3_alive, kw = _k3_inputs(dev)
    flags = cs.band_flags_plain(*k2_planes, offsets)
    deltas = torch.stack(cs.collide_stencil_plain(*views, k3_alive, **kw))

    def parent_k3():
        return cs._raw_k3(parent, [v.contiguous() for v in views]
                          + [k3_alive], **kw)

    for name, (kernels, lib) in libs.items():
        if "K2" in kernels:
            if not torch.equal(cs._raw_k2(lib, k2_planes, offsets), flags):
                raise AssertionError(f"{name}: K2 flags differ")
            ms = cs._turns(lambda: cs._raw_k2(parent, k2_planes, offsets),
                           lambda: cs._raw_k2(lib, k2_planes, offsets), 50)
            cs.log(f"{name}, K2 at the bench final state: device ms parent "
                   f"{ms['parent']}, variant {ms['this']} on {card}")
        if "K3" in kernels:
            got = _raw_k3_strided(lib, views, k3_alive, **kw)
            if bool(cs._differs(got, deltas).any()):
                raise AssertionError(f"{name}: K3 deltas differ")
            ms = cs._turns(parent_k3, lambda: _raw_k3_strided(
                lib, views, k3_alive, **kw), 50)
            cs.log(f"{name}, K3 on path A's views: device ms parent "
                   f"{ms['parent']}, variant {ms['this']} on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
