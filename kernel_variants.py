#!/usr/bin/env python3
"""Time named variants of the port's K1 (its detect and trig instances),
K2 and K3 sources beside another checkout's kernels, in turns, on one NVIDIA GPU.

Each variant is this tree's ``softbody_tpu_torch/csrc`` with a few
textual edits (``VARIANTS``): a design step left out, or a choice made
otherwise.  The script writes each variant's sources under ``--out``,
builds them (``ops/cuda/_lib.build``), holds every variant bit-exact
against the plain versions, and times it in turns with the parent's
kernel (parent, variant, variant, parent) on the inputs the paths give
the kernels: K2 and K1's detect and trig instances at the bench path's
final state (frames 3-10 of ``chip_smoke.py``'s main path; K1 with
kernel detection's constants, its state and side planes held bit for
bit, its trig statistics as ``chip_smoke.py`` holds them), K3 on path
A's state after ``chip_smoke.PATH_A_FRAMES`` frames, through the
interleaved views of the state (the parent: its four contiguous copies
and its kernel).

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

K1_SRC = "fused_substep2.cu"
K2_SRC = "band_detect.cu"
K3_SRC = "collide_stencil.cu"
# name -> (kernel, [(source, text, replacement), ...])
VARIANTS = {
    "this tree": ("K1d K1t K2 K3", []),
    "K1 detect, 2 threads a group": ("K1d", [(
        K1_SRC, "constexpr int DET_SPLIT = 4;",
        "constexpr int DET_SPLIT = 2;")]),
    "K1 detect, 1 thread a group": ("K1d", [(
        K1_SRC, "constexpr int DET_SPLIT = 4;",
        "constexpr int DET_SPLIT = 1;")]),
    "K1 detect, exact compares only": ("K1d", [(
        K1_SRC, "if (nearest < rb) {", "if (true) {")]),
    "K1 detect, band planes of every staged row": ("K1d", [(
        K1_SRC, "for (int row = R + r; row < sx; row += SUB_TX) {",
        "for (int row = r; row < sx; row += SUB_TX) {")]),
    "K1 detect at 4 blocks per SM": ("K1d", [(
        K1_SRC, "return (mode & M_TRIG) ? 4 : 5;",
        "return (mode & (M_TRIG | M_DETECT)) ? 4 : 5;")]),
    "K1 trig at 5 blocks per SM": ("K1t", [(
        K1_SRC, "return (mode & M_TRIG) ? 4 : 5;", "return 5;")]),
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
    flags = cs.band_flags_plain(*k2_planes, offsets)
    # K1's mode instances at the same state (no far planes): default +
    # detect (kernel detection's), strict + trig and strict + trig +
    # detect (the triggered frame's; refs: the state one spacing off)
    immut, s = run["be"]._immut, spec.collision_stencil
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg,
                                       spec.height),
                      run["be"]._edge_consts, cs._extras(
                          hot, alive, cfg.particle_radius, run["be"].ff.skin,
                          cfg.dt, t_band=(run["be"].ff.horizon + 1) * cfg.dt,
                          tau=cfg.dt)])
    refs = (hot[:4] + spacing).contiguous()
    k1_modes = {"default+detect": dict(detect=True, rsqrt=True,
                                       rollgroup=True),
                "strict+trig": dict(refs=refs),
                "strict+trig+detect": dict(refs=refs, detect=True)}
    k1_refs = {name: cs.fused_substep2_plain(hot, immut, cvec, stencil=s,
                                             quantized=True, **kw)
               for name, kw in k1_modes.items()}
    del run
    views, k3_alive, kw = _k3_inputs(dev)
    deltas = torch.stack(cs.collide_stencil_plain(*views, k3_alive, **kw))

    def k1_mode(lib, name):
        m = k1_modes[name]
        return cs._raw_k1m(lib, hot, immut, cvec, s, None, m.get("refs"),
                           m.get("detect", False), m.get("rsqrt", False),
                           m.get("rollgroup", False))

    def k1_held(lib, name) -> bool:
        """The instance's state and side planes equal the plain version's
        bit for bit, its trig statistics as chip_smoke.py holds them."""
        got_hot, stats, side = k1_mode(lib, name)
        ref = list(k1_refs[name])
        same = not bool(cs._differs(got_hot, ref.pop(0)).any())
        if stats is not None:
            cs._hold_trig(f"{name} trig", torch.cat(
                [stats[:, :2].amax(0), stats[:, 2:].sum(0)]), ref.pop(0),
                got_hot[VX], got_hot[VY], alive)
        if side is not None:
            same = same and not bool(cs._differs(side, ref.pop(0)).any())
        return same

    def parent_k3():
        return cs._raw_k3(parent, [v.contiguous() for v in views]
                          + [k3_alive], **kw)

    for name, (kernels, lib) in libs.items():
        for key, names in (("K1d", ("default+detect",
                                    "strict+trig+detect")),
                           ("K1t", ("strict+trig", "strict+trig+detect"))):
            if key not in kernels:
                continue
            for k1 in names:
                if not k1_held(lib, k1):
                    raise AssertionError(f"{name}: K1 {k1} differs")
                ms = cs._turns(lambda k1=k1: k1_mode(parent, k1),
                               lambda k1=k1: k1_mode(lib, k1), 50)
                cs.log(f"{name}, K1 {k1} at the bench final state: device "
                       f"ms parent {ms['parent']}, variant {ms['this']} on "
                       f"{card}")
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
