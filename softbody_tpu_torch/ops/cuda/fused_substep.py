"""The per-edge fused lattice substep (kernel K4) and the frames built on
it: the port of ``softbody_tpu/ops/pallas/fused_substep.py``.

Packed state is contiguous, unpadded float32 ``[planes, W, H]`` (H
innermost), in the JAX package's plane order:

- ``mut [26, W, H]``: px py vx vy ax ay, then per edge class c at
  ``6 + 5c``: target, last, strain, stress, alive;
- ``immut [22, W, H]``: alive, pinned, then per edge class c at
  ``2 + 5c``: spring, damp, yield, limit, length.

Unlike the fused substep K1 (``fused_substep2.py``), the edge parameters
are planes, so they may vary over the lattice, and strain and stress are
written every substep.  The JAX package pads the stacks by (8, 128) for
Mosaic; a Hopper kernel needs no pad.

``fused_substep_call`` is the K4 wrapper: on a CUDA tensor it launches
the hand-written kernel (``csrc/fused_substep.cu``), on a CPU tensor it
runs the plain version ``fused_substep_plain``.

``fused_frame_jit``, ``fused_frame_far_jit`` and ``packed_far_motion_jit``
are the compiled counterparts of the JAX package's jitted functions
(``ops/compiled.py``): one CUDA graph a frame on the card, K4 reading the
frame's constants from device memory, so a drag replays it; the functions
themselves on the CPU.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Tuple

import torch

from ...config import N_CONSTS, PhysicsConstants, StaticConfig, UserInput
from ...config import consts_vector
from ..farfield import (
    displacement_check,
    far_collision_terms,
    max_relative_speed,
    rebuild_far_list_planes,
)
from ..compiled import Compiled
from ..stencil import (
    LatticeState,
    Scalars,
    check_reference_offsets,
    decisions,
    frame_decisions,
    substep_planes,
    to_device,
)
from . import _lib
from .fused_substep2 import MAX_STENCIL, _check_plane_stack

PX, PY, VX, VY, AX, AY = range(6)
TGT, LST, STR, STS, EAL = range(5)   # + 6 + 5c
N_MUT = 26
ALIVE, PINNED = 0, 1
SPR, DMP, YLD, LIM, LEN = range(5)   # + 2 + 5c
N_IMMUT = 22
EDGE_PARAMS = ("spring", "damp", "yield_strain", "strain_limit", "length")

# launches of the CUDA kernel (the plain version does not count)
K4_LAUNCHES = 0


def pack_lattice(state: LatticeState) -> Tuple[torch.Tensor, torch.Tensor]:
    """LatticeState → ``(mut [26, W, H], immut [22, W, H])``, contiguous
    float32 on the state's device.  (The JAX package's ``raw_stacks``;
    its ``pack_lattice`` also pads, which the port does not.)"""
    mut = [state.pos[..., 0], state.pos[..., 1],
           state.vel[..., 0], state.vel[..., 1],
           state.acc[..., 0], state.acc[..., 1]]
    for e in state.edges:
        mut += [e.target_length, e.last_length, e.strain, e.stress, e.alive]
    immut = [state.alive, state.pinned]
    for e in state.edges:
        immut += [getattr(e, name) for name in EDGE_PARAMS]

    def stack(planes):
        return torch.stack([p.to(torch.float32) for p in planes]).contiguous()

    return stack(mut), stack(immut)


raw_stacks = pack_lattice


def unpack_lattice(mut: torch.Tensor, immut: torch.Tensor,
                   template: LatticeState) -> LatticeState:
    """``(mut, immut)`` → LatticeState with ``template``'s immutables."""
    edges = []
    for c, e in enumerate(template.edges):
        mb = 6 + 5 * c
        edges.append(dataclasses.replace(
            e,
            target_length=mut[mb + TGT],
            last_length=mut[mb + LST],
            strain=mut[mb + STR],
            stress=mut[mb + STS],
            alive=mut[mb + EAL] > 0.0,
        ))
    return dataclasses.replace(
        template,
        pos=torch.stack([mut[PX], mut[PY]], -1),
        vel=torch.stack([mut[VX], mut[VY]], -1),
        acc=torch.stack([mut[AX], mut[AY]], -1),
        edges=tuple(edges),
    )


def fused_substep_plain(mut, immut, consts_vec, *, stencil: int,
                        quantized: bool, far=None):
    """Plain torch version of K4: the stencil path's substep
    (``ops/stencil.py::substep_planes``, XLA sum order) on the packed
    planes, edge parameters from ``immut``, strain and stress written
    where the edge took part.  Returns ``mut'``."""
    # 0-d tensors on the state's device: true division on CUDA
    sc = Scalars.of(to_device(consts_vec, mut.device))
    edges = []
    for c in range(4):
        mb, ib = 6 + 5 * c, 2 + 5 * c
        edges.append(SimpleNamespace(
            target_length=mut[mb + TGT], last_length=mut[mb + LST],
            alive=mut[mb + EAL] > 0.0,
            **{name: immut[ib + i] for i, name in enumerate(EDGE_PARAMS)}))
    planes, ups = substep_planes(
        mut[PX], mut[PY], mut[VX], mut[VY], mut[AX], mut[AY],
        immut[ALIVE] > 0.0, immut[PINNED] > 0.0, edges, sc,
        stencil=stencil, quantized=quantized, far_deltas=(far,))
    out = list(planes)
    for c, u in enumerate(ups):
        mb = 6 + 5 * c
        out += [u.target, u.last,
                torch.where(u.active, u.strain, mut[mb + STR]),
                torch.where(u.active, u.stress, mut[mb + STS]),
                u.alive.to(torch.float32)]
    return torch.stack(out)


def fused_substep_call(mut, immut, consts_vec, *, stencil: int,
                       quantized: bool, far=None, skip=None):
    """One substep over the packed stacks (kernel K4).

    ``mut [26,W,H]``, ``immut [22,W,H]`` and optional ``far [5,W,H]``
    delta planes, all float32, contiguous, on one device; ``consts_vec``
    a CPU float32 ``[20]`` (``config.consts_vector``), copied into the
    launch, or a float32 ``[20]`` on mut's device (the frames': their
    constants and user input are device buffers), which the kernel reads
    there (``sb_fused_substep_dev``), with ``skip``, whether those
    constants allow the pair skip (decided on the host: ``stencil.
    Decisions.k4_skip``).  On CUDA tensors the kernel runs on the current
    stream (no synchronisation); on CPU tensors the plain version runs.
    Returns ``mut'``."""
    global K4_LAUNCHES
    if mut.dim() != 3:
        raise ValueError(f"mut must be [26, W, H], got {tuple(mut.shape)}")
    shape = tuple(mut.shape[1:])
    dev = mut.device
    _check_plane_stack("mut", mut, N_MUT, shape, dev)
    _check_plane_stack("immut", immut, N_IMMUT, shape, dev)
    if far is not None:
        _check_plane_stack("far", far, 5, shape, dev)
    devc = consts_vec.device.type != "cpu"
    if (consts_vec.dtype != torch.float32
            or tuple(consts_vec.shape) != (N_CONSTS,)
            or (devc and (consts_vec.device != dev
                          or not consts_vec.is_contiguous()))):
        raise ValueError(f"consts_vec must be a float32 [{N_CONSTS}] on the "
                         f"CPU or on {dev}")
    if devc and skip is None:
        raise ValueError("device constants need the host's skip decision "
                         "(skip=)")
    if not 0 <= stencil <= MAX_STENCIL:
        raise ValueError(f"stencil {stencil} outside [0, {MAX_STENCIL}]")
    if dev.type == "cpu":
        return fused_substep_plain(mut, immut, consts_vec, stencil=stencil,
                                   quantized=quantized, far=far)
    if dev.type != "cuda":
        raise ValueError(f"no K4 kernel for device {dev}")
    lib = _lib.library()
    cvec = consts_vec.contiguous()
    out = torch.empty_like(mut)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        far_ptr = None if far is None else far.data_ptr()
        if devc:
            err = lib.sb_fused_substep_dev(
                mut.data_ptr(), immut.data_ptr(), far_ptr, out.data_ptr(),
                cvec.data_ptr(), int(skip), shape[0], shape[1], stencil,
                int(quantized), stream)
        else:
            err = lib.sb_fused_substep(
                mut.data_ptr(), immut.data_ptr(), far_ptr, out.data_ptr(),
                cvec.data_ptr(), shape[0], shape[1], stencil,
                int(quantized), stream)
    _lib.check(err, "K4 fused_substep")
    K4_LAUNCHES += 1
    return out


def _frame_args(consts, uin, spec, cfg, device):
    """The frame's consts vector on ``device`` and K4's keyword arguments
    (the pair skip decided on the host: ``stencil.decisions``)."""
    check_reference_offsets(spec)
    cvec = consts_vector(consts, uin, cfg, spec.height, device=device)
    stencil = 0 if cfg.collision_mode == "none" else spec.collision_stencil
    return cvec, dict(stencil=stencil,
                      quantized=cfg.force_mode == "quantized",
                      skip=decisions(consts, cfg).k4_skip)


def fused_frame(mut, immut, consts: PhysicsConstants, uin: UserInput, spec,
                cfg: StaticConfig):
    """One frame (``cfg.subticks`` substeps) over the packed stacks."""
    cvec, k4kw = _frame_args(consts, uin, spec, cfg, mut.device)
    for _ in range(cfg.subticks):
        mut = fused_substep_call(mut, immut, cvec, **k4kw)
    return mut


def rebuild_far_list_packed(mut, immut, *, s: int, ff, radius: float):
    """The far-field candidate list of the packed stacks (no
    velocities, as the JAX package's packed path builds it)."""
    return rebuild_far_list_planes(mut[PX], mut[PY], immut[ALIVE] > 0.0,
                                   s=s, ff=ff, radius=radius)


def packed_far_motion(mut, immut, fl):
    """(max COM-relative displacement since the rebuild, max COM-relative
    speed) of the packed stacks, as 0-d tensors: the rebuild trigger's
    inputs."""
    pos = torch.stack([mut[PX], mut[PY]], -1)
    vel = torch.stack([mut[VX], mut[VY]], -1)
    alive = immut[ALIVE] > 0.0
    return displacement_check(pos, alive, fl), max_relative_speed(vel, alive)


def fused_frame_far(mut, immut, fl, consts: PhysicsConstants,
                    uin: UserInput, spec, cfg: StaticConfig, ffspec):
    """One frame with far-field contacts: each substep computes the far
    delta planes ``[5, W, H]`` from the current state
    (``farfield.far_collision_terms`` over the list ``fl``) and K4
    consumes them.  Linear indices use the unpadded height ``H`` (the
    JAX package passes its padded height; both keep (x, y) order, so the
    nudge signs agree)."""
    cvec, k4kw = _frame_args(consts, uin, spec, cfg, mut.device)
    sc = Scalars.of(cvec)
    alive = immut[ALIVE] > 0.0
    for _ in range(cfg.subticks):
        far = torch.stack(far_collision_terms(
            mut[PX], mut[PY], mut[VX], mut[VY], alive, fl,
            s=spec.collision_stencil, ff=ffspec,
            radius=cfg.particle_radius, dt=cfg.dt, ecoeff=sc.ecoeff,
            friction=sc.friction, world_h=spec.height))
        mut = fused_substep_call(mut, immut, cvec, far=far, **k4kw)
    return mut


# the compiled counterparts of the JAX package's jitted path-B functions
# (``softbody_tpu/ops/pallas/fused_substep.py:548-604``; ``ops/
# compiled.py``): CUDA graphs on the card, the functions on the CPU
fused_frame_jit = Compiled(fused_frame, static_argnames=("spec", "cfg"),
                           decide=frame_decisions)
fused_frame_far_jit = Compiled(
    fused_frame_far, static_argnames=("spec", "cfg", "ffspec"),
    decide=frame_decisions)
packed_far_motion_jit = Compiled(packed_far_motion)
