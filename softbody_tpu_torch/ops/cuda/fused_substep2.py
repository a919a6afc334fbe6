"""The fused lattice substep (kernel K1) and the frames built on it: the
port of ``softbody_tpu/ops/pallas/fused_substep2.py``.

Packed state is contiguous float32 ``[planes, W, H]`` (H innermost):
``hot [18, W, H]`` — px py vx vy ax ay, then per edge class c target,
last, alive at ``6 + 3c``; ``obs [8, W, H]`` — per class strain and
stress at ``2c``; ``immut [2, W, H]`` — alive, pinned.  Edge parameters
are uniform per class and ride the consts vector (20 edge scalars after
the 20 of ``config.consts_vector``).

``fused_substep2_call`` is the K1 wrapper: on a CUDA tensor it launches
the hand-written kernel (``csrc/fused_substep2.cu``), on a CPU tensor
it runs the plain version ``fused_substep2_plain``.

Kernel variants.  The frames take the JAX kernel's ``kvar`` vocabulary
(:data:`KERNEL_VARIANTS`).  Two flags change K1's arithmetic and pick
one of its four instances (:func:`k1_instance`): ``rsqrt`` and
``rollgroup`` (``ops/stencil.py``).  ``dexp2`` (the drag's ``|v|**e``
as ``v·v``, valid at ``e = 2`` only) needs no code: K1 and its plain
version already evaluate ``|v|**2`` as ``|v|·|v|``, the same float.
``krec`` sends every far-apply bucket through the record table (the
mirror route, kernel K7): the JAX kernel then reads the delta records
itself, which is that route's result bit for bit.  The rest are the TPU
kernel's layout (:data:`LAYOUT_VARIANTS`): bit-exact there by contract
(tests/test_fused4.py), nothing here.  ``nospring`` and ``noint`` are the
JAX kernel's attribution knobs, not physics (:data:`KNOBS`): the springs
contribute nothing and the edge and obs planes pass through, or the six
particle planes pass through; they split K1's time into springs,
collisions and the bare pipe.

The far-field frames' modes of K1 (``fused_substep2_call(refs=...,
detect=...)``, JAX's ``trig`` and ``detect``): the rebuild trigger's
statistics of the output state against the far list's linear reference
motion, and the detection side planes of the input state (per group of
four rows along W and per column: alive-masked min and max of px py vx
vy and the band flag).  The frames: :func:`fused_frame2` (no far field),
:func:`fused_frame2_far` (a given list), :func:`fused_frame2_auto`
(rebuilds on the deviation trigger, ``farfield.list_invalid``),
:func:`fused_frame3_auto` (the triggered frame: trigger and detection in
K1, the list, side planes and trigger vector carried across frames) and
:func:`fused_frame4` (fixed cadence; ``detect_mode="kernel"`` takes each
block's detection from K1).  As JAX decides its rebuilds and buckets on
the device (``lax.cond`` / ``lax.switch``), so do these frames
(``compiled.device_if`` / ``device_switch``: IF nodes of the captured
graph on the card), and each has a compiled counterpart (``*_jit``)
that runs as one CUDA graph a frame there.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from ...config import (
    N_CONSTS,
    PhysicsConstants,
    StaticConfig,
    UserInput,
    consts_vector,
)
from ...utils.profiling import device_mark
from .. import compiled
from ..farfield import (
    ChunkPlanes,
    FarList,
    chunk_any_alive,
    crop_active,
    crop_far_list,
    displacement_check,
    extrude_chunk_planes,
    far_collision_terms,
    kernel_side_from_planes,
    list_invalid,
    max_relative_speed,
    raw_planes_from_side,
    rebuild_far_list_from_chunks,
    rebuild_far_list_planes,
    rebuild_far_list_planes_active,
)
from ..farfield4 import (
    NARROW_MAX,
    BlockOrder,
    _check_layout,
    bucket_index,
    bucketed_far_delta_planes,
)
from ..stencil import (
    EDGE_OFFSETS,
    LatticeState,
    Scalars,
    check_reference_offsets,
    decisions,
    frame_decisions,
    sqrt32,
    substep_planes,
    to_device,
)
from . import _lib
from .band_detect import band_flags_plain

PX, PY, VX, VY, AX, AY = range(6)
TGT, LST, EAL = range(3)     # + 6 + 3c
N_HOT = 18
N_OBS = 8
ALIVE, PINNED = 0, 1
N_IMM = 2
N_EDGEC = 20                 # per class: spring damp yield limit length
EDGE_PARAMS = ("spring", "damp", "yield_strain", "strain_limit", "length")
MAX_STENCIL = 8
# the far-field frames' scalars appended to the consts vector under trig
# or detect (fused_substep2.py:96-98): tau (the output state's time since
# the rebuild), the detect flag, the band's mean velocity, T_band, the
# band's base reach, speed_safety·dt
X_TAU, X_DET, X_VBX, X_VBY, X_TBAND, X_REACH, X_SAFDT, X_SPARE = range(8)
N_EXTRA = 8
# trig statistics [4]: max squared position and velocity deviation, sums
# of the alive velocities
N_STATS = 4
# detection side planes [9, ceil(W/4), H]
(S_MINX, S_MAXX, S_MINY, S_MAXY,
 S_VMINX, S_VMAXX, S_VMINY, S_VMAXY, S_BAND) = range(9)
N_SIDE = 9
FF_CHUNK = 4                 # the side planes' row group (FarFieldSpec.chunk)
SIDE_BIG = 3.0e38
# the triggered frame's carry vector [8] (fused_substep2.py:1640-1643)
T_MAXDD2, T_MAXDV2, T_VBX, T_VBY, T_SIDE_AGE = range(5)
N_TRIG = 8
_SUB_TX, _SUB_TY = 8, 32     # K1's tile (lattice_device.cuh), for stats

_ARITH = ("strict", "rsqrt", "rollgroup", "rsqrt+rollgroup")
# launches of the CUDA kernel (the plain version does not count), in all
# and by instance (k1_instance): the arithmetic variants, each also in
# the modes "detect" and "knobs"; "trig" and "trig+detect" strict only
K1_LAUNCHES = 0
K1_INSTANCE_LAUNCHES = {
    **{a: 0 for a in _ARITH},
    **{f"{a}+detect": 0 for a in _ARITH},
    **{f"{a}+knobs": 0 for a in _ARITH},
    "strict+trig": 0, "strict+trig+detect": 0,
}

# Mosaic layout and pipeline flags of the TPU kernel; bit-exact by the
# JAX package's contract (tests/test_fused4.py, the layout-flags test),
# so they change nothing here
LAYOUT_VARIANTS = ("lanecut", "ealpack", "outfull", "inbuf3", "kmirror")
# the JAX kernel's attribution knobs (not physics)
KNOBS = ("nospring", "noint")
# the JAX kernel's variant flags (softbody_tpu/ops/pallas/
# fused_substep2.py ``kvar``) that the port takes
KERNEL_VARIANTS = (("rsqrt", "rollgroup", "dexp2", "krec") + KNOBS
                   + LAYOUT_VARIANTS)
# the JAX FusedLatticeBackend's default (softbody_tpu/engine/
# backends.py:372-374), bench.py's BENCH_KVAR
DEFAULT_KVAR = ("rollgroup", "rsqrt", "dexp2", "lanecut", "krec", "ealpack")


def check_kvar(kvar) -> Tuple[str, ...]:
    """``kvar`` as a tuple; raises ``ValueError`` naming any flag outside
    :data:`KERNEL_VARIANTS`."""
    kvar = tuple(kvar)
    bad = [v for v in kvar if v not in KERNEL_VARIANTS]
    if bad:
        raise ValueError(f"kernel variants {bad} are not ported (known: "
                         f"{KERNEL_VARIANTS})")
    return kvar


def k1_instance(rsqrt: bool, rollgroup: bool, trig: bool = False,
                detect: bool = False, knobs: bool = False) -> str:
    """The name of K1's instance for these arithmetic flags and modes."""
    names = [n for n, on in (("rsqrt", rsqrt), ("rollgroup", rollgroup))
             if on] or ["strict"]
    names += [n for n, on in (("trig", trig), ("detect", detect),
                              ("knobs", knobs)) if on]
    return "+".join(names)


def uniform_edge_consts(state: LatticeState) -> Optional[torch.Tensor]:
    """Per-class ``(spring, damp, yield, limit, length)`` as a CPU float32
    ``[20]``, or None if any edge parameter varies over the lattice."""
    planes = [getattr(e, name) for e in state.edges for name in EDGE_PARAMS]
    flat = torch.stack([p.reshape(-1) for p in planes])
    if not bool((flat == flat[:, :1]).all()):
        return None
    return flat[:, 0].to("cpu", torch.float32).contiguous()


def pack_lattice2(state: LatticeState):
    """LatticeState → ``(hot [18,W,H], obs [8,W,H], immut [2,W,H],
    edge_consts [20])``.  Raises if edge parameters vary spatially."""
    ec = uniform_edge_consts(state)
    if ec is None:
        raise ValueError("the fused substep needs per-class-uniform edge "
                         "parameters")
    hot = [state.pos[..., 0], state.pos[..., 1],
           state.vel[..., 0], state.vel[..., 1],
           state.acc[..., 0], state.acc[..., 1]]
    obs = []
    for e in state.edges:
        hot += [e.target_length, e.last_length, e.alive]
        obs += [e.strain, e.stress]
    imm = [state.alive, state.pinned]

    def stack(planes):
        return torch.stack([p.to(torch.float32) for p in planes]).contiguous()

    return stack(hot), stack(obs), stack(imm), ec


def unpack_lattice2(hot: torch.Tensor, obs: torch.Tensor,
                    template: LatticeState) -> LatticeState:
    """Packed planes → LatticeState with ``template``'s edge parameters,
    particle alive and pinned masks."""
    edges = []
    for c, e in enumerate(template.edges):
        mb = 6 + 3 * c
        edges.append(dataclasses.replace(
            e,
            target_length=hot[mb + TGT],
            last_length=hot[mb + LST],
            alive=hot[mb + EAL] > 0.0,
            strain=obs[2 * c],
            stress=obs[2 * c + 1],
        ))
    return dataclasses.replace(
        template,
        pos=torch.stack([hot[PX], hot[PY]], -1),
        vel=torch.stack([hot[VX], hot[VY]], -1),
        acc=torch.stack([hot[AX], hot[AY]], -1),
        edges=tuple(edges),
    )


def _band_offsets(stencil: int, chunk: int = FF_CHUNK):
    """The half-plane band of the side planes' flag (``_band_offsets`` of
    the JAX kernel; ``FarFieldSpec.band_half_offsets``)."""
    r = 2 * chunk - 1
    return tuple((dx, dy) for dx in range(0, r + 1) for dy in range(-r, r + 1)
                 if (dx > 0 or dy > 0) and max(abs(dx), abs(dy)) > stencil)


def _row_groups(plane, alive, op, fill):
    """``[ceil(W/4), H]``: ``op`` over each group of four rows of
    ``where(alive, plane, fill)``, a partial last group filled."""
    w, h = plane.shape
    w4 = -(-w // FF_CHUNK)
    v = torch.full((w4 * FF_CHUNK, h), fill, dtype=torch.float32,
                   device=plane.device)
    v[:w] = torch.where(alive, plane, fill)
    return op(v.reshape(w4, FF_CHUNK, h), dim=1)


def detect_side_plain(px, py, vx, vy, alive, extras, *, stencil: int):
    """Plain version of K1's ``detect`` side planes ``[9, ceil(W/4), H]``
    of the state ``px py vx vy`` (``alive`` bool; ``extras`` the
    ``N_EXTRA`` host floats): per group of four rows and per column the
    alive-masked min and max of each plane (fill ±3e38) and the band flag
    (``fused_substep2.py:405-486``): an alive particle with an alive
    partner at a band offset within ``d² < ((base + dev_i) + dev_j)²``,
    ``dev = |v − v̄|·T_band`` (0 where dead); the band loop is K2's plain
    version."""
    out = []
    for plane in (px, py, vx, vy):
        out.append(_row_groups(plane, alive, torch.amin, SIDE_BIG))
        out.append(_row_groups(plane, alive, torch.amax, -SIDE_BIG))
    ddx = vx - extras[X_VBX]
    ddy = vy - extras[X_VBY]
    dev = torch.where(alive, sqrt32(ddx * ddx + ddy * ddy) * extras[X_TBAND],
                      0.0)
    flag = band_flags_plain(px, py, dev, extras[X_REACH] + dev, alive,
                            _band_offsets(stencil))
    out.append(_row_groups((alive & flag).to(torch.float32), alive,
                           torch.amax, 0.0))
    return torch.stack(out)


def trig_stats_plain(px, py, vx, vy, alive, refs, tau: float):
    """Plain version of K1's ``trig`` statistics ``[4]`` of the output
    state ``px py vx vy`` against the linear reference motion ``refs
    [4,W,H]`` (px py vx vy at the rebuild) at time ``tau``
    (``fused_substep2.py:962-984``): the max over alive particles of
    ``dd²`` and ``dv²`` and the sums of their ``vx`` and ``vy``."""
    rddx = px - (refs[0] + refs[2] * tau)
    rddy = py - (refs[1] + refs[3] * tau)
    rdvx = vx - refs[2]
    rdvy = vy - refs[3]
    dd2 = torch.where(alive, rddx * rddx + rddy * rddy, 0.0)
    dv2 = torch.where(alive, rdvx * rdvx + rdvy * rdvy, 0.0)
    return torch.stack([dd2.amax(), dv2.amax(),
                        torch.where(alive, vx, 0.0).sum(),
                        torch.where(alive, vy, 0.0).sum()])


def fused_substep2_plain(hot, immut, consts_vec, *, stencil: int,
                         quantized: bool, far=None, obs_in=None, refs=None,
                         detect: bool = False, rsqrt: bool = False,
                         rollgroup: bool = False, nospring: bool = False,
                         noint: bool = False, extras=None):
    """Plain torch version of K1: the stencil path's substep on the packed
    planes (``ops/stencil.py``, with its ``rsqrt``/``rollgroup``
    variants and K1's ``inv_dt2`` clip), edge parameters from the consts
    vector; with ``refs`` the trig statistics (:func:`trig_stats_plain`),
    with ``detect`` (and the detect flag on) the side planes
    (:func:`detect_side_plain`); ``nospring``/``noint`` the knobs.  The
    far-field scalars are ``extras`` where given (a tensor ``[8]``), else
    the consts vector's tail.  Returns ``hot'`` plus, in order, ``obs'``
    / ``stats`` / ``side`` for each one asked for."""
    # the scalars as 0-d tensors on the state's device: float32
    # arithmetic, and true division on CUDA (see stencil.device_scalar)
    consts_vec = to_device(consts_vec, hot.device)
    sc = Scalars.of(consts_vec)
    ec = consts_vec[N_CONSTS:N_CONSTS + N_EDGEC]
    extras = (consts_vec[N_CONSTS + N_EDGEC:] if extras is None
              else extras).tolist()
    edges = []
    for c in range(4):
        mb = 6 + 3 * c
        p = {name: ec[5 * c + i] for i, name in enumerate(EDGE_PARAMS)}
        edges.append(SimpleNamespace(
            target_length=hot[mb + TGT], last_length=hot[mb + LST],
            alive=hot[mb + EAL] > 0.0, **p))
    alive = immut[ALIVE] > 0.0
    planes, ups = substep_planes(
        hot[PX], hot[PY], hot[VX], hot[VY], hot[AX], hot[AY],
        alive, immut[PINNED] > 0.0, () if nospring else edges, sc,
        stencil=stencil, quantized=quantized, far_deltas=(far,),
        offsets=() if nospring else EDGE_OFFSETS, rsqrt=rsqrt,
        rollgroup=rollgroup, inv_dt2=True)
    out = list(hot[:6]) if noint else list(planes)
    if nospring:
        for e in edges:
            out += [e.target_length, e.last_length,
                    e.alive.to(torch.float32)]
    else:
        for u in ups:
            out += [u.target, u.last, u.alive.to(torch.float32)]
    res = [torch.stack(out)]
    if obs_in is not None:
        if nospring:
            res.append(obs_in.clone())
        else:
            obs = []
            for c, u in enumerate(ups):
                obs += [torch.where(u.active, u.strain, obs_in[2 * c]),
                        torch.where(u.active, u.stress, obs_in[2 * c + 1])]
            res.append(torch.stack(obs))
    if refs is not None:
        res.append(trig_stats_plain(out[PX], out[PY], out[VX], out[VY],
                                    alive, refs, extras[X_TAU]))
    if detect:
        w, h = alive.shape
        res.append(detect_side_plain(hot[PX], hot[PY], hot[VX], hot[VY],
                                     alive, extras, stencil=stencil)
                   if extras[X_DET] > 0.0 else
                   torch.empty((N_SIDE, -(-w // FF_CHUNK), h),
                               device=hot.device))
    return res[0] if len(res) == 1 else tuple(res)


def _check_plane_stack(name, t, n, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (n,) + shape:
        raise ValueError(f"{name} must have shape {(n,) + shape}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, hot on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_substep2_call(hot, immut, consts_vec, *, stencil: int,
                        quantized: bool, far=None, obs_in=None, refs=None,
                        detect: bool = False, rsqrt: bool = False,
                        rollgroup: bool = False, nospring: bool = False,
                        noint: bool = False, extras=None, hot_out=None,
                        obs_out=None, side_out=None, skip=None):
    """One substep (kernel K1), in the instance that ``rsqrt``/
    ``rollgroup`` and the modes pick.

    ``hot [18,W,H]``, ``immut [2,W,H]``, optional ``far [5,W,H]`` delta
    planes, ``obs_in [8,W,H]`` (the observing variant) and ``refs
    [4,W,H]`` (px py vx vy of the far list's rebuild: the trig mode), all
    float32, contiguous, on one device; ``consts_vec`` a CPU float32
    ``[40]``, or ``[48]`` (the ``N_EXTRA`` scalars appended) under
    ``refs`` or ``detect``; or ``[40]`` and ``extras``, the ``N_EXTRA``
    scalars as a float32 ``[8]`` tensor on hot's device, which the kernel
    reads there (a captured frame computes them on the device).  Or
    ``consts_vec`` a float32 ``[40]`` on hot's device (the frames': their
    constants and user input are device buffers), which the kernel reads
    there (``sb_fused_substep2_dev``), with ``skip``, whether those
    constants allow the pair skip (decided on the host:
    ``stencil.Decisions.k1_skip``), and ``extras`` under ``refs`` or
    ``detect``.
    ``detect``: the side planes, when the detect flag is on (else the
    side output is not written).  ``hot_out``/``obs_out``/``side_out``:
    tensors to write the outputs into (else new ones).  The trig
    mode runs the strict arithmetic only (JAX's triggered frame does);
    the knobs ``nospring``/``noint`` run without trig and detect.  On
    CUDA tensors the kernel runs on the current stream (no
    synchronisation; the trig statistics' per-block partials are reduced
    there in a fixed order); on CPU tensors the plain version runs.
    Returns ``hot'`` plus, in order, ``obs'`` / ``stats [4]`` / ``side
    [9, ceil(W/4), H]`` for each one asked for."""
    global K1_LAUNCHES
    if hot.dim() != 3:
        raise ValueError(f"hot must be [18, W, H], got {tuple(hot.shape)}")
    shape = tuple(hot.shape[1:])
    dev = hot.device
    _check_plane_stack("hot", hot, N_HOT, shape, dev)
    _check_plane_stack("immut", immut, N_IMM, shape, dev)
    if far is not None:
        _check_plane_stack("far", far, 5, shape, dev)
    if obs_in is not None:
        _check_plane_stack("obs_in", obs_in, N_OBS, shape, dev)
    trig = refs is not None
    if trig:
        _check_plane_stack("refs", refs, 4, shape, dev)
    devc = consts_vec.device.type != "cpu"
    n_consts = N_CONSTS + N_EDGEC + (
        N_EXTRA if (trig or detect) and extras is None else 0)
    if devc:
        if (consts_vec.device != dev or consts_vec.dtype != torch.float32
                or tuple(consts_vec.shape) != (N_CONSTS + N_EDGEC,)
                or not consts_vec.is_contiguous()):
            raise ValueError(f"consts_vec on the card must be a contiguous "
                             f"float32 [{N_CONSTS + N_EDGEC}] on {dev}")
        if skip is None:
            raise ValueError("device constants need the host's skip "
                             "decision (skip=)")
        if (trig or detect) and extras is None:
            raise ValueError("device constants take the trig and detect "
                             "modes' scalars as extras")
    elif (consts_vec.dtype != torch.float32
            or tuple(consts_vec.shape) != (n_consts,)):
        raise ValueError(f"consts_vec must be a CPU float32 [{n_consts}] "
                         "tensor")
    if extras is not None:
        if not (trig or detect):
            raise ValueError("extras are the trig and detect modes' "
                             "scalars")
        if (extras.device != dev or extras.dtype != torch.float32
                or tuple(extras.shape) != (N_EXTRA,)):
            raise ValueError(f"extras must be a float32 [{N_EXTRA}] tensor "
                             f"on {dev}")
    if not 0 <= stencil <= MAX_STENCIL:
        raise ValueError(f"stencil {stencil} outside [0, {MAX_STENCIL}]")
    knobs = nospring or noint
    if knobs and (trig or detect):
        raise ValueError("the knobs nospring/noint run without trig and "
                         "detect")
    if trig and (rsqrt or rollgroup):
        raise ValueError("the trig mode runs the strict arithmetic only")
    w, h = shape
    outs = ((hot_out, N_HOT, True), (obs_out, N_OBS, obs_in is not None),
            (side_out, N_SIDE, detect))
    for name, (t, n, wanted) in zip(("hot_out", "obs_out", "side_out"),
                                    outs):
        if t is not None:
            if not wanted:
                raise ValueError(f"{name} given for an output not asked for")
            want = (-(-w // FF_CHUNK), h) if name == "side_out" else shape
            _check_plane_stack(name, t, n, want, dev)
    kw = dict(stencil=stencil, quantized=quantized, far=far, obs_in=obs_in,
              refs=refs, detect=detect, rsqrt=rsqrt, rollgroup=rollgroup,
              nospring=nospring, noint=noint)
    if dev.type == "cpu":
        res = fused_substep2_plain(hot, immut, consts_vec, extras=extras,
                                   **kw)
        res = list(res) if isinstance(res, tuple) else [res]
        into = ([hot_out] + [obs_out] * (obs_in is not None) + [None] * trig
                + [side_out] * detect)
        for i, (dst, src) in enumerate(zip(into, res)):
            if dst is not None:
                res[i] = dst.copy_(src)
        return res[0] if len(res) == 1 else tuple(res)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    lib = _lib.library()
    cvec = consts_vec.contiguous()
    if hot_out is None:
        hot_out = torch.empty_like(hot)
    if obs_out is None and obs_in is not None:
        obs_out = torch.empty_like(obs_in)
    n_blocks = -(-h // _SUB_TY) * -(-w // _SUB_TX)
    stats = (torch.empty((n_blocks, N_STATS), dtype=torch.float32,
                         device=dev) if trig else None)
    side = side_out
    if detect and side is None:
        side = torch.empty((N_SIDE, -(-w // FF_CHUNK), h),
                           dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (hot.data_ptr(), immut.data_ptr(), ptr(far), ptr(obs_in),
                ptr(refs), hot_out.data_ptr(), ptr(obs_out), ptr(stats),
                ptr(side), cvec.data_ptr(), w, h, stencil, int(quantized),
                int(rsqrt), int(rollgroup), int(trig), int(detect),
                int(nospring), int(noint))
        if devc:
            err = lib.sb_fused_substep2_dev(*args, int(skip), stream,
                                            ptr(extras))
        else:
            err = lib.sb_fused_substep2_modex(*args, stream, ptr(extras))
    _lib.check(err, "K1 fused_substep2")
    K1_LAUNCHES += 1
    K1_INSTANCE_LAUNCHES[k1_instance(rsqrt, rollgroup, trig, detect,
                                     knobs)] += 1
    res = [hot_out]
    if obs_out is not None:
        res.append(obs_out)
    if trig:
        # the blocks' partials in one fixed order (no float atomics)
        res.append(torch.cat([stats[:, :2].amax(dim=0),
                              stats[:, 2:].sum(dim=0)]))
    if detect:
        res.append(side)
    return res[0] if len(res) == 1 else tuple(res)


def _frame_consts(consts, uin, spec, cfg, edge_consts, kvar, device):
    """The consts vector on ``device`` (``config.consts_vector``, then the
    edge constants) and K1's keyword arguments of a frame under the
    variant flags ``kvar``, its pair skip among them (``stencil.
    decisions``: a compiled frame's, made on the host before its inputs
    were lifted)."""
    check_reference_offsets(spec)
    kvar = check_kvar(kvar)
    dec = decisions(consts, cfg)
    if "dexp2" in kvar and not dec.drag_exp2:
        raise ValueError(f"kernel variant 'dexp2' needs drag_exp == 2, got "
                         f"{consts.drag_exp}")
    cvec = torch.cat([consts_vector(consts, uin, cfg, spec.height,
                                    device=device),
                      to_device(edge_consts.to(torch.float32), device)])
    stencil = 0 if cfg.collision_mode == "none" else spec.collision_stencil
    return cvec, dict(stencil=stencil,
                      quantized=cfg.force_mode == "quantized",
                      rsqrt="rsqrt" in kvar, rollgroup="rollgroup" in kvar,
                      nospring="nospring" in kvar, noint="noint" in kvar,
                      skip=dec.k1_skip)


def fused_frame2(hot, obs, immut, edge_consts, consts: PhysicsConstants,
                 uin: UserInput, spec, cfg: StaticConfig,
                 n_sub: Optional[int] = None, observe: bool = True,
                 kvar: Tuple[str, ...] = ()):
    """One frame without far field: ``n−1`` substeps + 1 observing
    substep, K1 in the instance of ``kvar``.  ``observe=False`` runs ``n``
    substeps and passes ``obs`` through.  Returns ``(hot', obs')``."""
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, kvar,
                               hot.device)
    n = cfg.subticks if n_sub is None else n_sub
    for _ in range(n - 1 if observe else n):
        hot = fused_substep2_call(hot, immut, cvec, **k1kw)
    if not observe:
        return hot, obs
    return fused_substep2_call(hot, immut, cvec, obs_in=obs, **k1kw)


def _far_planes(hot, alive, fl, spec, cfg, ff, consts):
    """The far delta planes ``[5, W, H]`` of list ``fl`` on the state
    ``hot``: the windowed-gather pair math (``farfield.
    far_collision_terms``)."""
    return torch.stack(far_collision_terms(
        hot[PX], hot[PY], hot[VX], hot[VY], alive, fl,
        s=spec.collision_stencil, ff=ff, radius=cfg.particle_radius,
        dt=cfg.dt, ecoeff=consts.ecoeff, friction=consts.friction))


def fused_frame2_far(hot, obs, immut, edge_consts, fl,
                     consts: PhysicsConstants, uin: UserInput, spec,
                     cfg: StaticConfig, ffspec, n_sub: Optional[int] = None,
                     observe: bool = True, kvar: Tuple[str, ...] = ()):
    """:func:`fused_frame2` with far-field contacts of the given list
    ``fl``: each substep computes the far delta planes from the current
    state (:func:`_far_planes`) and K1 adds them.  Returns ``(hot',
    obs')``."""
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, kvar,
                               hot.device)
    alive = immut[ALIVE] > 0.0
    n = cfg.subticks if n_sub is None else n_sub
    for j in range(n):
        far = _far_planes(hot, alive, fl, spec, cfg, ffspec, consts)
        if observe and j == n - 1:
            return fused_substep2_call(hot, immut, cvec, far=far,
                                       obs_in=obs, **k1kw)
        hot = fused_substep2_call(hot, immut, cvec, far=far, **k1kw)
    return hot, obs


def _f32(x) -> float:
    return float(np.float32(x))


def _device_vector(values, device) -> torch.Tensor:
    """A float32 vector of host floats, filled on ``device`` (no
    host-to-device copy: a captured frame may not make one)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _working_list(fl: FarList) -> Tuple[FarList, torch.Tensor]:
    """A copy of ``fl`` that a triggered frame rebuilds in place
    (:func:`_assign_list`), and its reference planes stacked ``[4, W,
    H]`` (px py vx vy: K1's ``refs``), of which the copy's ``*_ref`` are
    views."""
    refs = torch.stack([fl.px_ref, fl.py_ref, fl.vx_ref, fl.vy_ref])
    return FarList(
        ca=fl.ca.clone(), cb=fl.cb.clone(), valid=fl.valid.clone(),
        n_pairs=fl.n_pairs.clone(), overflow=fl.overflow.clone(),
        px_ref=refs[0], py_ref=refs[1], com_ref=fl.com_ref.clone(),
        vx_ref=refs[2], vy_ref=refs[3], age=fl.age.clone()), refs


_LIST_FIELDS = ("ca", "cb", "valid", "n_pairs", "overflow", "px_ref",
                "py_ref", "com_ref", "vx_ref", "vy_ref")


def _assign_list(dst: FarList, src: FarList) -> None:
    """Write the rebuilt list ``src`` (age 0) into the working list
    ``dst`` of the same capacity."""
    if src.capacity != dst.capacity:
        raise ValueError(f"a rebuild of capacity {src.capacity} into a "
                         f"list of {dst.capacity}")
    for name in _LIST_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))
    dst.age.zero_()


def _list_stats(st, need, fl):
    """JAX's per-substep stats of a triggered frame: rebuilds, max
    n_pairs and max overflow of the lists the substeps ran with."""
    return torch.stack([st[0] + need.to(torch.int32),
                        torch.maximum(st[1], fl.n_pairs),
                        torch.maximum(st[2], fl.overflow)])


def _far_switch(far, fl, ff, buckets, planes_of) -> None:
    """``far`` ← the far delta planes of ``fl`` cropped to the smallest
    rung of ``buckets`` (below ``max_pairs``) or ``max_pairs`` that holds
    its pairs (``planes_of(cropped list)``), zeros for an empty list:
    JAX's ``lax.switch`` (farfield4.bucket_index), one IF node a rung
    under capture."""
    ladder = tuple(b for b in buckets if b < ff.max_pairs) + (ff.max_pairs,)

    def rung(k):
        far.copy_(planes_of(crop_far_list(fl, k)))

    compiled.device_switch(bucket_index(fl.n_pairs, ff, buckets),
                           [far.zero_] + [lambda k=k: rung(k)
                                          for k in ladder])


def fused_frame2_auto(hot, obs, immut, edge_consts, fl,
                      consts: PhysicsConstants, uin: UserInput, spec,
                      cfg: StaticConfig, ffspec, n_sub: Optional[int] = None,
                      observe: bool = True):
    """The far-field-autonomous frame of the JAX package: before each
    substep the deviation trigger (``farfield.list_invalid``) decides a
    velocity-extruded rebuild (``rebuild_far_list_planes``, K2's band
    pass; ``compiled.device_if``); K1 then takes the far delta planes of
    the list, zeros while it has no pairs (``lax.cond`` in JAX).  K1
    strict, as in JAX.  Every decision is made on the device: eagerly on
    the card each is one counted host read, captured none.  Returns
    ``(hot', obs', fl', stats)`` with ``stats`` an int32 ``[3]`` on the
    device: rebuilds, max n_pairs, max overflow of the lists the
    substeps ran with."""
    ff = ffspec
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, (),
                               hot.device)
    alive = immut[ALIVE] > 0.0
    n = cfg.subticks if n_sub is None else n_sub
    fl, _refs = _working_list(fl)
    st = torch.zeros(3, dtype=torch.int32, device=hot.device)
    far = hot.new_empty((5,) + tuple(hot.shape[1:]))
    for j in range(n):
        need = list_invalid(hot[PX], hot[PY], hot[VX], hot[VY], alive, fl,
                            cfg.dt, ff)

        def rebuild():
            _assign_list(fl, rebuild_far_list_planes(
                hot[PX], hot[PY], alive, s=spec.collision_stencil, ff=ff,
                radius=cfg.particle_radius, vx=hot[VX], vy=hot[VY],
                dt=cfg.dt))

        compiled.device_if(need, rebuild)
        st = _list_stats(st, need, fl)
        _far_switch(far, fl, ff, (), lambda flk: _far_planes(
            hot, alive, flk, spec, cfg, ff, consts))
        observing = observe and j == n - 1
        out = fused_substep2_call(hot, immut, cvec, far=far,
                                  obs_in=obs if observing else None, **k1kw)
        hot, obs = out if observing else (out, obs)
        fl.age.add_(1)
    return hot, obs, fl, st


def far3_carry_init(hot, immut, cfg: StaticConfig, spec, ffspec):
    """The triggered frame's initial ``(side, trig)`` carry
    (:func:`fused_frame3_auto`): the side planes of the packed state from
    ``farfield.kernel_side_from_planes`` (K2's band pass) and the trigger
    vector with ``T_MAXDD2`` huge, so that the first substep rebuilds,
    the alive mean velocity, and the side planes' age 1."""
    alive = immut[ALIVE] > 0.0
    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    vbx = torch.where(alive, hot[VX], 0.0).sum() / n_alive
    vby = torch.where(alive, hot[VY], 0.0).sum() / n_alive
    side = kernel_side_from_planes(
        hot[PX], hot[PY], alive, hot[VX], hot[VY],
        s=spec.collision_stencil, ff=ffspec, radius=cfg.particle_radius,
        T_band=float((ffspec.horizon + 1) * cfg.dt), vbar=(vbx, vby))
    # (stacked, not assigned element by element: assigning a host float
    # copies it from the host, which a captured frame may not)
    big, zero, one = _device_vector([1.0e30, 0.0, 1.0], hot.device)
    trig = torch.stack([big, zero, vbx, vby, one]
                       + [zero] * (N_TRIG - 5))
    return side, trig


def _rebuild_from_side(hot, side, cany, *, ff, radius: float, T):
    """A far list from K1's side planes (the detection of ``side``'s
    state): the chunk planes (``raw_planes_from_side``) swept for ``T``
    (a host float or a 0-d device tensor), then the candidate
    compaction, referenced to ``hot``."""
    w, h = hot.shape[1:]
    raw = raw_planes_from_side(side, w, h, (0, 0), ff)
    iminx, imaxx, iminy, imaxy = extrude_chunk_planes(
        raw, cany, ff=ff, radius=radius, T=T, extruded=True)
    cp = ChunkPlanes(iminx, imaxx, iminy, imaxy, cany, raw.band,
                     torch.zeros(2, dtype=torch.float32, device=hot.device))
    return rebuild_far_list_from_chunks(cp, hot[PX], hot[PY], hot[VX],
                                        hot[VY], ff=ff)


def fused_frame3_auto(hot, obs, immut, edge_consts, fl, side, trig,
                      consts: PhysicsConstants, uin: UserInput, spec,
                      cfg: StaticConfig, ffspec, n_sub: Optional[int] = None,
                      observe: bool = True,
                      buckets: Tuple[int, ...] = (512, 2048)):
    """The triggered far-field frame (JAX's ``fused_frame3_auto``): K1
    itself produces the trigger statistics (trig mode) and, when the
    detection flag is on, the side planes (detect mode); the list, the
    side planes and the trigger vector ride across frames
    (:func:`far3_carry_init` makes the first ``side``/``trig``).

    Per substep, from the trigger vector, on the device: ``maxdev = √max
    dd² + speed_safety·dt·√max dv²`` (float32); ``need = maxdev > skin/2
    | age ≥ horizon`` rebuilds from the carried side planes, swept for
    ``(horizon + side_age + 1)·dt`` (they describe the state
    ``side_age`` substeps back; ``compiled.device_if``); ``det = need |
    maxdev > skin/4 | age ≥ horizon − 2`` runs K1's detect instance,
    which also writes the side planes, else its trig instance (two
    bodies on complementary predicates).  The far apply crops the list
    to the smallest of ``buckets`` (below ``max_pairs``) or
    ``max_pairs`` that holds its pairs, zeros for an empty list.  K1
    strict, as in JAX; its far-field scalars (tau from the list's age,
    the detect flag, the band's mean velocity) are computed on the
    device and read there.  Returns ``(hot', obs', fl', side', trig',
    stats)``, ``stats`` an int32 ``[3]`` on the device: rebuilds, max
    n_pairs, max overflow."""
    ff = ffspec
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, (),
                               hot.device)
    dev = hot.device
    alive = immut[ALIVE] > 0.0
    n = cfg.subticks if n_sub is None else n_sub
    budget = np.float32(0.5 * ff.skin)
    half = float(np.float32(0.5) * budget)
    safdt = _f32(ff.speed_safety * cfg.dt)
    dt32 = _f32(cfg.dt)
    tail = _device_vector([_f32((ff.horizon + 1) * cfg.dt),
                           _f32(2.0 * cfg.particle_radius + ff.skin), safdt,
                           0.0], dev)
    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    cany = chunk_any_alive(alive, ff)
    fl, refs = _working_list(fl)
    side = side.clone()
    st = torch.zeros(3, dtype=torch.int32, device=dev)
    far = hot.new_empty((5,) + tuple(hot.shape[1:]))
    stats = hot.new_empty(N_STATS)
    pad = torch.zeros(N_TRIG - 5, dtype=torch.float32, device=dev)
    for j in range(n):
        maxdev = sqrt32(trig[T_MAXDD2]) + safdt * sqrt32(trig[T_MAXDV2])
        need = (maxdev > float(budget)) | (fl.age >= ff.horizon)
        det = need | (maxdev > half) | (fl.age >= ff.horizon - 2)
        side_age = trig[T_SIDE_AGE]

        def rebuild():
            T = ((side_age + float(ff.horizon)) + 1.0) * dt32
            _assign_list(fl, _rebuild_from_side(
                hot, side, cany, ff=ff, radius=cfg.particle_radius, T=T))

        compiled.device_if(need, rebuild)
        st = _list_stats(st, need, fl)
        _far_switch(far, fl, ff, buckets, lambda flk: _far_planes(
            hot, alive, flk, spec, cfg, ff, consts))
        extras = torch.cat([
            ((fl.age + 1).to(torch.float32) * dt32).reshape(1),
            det.to(torch.float32).reshape(1), trig[T_VBX:T_VBY + 1], tail])
        observing = observe and j == n - 1
        hot_new = torch.empty_like(hot)
        obs_new = torch.empty_like(obs) if observing else None

        def k1(detect: bool):
            outs = fused_substep2_call(
                hot, immut, cvec, far=far, obs_in=obs if observing else None,
                refs=refs, detect=detect, extras=extras, hot_out=hot_new,
                obs_out=obs_new, side_out=side if detect else None, **k1kw)
            stats.copy_(outs[2 if observing else 1])

        compiled.device_if(det, lambda: k1(True))
        compiled.device_if(~det, lambda: k1(False))
        hot = hot_new
        if observing:
            obs = obs_new
        trig = torch.cat([stats[:2], stats[2:4] / n_alive, torch.where(
            det, 1.0, side_age + 1.0).reshape(1), pad])
        fl.age.add_(1)
    return hot, obs, fl, side, trig, st


def rebuild_far_list_packed2(hot, immut, *, s: int, ff, radius: float):
    """Far-list rebuild from the packed stacks (no velocity sweep)."""
    return rebuild_far_list_planes(hot[PX], hot[PY], immut[ALIVE] > 0.0, s=s,
                                   ff=ff, radius=radius)


def packed_far_motion2(hot, immut, fl):
    """``(max COM-relative displacement since the rebuild, max speed
    relative to the mean)`` of the packed state (0-d tensors)."""
    pos = torch.stack([hot[PX], hot[PY]], dim=-1)
    vel = torch.stack([hot[VX], hot[VY]], dim=-1)
    alive = immut[ALIVE] > 0.0
    return displacement_check(pos, alive, fl), max_relative_speed(vel, alive)


def fused_frame4(hot, obs, immut, edge_consts, consts: PhysicsConstants,
                 uin: UserInput, spec, cfg: StaticConfig, ffspec,
                 n_sub: Optional[int] = None,
                 buckets: Tuple[int, ...] = (1024, 2048, 4096),
                 activation: bool = False, far_mb: int = 32,
                 far_mb_out: Optional[int] = None, detect_mode: str = "xla",
                 band_impl: str = "kernel", kvar: Tuple[str, ...] = ()):
    """One far-armed frame, fixed cadence (the JAX ``fused_frame4``):
    ``n // R`` blocks of [rebuild → R substeps] with ``R =
    min(ffspec.horizon, n)``, plus a remainder block that also rebuilds.
    Each substep applies the far pairs through the JAX v4 route
    (``ops/farfield4.py::bucketed_far_delta_planes``: the rung chosen on
    the device, zeros for an empty list; on the card's default layout K8
    with the block's destination order, built in its first apply's rung;
    otherwise buckets ≤ 256 narrow, larger ones through the record table
    of kernel K7, under ``krec`` every bucket through the table) then
    runs K1 in the instance of ``kvar``; the frame's last substep is the
    observing one.

    ``detect_mode="xla"``: each rebuild detects on its state (K2 for the
    band, or its plain loop under ``band_impl="plain"``: JAX's "xla").
    ``"kernel"``: each block's last substep runs K1's detect instance, and
    the next block rebuilds from its side planes (``raw_planes_from_side``,
    swept for ``(R + 1)·dt``: they describe the state one substep back);
    block 0's come from ``kernel_side_from_planes``; the last block never
    detects.  The band's mean velocity goes to K1 in device memory (the
    ``extras`` of :func:`fused_substep2_call`).  It refuses ``activation``
    and the ``krec``/``kmirror`` carry, as JAX does.

    ``activation``: the rebuild also schedules each pair's first possible
    contact (``farfield.pair_activation``) and substep ``s`` of a block
    applies only the sorted list's first ``n_active[s]`` pairs, its
    bucket chosen from that count.  ``far_mb``/``far_mb_out``: the mirror
    route's record lane blocks (gather, scatter; multiples of 32, JAX's
    measurement knobs); ``kmirror``/``krec`` take the 32-lane records
    only, as in JAX (``FusedLatticeBackend`` drops them for another
    layout).

    No host read: on the card each rung choice is one counted read
    eagerly, none captured.  Device marks (``utils/profiling.py``, with
    tracing on): ``rebuild`` before each block's rebuild, ``far_apply``
    before each far apply, ``substep`` before each K1, ``end`` after the
    last.  Returns ``(hot', obs', stats)`` with
    ``stats`` an int32 ``[4]`` on the device (JAX's ``merge_st``):
    rebuilds, max n_pairs, max overflow, max active pairs (a block's
    active count at its last substep; ``n_pairs`` without
    ``activation``)."""
    ff = ffspec
    _check_layout(far_mb, far_mb_out)
    if detect_mode not in ("xla", "kernel"):
        raise ValueError(f"detect_mode {detect_mode!r}: 'xla' or 'kernel'")
    kernel_detect = detect_mode == "kernel"
    if kernel_detect and activation:
        raise ValueError("detect_mode='kernel' is incompatible with the "
                         "activation schedule (it needs raw pre-extrusion "
                         "planes at rebuild time)")
    if kernel_detect and ("krec" in kvar or "kmirror" in kvar):
        raise ValueError("kvar 'kmirror'/'krec' is incompatible with "
                         "detect_mode='kernel'")
    if ("krec" in kvar or "kmirror" in kvar) and far_mb != 32:
        raise ValueError("kvar 'kmirror'/'krec' uses mb=32 records; "
                         f"far_mb={far_mb} unsupported")
    if "krec" in kvar and far_mb_out not in (None, 32):
        raise ValueError("kvar 'krec' emits mb=32 delta records; "
                         f"far_mb_out={far_mb_out} unsupported")
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, kvar,
                               hot.device)
    narrow_max = 0 if "krec" in kvar else NARROW_MAX
    alive = immut[ALIVE] > 0.0
    dev = hot.device
    n = cfg.subticks if n_sub is None else n_sub
    R = min(ff.horizon, n)
    blocks = [R] * (n // R) + ([n % R] if n % R else [])
    kw = dict(s=spec.collision_stencil, ff=ff, radius=cfg.particle_radius)
    far_kw = dict(dt=cfg.dt, ecoeff=consts.ecoeff, friction=consts.friction,
                  buckets=buckets, narrow_max=narrow_max, mb=far_mb,
                  mb_out=far_mb_out, **kw)
    if kernel_detect:
        cany = chunk_any_alive(alive, ff)
        n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
        t_band = float((R + 1) * cfg.dt)
        head = _device_vector([0.0, 1.0], dev)
        tail = _device_vector([_f32(t_band),
                               _f32(2.0 * cfg.particle_radius + ff.skin),
                               _f32(ff.speed_safety * cfg.dt), 0.0], dev)

        def vbar_of(h):
            return (torch.where(alive, h[VX], 0.0).sum() / n_alive,
                    torch.where(alive, h[VY], 0.0).sum() / n_alive)

        side = kernel_side_from_planes(
            hot[PX], hot[PY], alive, hot[VX], hot[VY], T_band=t_band,
            vbar=vbar_of(hot), band_impl=band_impl, **kw)
    st = torch.zeros(4, dtype=torch.int32, device=dev)
    for bi, size in enumerate(blocks):
        last_block = bi == len(blocks) - 1
        n_act = None
        device_mark("rebuild", hot)
        if kernel_detect:
            fl = _rebuild_from_side(hot, side, cany, ff=ff,
                                    radius=cfg.particle_radius, T=t_band)
        elif activation:
            fl, n_act = rebuild_far_list_planes_active(
                hot[PX], hot[PY], alive, vx=hot[VX], vy=hot[VY], dt=cfg.dt,
                R=R, band_impl=band_impl, **kw)
        else:
            fl = rebuild_far_list_planes(hot[PX], hot[PY], alive, vx=hot[VX],
                                         vy=hot[VY], dt=cfg.dt,
                                         band_impl=band_impl, **kw)
        na = fl.n_pairs if n_act is None else n_act[size - 1]
        st = torch.stack([st[0] + 1, torch.maximum(st[1], fl.n_pairs),
                          torch.maximum(st[2], fl.overflow),
                          torch.maximum(st[3], na)])
        order = BlockOrder(fl, same_list=n_act is None)
        for j in range(size):
            device_mark("far_apply", hot)
            fl_j = fl if n_act is None else crop_active(fl, n_act[j])
            far = bucketed_far_delta_planes(hot, immut[ALIVE], fl_j, None,
                                            order=order, **far_kw)
            device_mark("substep", hot)
            if kernel_detect and not last_block and j == size - 1:
                extras = torch.cat([head, torch.stack(vbar_of(hot)), tail])
                hot, side = fused_substep2_call(
                    hot, immut, cvec, far=far, detect=True, extras=extras,
                    **k1kw)
                continue
            observing = last_block and j == size - 1
            out = fused_substep2_call(
                hot, immut, cvec, far=far, obs_in=obs if observing else None,
                **k1kw)
            if observing:
                hot, obs = out
            else:
                hot = out
    device_mark("end", hot)
    return hot, obs, st


# the frames' compiled counterparts (JAX's jitted functions; ops/
# compiled.py): CUDA graphs on the card, the functions on the CPU
fused_frame2_jit = compiled.Compiled(
    fused_frame2, static_argnames=("spec", "cfg", "n_sub", "observe",
                                   "kvar"), decide=frame_decisions)
fused_frame2_far_jit = compiled.Compiled(
    fused_frame2_far, static_argnames=("spec", "cfg", "ffspec", "n_sub",
                                       "observe", "kvar"),
    decide=frame_decisions)
fused_frame2_auto_jit = compiled.Compiled(
    fused_frame2_auto, static_argnames=("spec", "cfg", "ffspec", "n_sub",
                                        "observe"), decide=frame_decisions)
far3_carry_init_jit = compiled.Compiled(
    far3_carry_init, static_argnames=("cfg", "spec", "ffspec"))
fused_frame3_auto_jit = compiled.Compiled(
    fused_frame3_auto, static_argnames=("spec", "cfg", "ffspec", "n_sub",
                                        "observe", "buckets"),
    decide=frame_decisions)
packed_far_motion2_jit = compiled.Compiled(packed_far_motion2)
fused_frame4_jit = compiled.Compiled(
    fused_frame4, static_argnames=("spec", "cfg", "ffspec", "n_sub",
                                   "buckets", "activation", "far_mb",
                                   "far_mb_out", "detect_mode", "band_impl",
                                   "kvar"), decide=frame_decisions)
