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
(tests/test_fused4.py), nothing here.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from ...config import (
    N_CONSTS,
    PhysicsConstants,
    StaticConfig,
    UserInput,
    consts_vector,
)
from ..farfield import (
    crop_active,
    rebuild_far_list_planes,
    rebuild_far_list_planes_active,
)
from ..farfield4 import NARROW_MAX, bucketed_far_delta_planes
from ..stencil import (
    LatticeState,
    Scalars,
    check_reference_offsets,
    substep_planes,
)
from . import _lib

PX, PY, VX, VY, AX, AY = range(6)
TGT, LST, EAL = range(3)     # + 6 + 3c
N_HOT = 18
N_OBS = 8
ALIVE, PINNED = 0, 1
N_IMM = 2
N_EDGEC = 20                 # per class: spring damp yield limit length
EDGE_PARAMS = ("spring", "damp", "yield_strain", "strain_limit", "length")
MAX_STENCIL = 8

# launches of the CUDA kernel (the plain version does not count), in all
# and by instance (k1_instance)
K1_LAUNCHES = 0
K1_INSTANCE_LAUNCHES = {"strict": 0, "rsqrt": 0, "rollgroup": 0,
                        "rsqrt+rollgroup": 0}

# Mosaic layout and pipeline flags of the TPU kernel; bit-exact by the
# JAX package's contract (tests/test_fused4.py, the layout-flags test),
# so they change nothing here
LAYOUT_VARIANTS = ("lanecut", "ealpack", "outfull", "inbuf3", "kmirror")
# the JAX kernel's variant flags (softbody_tpu/ops/pallas/
# fused_substep2.py ``kvar``) that the port takes
KERNEL_VARIANTS = ("rsqrt", "rollgroup", "dexp2", "krec") + LAYOUT_VARIANTS
# the JAX FusedLatticeBackend's default (softbody_tpu/engine/
# backends.py:372-374), bench.py's BENCH_KVAR
DEFAULT_KVAR = ("rollgroup", "rsqrt", "dexp2", "lanecut", "krec", "ealpack")


def check_kvar(kvar) -> Tuple[str, ...]:
    """``kvar`` as a tuple; raises ``ValueError`` naming any flag outside
    :data:`KERNEL_VARIANTS` (the JAX kernel's attribution knobs
    ``nospring`` and ``noint`` are not physics and are not ported)."""
    kvar = tuple(kvar)
    bad = [v for v in kvar if v not in KERNEL_VARIANTS]
    if bad:
        raise ValueError(f"kernel variants {bad} are not ported (known: "
                         f"{KERNEL_VARIANTS})")
    return kvar


def k1_instance(rsqrt: bool, rollgroup: bool) -> str:
    """The name of K1's instance for these arithmetic flags."""
    names = [n for n, on in (("rsqrt", rsqrt), ("rollgroup", rollgroup))
             if on]
    return "+".join(names) or "strict"


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


def fused_substep2_plain(hot, immut, consts_vec, *, stencil: int,
                         quantized: bool, far=None, obs_in=None,
                         rsqrt: bool = False, rollgroup: bool = False):
    """Plain torch version of K1: the stencil path's substep on the packed
    planes (``ops/stencil.py``, with its ``rsqrt``/``rollgroup``
    variants), edge parameters from the consts vector.  Returns ``hot'``
    or, with ``obs_in``, ``(hot', obs')``."""
    sc = Scalars.of(consts_vec)
    # edge scalars as 0-d tensors on the state's device: float32
    # arithmetic, and true division on CUDA (see stencil.device_scalar)
    ec = consts_vec[N_CONSTS:N_CONSTS + N_EDGEC].to(hot.device)
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
        alive, immut[PINNED] > 0.0, edges, sc,
        stencil=stencil, quantized=quantized, far_deltas=(far,),
        rsqrt=rsqrt, rollgroup=rollgroup)
    out = list(planes)
    for u in ups:
        out += [u.target, u.last, u.alive.to(torch.float32)]
    hot_out = torch.stack(out)
    if obs_in is None:
        return hot_out
    obs = []
    for c, u in enumerate(ups):
        obs += [torch.where(u.active, u.strain, obs_in[2 * c]),
                torch.where(u.active, u.stress, obs_in[2 * c + 1])]
    return hot_out, torch.stack(obs)


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
                        quantized: bool, far=None, obs_in=None,
                        rsqrt: bool = False, rollgroup: bool = False):
    """One substep (kernel K1), strict or in the instance that
    ``rsqrt``/``rollgroup`` pick.

    ``hot [18,W,H]``, ``immut [2,W,H]``, optional ``far [5,W,H]`` delta
    planes and ``obs_in [8,W,H]`` (the observing variant), all float32,
    contiguous, on one device; ``consts_vec`` a CPU float32 ``[40]``.
    On CUDA tensors the kernel runs on the current stream (no
    synchronisation); on CPU tensors the plain version runs.  Returns
    ``hot'`` or ``(hot', obs')``."""
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
    if (consts_vec.device.type != "cpu" or consts_vec.dtype != torch.float32
            or tuple(consts_vec.shape) != (N_CONSTS + N_EDGEC,)):
        raise ValueError("consts_vec must be a CPU float32 [40] tensor")
    if not 0 <= stencil <= MAX_STENCIL:
        raise ValueError(f"stencil {stencil} outside [0, {MAX_STENCIL}]")
    if dev.type == "cpu":
        return fused_substep2_plain(hot, immut, consts_vec, stencil=stencil,
                                    quantized=quantized, far=far,
                                    obs_in=obs_in, rsqrt=rsqrt,
                                    rollgroup=rollgroup)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    lib = _lib.library()
    cvec = consts_vec.contiguous()
    hot_out = torch.empty_like(hot)
    obs_out = None if obs_in is None else torch.empty_like(obs_in)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sb_fused_substep2_variant(
            hot.data_ptr(), immut.data_ptr(),
            None if far is None else far.data_ptr(),
            None if obs_in is None else obs_in.data_ptr(),
            hot_out.data_ptr(),
            None if obs_out is None else obs_out.data_ptr(),
            cvec.data_ptr(), shape[0], shape[1], stencil, int(quantized),
            int(rsqrt), int(rollgroup), stream)
    _lib.check(err, "K1 fused_substep2")
    K1_LAUNCHES += 1
    K1_INSTANCE_LAUNCHES[k1_instance(rsqrt, rollgroup)] += 1
    return hot_out if obs_in is None else (hot_out, obs_out)


def _frame_consts(consts, uin, spec, cfg, edge_consts, kvar):
    """The consts vector and K1's keyword arguments of a frame under the
    variant flags ``kvar``."""
    check_reference_offsets(spec)
    kvar = check_kvar(kvar)
    if "dexp2" in kvar and float(consts.drag_exp) != 2.0:
        raise ValueError(f"kernel variant 'dexp2' needs drag_exp == 2, got "
                         f"{float(consts.drag_exp)}")
    cvec = torch.cat([consts_vector(consts, uin, cfg, spec.height),
                      edge_consts.to("cpu", torch.float32)])
    stencil = 0 if cfg.collision_mode == "none" else spec.collision_stencil
    return cvec, dict(stencil=stencil,
                      quantized=cfg.force_mode == "quantized",
                      rsqrt="rsqrt" in kvar, rollgroup="rollgroup" in kvar)


def fused_frame2(hot, obs, immut, edge_consts, consts: PhysicsConstants,
                 uin: UserInput, spec, cfg: StaticConfig,
                 n_sub: Optional[int] = None, kvar: Tuple[str, ...] = ()):
    """One frame without far field: ``n−1`` substeps + 1 observing
    substep, K1 in the instance of ``kvar``.  Returns ``(hot', obs')``."""
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, kvar)
    n = cfg.subticks if n_sub is None else n_sub
    for _ in range(n - 1):
        hot = fused_substep2_call(hot, immut, cvec, **k1kw)
    return fused_substep2_call(hot, immut, cvec, obs_in=obs, **k1kw)


def fused_frame4(hot, obs, immut, edge_consts, consts: PhysicsConstants,
                 uin: UserInput, spec, cfg: StaticConfig, ffspec,
                 n_sub: Optional[int] = None,
                 buckets: Tuple[int, ...] = (1024, 2048, 4096),
                 activation: bool = False, kvar: Tuple[str, ...] = ()):
    """One far-armed frame, fixed cadence (the JAX ``fused_frame4``, its
    xla-detect branch): ``n // R`` blocks of [rebuild → R substeps] with
    ``R = min(ffspec.horizon, n)``, plus a remainder block that also
    rebuilds.  Each substep applies the far pairs through the JAX v4
    route (``ops/farfield4.py::bucketed_far_delta_planes``: buckets ≤ 256
    narrow, larger ones through the record table of kernel K7; under
    ``krec`` every bucket through the table) then runs K1 in the instance
    of ``kvar``; the frame's last substep is the observing one.

    ``activation``: the rebuild also schedules each pair's first possible
    contact (``farfield.pair_activation``) and substep ``s`` of a block
    applies only the sorted list's first ``n_active[s]`` pairs.

    Returns ``(hot', obs', stats)`` with ``stats`` a CPU int32 ``[4]``:
    rebuilds, max n_pairs, max overflow, max active pairs (a block's
    active count at its last substep; ``n_pairs`` without
    ``activation``)."""
    ff = ffspec
    cvec, k1kw = _frame_consts(consts, uin, spec, cfg, edge_consts, kvar)
    narrow_max = 0 if "krec" in kvar else NARROW_MAX
    alive = immut[ALIVE] > 0.0
    n = cfg.subticks if n_sub is None else n_sub
    R = min(ff.horizon, n)
    blocks = [R] * (n // R) + ([n % R] if n % R else [])
    ecoeff = consts.ecoeff
    kw = dict(s=spec.collision_stencil, ff=ff, radius=cfg.particle_radius)
    st = [0, 0, 0, 0]
    for bi, size in enumerate(blocks):
        if activation:
            fl, n_act = rebuild_far_list_planes_active(
                hot[PX], hot[PY], alive, vx=hot[VX], vy=hot[VY], dt=cfg.dt,
                R=R, **kw)
            # the bucket choice needs the counts on the host: one read per
            # rebuild, which also carries the stats and the schedule
            n_pairs, overflow, *active = torch.cat([
                torch.stack([fl.n_pairs, fl.overflow]), n_act]).tolist()
        else:
            fl = rebuild_far_list_planes(hot[PX], hot[PY], alive, vx=hot[VX],
                                         vy=hot[VY], dt=cfg.dt, **kw)
            n_pairs, overflow = fl.counts()
            active = [n_pairs] * size
        st = [st[0] + 1, max(st[1], n_pairs), max(st[2], overflow),
              max(st[3], active[size - 1])]
        for j in range(size):
            fl_j = crop_active(fl, active[j]) if activation else fl
            far = bucketed_far_delta_planes(
                hot, immut[ALIVE], fl_j, active[j], dt=cfg.dt, ecoeff=ecoeff,
                friction=consts.friction, buckets=buckets,
                narrow_max=narrow_max, **kw)
            observing = bi == len(blocks) - 1 and j == size - 1
            out = fused_substep2_call(
                hot, immut, cvec, far=far, obs_in=obs if observing else None,
                **k1kw)
            if observing:
                hot, obs = out
            else:
                hot = out
    return hot, obs, torch.tensor(st, dtype=torch.int32)
