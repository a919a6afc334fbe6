"""Spatial sharding of the fused substep (kernel K1), with the far field
across slabs: the port of ``softbody_tpu/parallel/fused_spatial2.py``.

**Near field**, as ``fused_spatial.py``: each slab is its own stack
``[planes, ring + w_loc + ring, H]`` (hot, obs, immut); each substep
writes the neighbours' ``hx = max(1, stencil)`` edge columns of ``hot``
into the ghosts, then K1 runs on the slab.  The frame's last substep is
the observing one (obs is written and read in the interior only).  A
sharded near-field frame equals the single-device ``fused_frame2`` bit
for bit.

**Far field across slabs** (``ffspec``), as the JAX function does it:

- the rebuild runs every ``rebuild_every`` substeps on a fixed schedule,
  after an exchange of the whole ghost ring (``2·chunk`` columns: band
  detection reads up to ``2·chunk − 1`` columns away, so a pair across a
  boundary is seen from true data by the side that owns it);
- each slab runs the detection front end (``farfield._chunk_detection``,
  kernel K2) on its own planes, ghosts included: the swept envelope's
  mean velocity is the slab's, not the world's (any mean gives a sound
  envelope, but the candidate lists differ from one device's);
- the owned chunk columns go into an ``all_gather``, embedded in the
  world's chunk grid (the port's unpadded grid, ``farfield._chunk_dims``);
  ``rebuild_far_list_from_chunks`` builds the same list on every shard;
- each substep, the owner of each listed chunk gathers its window
  (``far_gather_windows``), the others give zeros, and a ``psum`` makes
  the table; ``far_pair_contributions`` runs on it, each shard scatters
  its own rows (``far_scatter_contributions``, every cell's sum in list
  order) into far planes, and K1 takes them (``far=``).

This is the windowed far apply, not the single-device frame's v4 mirror
route, so kernel K7 is not on this path.  Chunks never straddle a slab
boundary: the slab width and the ring are whole chunks (checked).  The
frame returns its rebuilds' record (the last one's ``n_pairs`` and
``overflow``, the largest of each; device tensors, copied out of a
graph), and the step keeps it in :data:`FAR_RECORD`: no host read in the
frame, and :func:`far_stats` reads it outside.

The step is compiled (``parallel/captured.py``), the counterpart of the
JAX function's ``jax.jit``: with every slab on one CUDA device the frame
is one CUDA graph per key (K1's pair skip among it), K1 reading the
constants and the user input from device memory
(``sb_fused_substep2_dev``), the rebuilds on their fixed schedule (no
conditional node), replayed with no host read; on a mesh over several
CUDA devices it runs eagerly, op by op.

The JAX package's ``tile_w`` and its ``PAD_W`` margins are Mosaic
layout, and ``interpret`` a Pallas flag (the device decides which
version of K1 and K2 runs): ``tile_w`` and ``interpret`` are accepted
and ignored, and the ring is part of the stack.  The frame never writes
its input stacks: the exchange writes the ghosts of the frame's own copy
of each ``hot`` slab (one copy of each a frame), so with either
``donate`` the input stays valid and unchanged, the port's ``frame_jit``
contract.  Far-field chunk ids differ from the JAX function's, whose
grid is padded by ``PAD_W``/``PAD_H``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..config import PhysicsConstants, StaticConfig, UserInput
from ..ops.cuda.fused_substep2 import (
    ALIVE,
    PX,
    PY,
    VX,
    VY,
    _frame_consts,
    fused_substep2_call,
    pack_lattice2,
    unpack_lattice2,
)
from ..ops.farfield import (
    _BIG,
    ChunkPlanes,
    FarFieldSpec,
    _chunk_detection,
    _chunk_dims,
    far_gather_windows,
    far_pair_contributions,
    far_scatter_contributions,
    rebuild_far_list_from_chunks,
)
from ..ops.stencil import LatticeSpec, LatticeState
from .captured import ShardedStep, lattice_decide
from .fused_spatial import (
    GHOST,
    check_ring,
    check_slabs,
    exchange,
    interiors,
    neighbour_perms,
    slab_windows,
)
from .mesh import Mesh, all_gather, per_device, psum

# the far-armed frames' rebuilds since the last reset: their count, and
# the last one's n_pairs and overflow and the largest of each (0-d device
# tensors; read with far_stats())
FAR_RECORD: dict = {"rebuilds": 0}


def far_stats(reset: bool = True) -> dict:
    """The far-armed frames' rebuild record on the host (one read):
    ``rebuilds``, the last rebuild's ``n_pairs`` and ``overflow``, and
    the largest of each since the last reset (``max_pairs``,
    ``max_overflow``)."""
    rec = dict(FAR_RECORD)
    if reset:
        FAR_RECORD.clear()
        FAR_RECORD["rebuilds"] = 0
    if rec["rebuilds"] == 0:
        return {"rebuilds": 0, "n_pairs": 0, "overflow": 0,
                "max_pairs": 0, "max_overflow": 0}
    keys = ("n_pairs", "overflow", "max_pairs", "max_overflow")
    vals = torch.stack([rec[k].to(torch.int64) for k in keys]).tolist()
    return {"rebuilds": rec["rebuilds"], **dict(zip(keys, vals))}


def _frame_record(rec, fl) -> torch.Tensor:
    """The frame's rebuild record after the rebuild of list ``fl``: an
    int32 ``[4]``, the last ``n_pairs`` and ``overflow``, the largest of
    each (``rec``: the record so far, or None)."""
    n, o = fl.n_pairs.to(torch.int32), fl.overflow.to(torch.int32)
    if rec is None:
        return torch.stack([n, o, n, o])
    return torch.stack([n, o, torch.maximum(rec[2], n),
                        torch.maximum(rec[3], o)])


def _record(rec: torch.Tensor, rebuilds: int) -> None:
    """Keep a frame's record (:func:`_frame_record`) of ``rebuilds``
    rebuilds in :data:`FAR_RECORD` (on the device, no read)."""
    first = FAR_RECORD["rebuilds"] == 0
    FAR_RECORD["rebuilds"] += rebuilds
    FAR_RECORD["n_pairs"], FAR_RECORD["overflow"] = rec[0], rec[1]
    for k, v in (("max_pairs", rec[2]), ("max_overflow", rec[3])):
        FAR_RECORD[k] = v if first else torch.maximum(FAR_RECORD[k], v)


def pack_lattice2_sharded(
    state: LatticeState,
    n_dev: int,
    tile_w: int = 128,
    *,
    ghost: int = GHOST,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """LatticeState → per-shard K1 stacks with authentic ghost rings:
    ``(hot [n, 18, w_loc + 2·ghost, H], obs [n, 8, …], immut [n, 2, …],
    edge_consts [20], w_loc)``."""
    w_loc = check_slabs(state.shape[0], n_dev)
    hot, obs, immut, ec = pack_lattice2(state)
    return (slab_windows(hot, n_dev, ghost), slab_windows(obs, n_dev, ghost),
            slab_windows(immut, n_dev, ghost), ec, w_loc)


def unpack_lattice2_sharded(hot_sh, obs_sh, template: LatticeState,
                            n_dev: int, w_loc: int) -> LatticeState:
    """Per-shard stacks (lists or stacked tensors) → LatticeState
    (interiors concatenated) on ``template``'s device."""
    dev = template.device
    return unpack_lattice2(
        interiors([hot_sh[d] for d in range(n_dev)], w_loc, dev),
        interiors([obs_sh[d] for d in range(n_dev)], w_loc, dev), template)


def shard_stacks2(hot_sh, obs_sh, immut_sh, mesh: Mesh, *,
                  sp_axis: str = "sp"):
    """Place each shard's stacks on its device of ``mesh[sp_axis]``."""
    devs = mesh.axis_devices(sp_axis)

    def put(sh):
        return [sh[j].to(d).contiguous() for j, d in enumerate(devs)]

    return put(hot_sh), put(obs_sh), put(immut_sh)


def _owner_of(cx: torch.Tensor, c: int, w_loc: int,
              n_dev: int) -> torch.Tensor:
    """The shard owning chunk column ``cx`` of the world's grid: the slab
    holding the chunk's first column; the grid's padding chunks past the
    world clamp to the last shard (no particle is alive there)."""
    return torch.clamp(torch.div(cx * c, w_loc, rounding_mode="floor"),
                       0, n_dev - 1)


def fused_spatial2_frame_fn(
    spec: LatticeSpec,
    cfg: StaticConfig,
    mesh: Mesh,
    *,
    sp_axis: str = "sp",
    tile_w: int = 128,
    donate: bool = True,
    interpret: bool = False,
    ffspec: Optional[FarFieldSpec] = None,
    rebuild_every: int = 8,
) -> ShardedStep:
    """A frame step over the stacks of :func:`shard_stacks2`:
    ``fn(hot_sh, obs_sh, immut_sh, edge_consts, consts, uin) → (hot_sh,
    obs_sh)``.  With ``ffspec`` the frame also resolves far-field
    contacts across the whole world (see the module docstring);
    ``cfg.subticks`` must be a multiple of ``rebuild_every`` and
    ``ffspec.horizon ≥ rebuild_every``.  Every slab on one CUDA device: a
    captured CUDA graph (``fn.stats()``); slabs on several CUDA devices:
    eagerly, op by op (``parallel/captured.py``).  ``donate``,
    ``interpret`` and ``tile_w`` are the JAX function's, accepted and
    ignored: the input stacks stay valid and unchanged."""
    n_dev = mesh.shape[sp_axis]
    w_loc = check_slabs(spec.width, n_dev)
    hx = max(1, spec.collision_stencil)
    if w_loc < 2 * hx:
        raise ValueError("slab too narrow for the ghost ring")
    ff = ffspec
    if ff is not None:
        c = ff.chunk
        if w_loc % c:
            raise ValueError("PAD_W and slab width must be chunk multiples")
        if cfg.subticks % rebuild_every:
            raise ValueError("subticks must be a multiple of rebuild_every")
        if ff.horizon < rebuild_every:
            raise ValueError("ffspec.horizon must cover rebuild_every")
    perms = neighbour_perms(n_dev)
    # the world's chunk grid (ids mean the same on every shard)
    cwx_g = cwy_g = None
    if ff is not None:
        cwx_g, cwy_g, _wp, _hp = _chunk_dims(spec.width, spec.height, ff)

    def near_frame(hs, obs_sh, imms, args):
        for i in range(cfg.subticks):
            exchange(hs, hx, w_loc, perms)
            if i < cfg.subticks - 1:
                hs = [fused_substep2_call(h, im, args[h.device][0],
                                          **args[h.device][1])
                      for h, im in zip(hs, imms)]
        out = [fused_substep2_call(h, im, args[h.device][0], obs_in=o,
                                   **args[h.device][1])
               for h, im, o in zip(hs, imms, obs_sh)]
        return [o[0] for o in out], [o[1] for o in out]

    def rebuild(hs, alive, ring):
        """Per-slab detection → owned chunk columns → all_gather → the
        world's candidate list, built once per device."""
        cl0, cln = ring // c, w_loc // c
        cps = [_chunk_detection(h[PX], h[PY], a, s=spec.collision_stencil,
                                ff=ff, radius=cfg.particle_radius,
                                vxu=h[VX], vyu=h[VY], dt=cfg.dt)
               for h, a in zip(hs, alive)]
        names = ("iminx", "imaxx", "iminy", "imaxy", "cany", "cband")
        fills = (_BIG, -_BIG, _BIG, -_BIG, False, False)
        gathered = {n: all_gather([getattr(cp, n)[cl0:cl0 + cln]
                                   for cp in cps]) for n in names}
        lists, by_dev = [], {}
        for j, (h, cp) in enumerate(zip(hs, cps)):
            if h.device not in by_dev:
                planes = {}
                for n, fill in zip(names, fills):
                    g = gathered[n][j]
                    out = torch.full((cwx_g, cwy_g), fill, dtype=g.dtype,
                                     device=g.device)
                    out[: g.shape[0]] = g
                    planes[n] = out
                by_dev[h.device] = rebuild_far_list_from_chunks(
                    ChunkPlanes(com=cp.com, **planes), h[PX], h[PY], h[VX],
                    h[VY], ff=ff)
            # the list is the same on every shard; its reference planes
            # (unused by this apply) are the shard's own
            lists.append(dataclasses.replace(
                by_dev[h.device], px_ref=h[PX], py_ref=h[PY],
                vx_ref=h[VX], vy_ref=h[VY], com_ref=cp.com))
        return lists

    def far_planes(hs, alive, fls, ring, consts):
        """Each shard's far delta planes ``[5, slab, H]`` (the windowed
        apply: owners gather, psum, pair math, owned rows scattered)."""
        ids = [torch.cat([fl.ca, fl.cb]) for fl in fls]
        cxs = [torch.div(i, cwy_g, rounding_mode="floor") for i in ids]
        cys = [i % cwy_g for i in ids]
        mine, lcx, g_loc = [], [], []
        for j, (h, a) in enumerate(zip(hs, alive)):
            m = _owner_of(cxs[j], c, w_loc, n_dev) == j
            lc = torch.where(m, cxs[j] - (j * w_loc) // c + ring // c, 0)
            stack = torch.stack([h[PX], h[PY], h[VX], h[VY],
                                 a.to(torch.float32)])
            g = far_gather_windows(stack, lc, cys[j], c=c, w=stack.shape[1],
                                   h=stack.shape[2])
            mine.append(m)
            lcx.append(lc)
            g_loc.append(torch.where(m[:, None], g, 0.0))
        g_all = psum(g_loc)
        contrib, out = {}, []
        for j, h in enumerate(hs):
            if h.device not in contrib:
                contrib[h.device] = far_pair_contributions(
                    g_all[j], fls[j], cxs[j], cys[j],
                    s=spec.collision_stencil, ff=ff,
                    radius=cfg.particle_radius, dt=cfg.dt,
                    ecoeff=consts.ecoeff, friction=consts.friction,
                    world_h=spec.height)
            w_ext = h.shape[1]
            _cwx, _cwy, wp, hp = _chunk_dims(w_ext, spec.height, ff)
            valid = torch.cat([fls[j].valid, fls[j].valid]) & mine[j]
            planes = far_scatter_contributions(
                contrib[h.device], lcx[j], cys[j], c=c, wp=wp, hp=hp,
                valid=valid)
            out.append(planes[:, :w_ext, :spec.height].contiguous())
        return out

    def far_frame(hs, obs_sh, imms, args, consts):
        ring = (hs[0].shape[1] - w_loc) // 2
        if ring < 2 * c:
            raise ValueError(f"far band reach {2 * c} exceeds margin {ring}")
        if ring % c:
            raise ValueError("PAD_W and slab width must be chunk multiples")
        if w_loc < ring:
            raise ValueError("slab too narrow for the ghost ring")
        alive = [im[ALIVE] > 0.0 for im in imms]
        n = cfg.subticks
        rec = None
        for i in range(n):
            exchange(hs, ring, w_loc, perms)
            if i % rebuild_every == 0:
                fls = rebuild(hs, alive, ring)
                rec = _frame_record(rec, fls[0])
            far = far_planes(hs, alive, fls, ring, consts)
            if i < n - 1:
                hs = [fused_substep2_call(h, im, args[h.device][0], far=f,
                                          **args[h.device][1])
                      for h, im, f in zip(hs, imms, far)]
        out = [fused_substep2_call(h, im, args[h.device][0], far=f,
                                   obs_in=o, **args[h.device][1])
               for h, im, f, o in zip(hs, imms, far, obs_sh)]
        return [o[0] for o in out], [o[1] for o in out], rec

    def frame(hot_sh: List[torch.Tensor], obs_sh: List[torch.Tensor],
              immut_sh: List[torch.Tensor], edge_consts: torch.Tensor,
              consts: PhysicsConstants, uin: UserInput):
        # the consts vector on each slab's device and K1's arguments (its
        # pair skip decided on the host)
        args = per_device(hot_sh, lambda d: _frame_consts(
            consts, uin, spec, cfg, edge_consts, (), d))
        hs = [h.clone() for h in hot_sh]
        if ff is None:
            return near_frame(hs, obs_sh, immut_sh, args)
        return far_frame(hs, obs_sh, immut_sh, args, consts)

    def step(run, hot_sh: Sequence[torch.Tensor],
             obs_sh: Sequence[torch.Tensor],
             immut_sh: Sequence[torch.Tensor], edge_consts: torch.Tensor,
             consts: PhysicsConstants, uin: UserInput
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        check_ring(hot_sh, w_loc, hx, n_dev)
        out = run(list(hot_sh), list(obs_sh), list(immut_sh), edge_consts,
                  consts, uin)
        if ff is None:
            return out
        hs, obs, rec = out
        _record(rec, cfg.subticks // rebuild_every)
        return hs, obs

    return ShardedStep(frame, step, devices=mesh.axis_devices(sp_axis),
                       decide=lattice_decide(cfg))
