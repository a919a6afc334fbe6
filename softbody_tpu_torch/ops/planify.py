"""Planified general-topology engine: the port of
``softbody_tpu/ops/planify.py``.

Arbitrary beam graphs (editor scenes, blobs, meshes) run on the dense
stencil path by **embedding the particles into a ``[W, H]`` plane by
spatial position**: physical beams join spatially near particles, so
after a geometry-preserving embedding almost every beam becomes a small
index offset.  Beams then split into

- **dense classes**: one :class:`~.stencil.EdgeClass` plane set per
  distinct offset ``(dx, dy)`` within ``dense_reach``, evaluated by
  ``lattice_substep``'s spring pass over ``spec.edge_offsets``;
- **exception beams**: the few that did not embed locally (long beams,
  slot conflicts), a flat list evaluated with gathers and an int32
  ``index_add_`` into the same fixed-point accumulator (``extra_force``),
  so the total force stays one commutative integer sum
  (compute.wgsl:68-70, 127-130).

The embedding (``planify``) runs on the host in NumPy, once per scene or
snapshot load, exactly as the JAX package's: an equal-count column
partition by x, rows assigned monotonically by y on a global y → row
map, beam offsets classified, and the best of a few plane widths kept
by exception count and row stretch.  The planes and the exception list
are then built on the input state's device.

Collisions ride the dense collision stencil (kernel K3 under
``cfg.use_pallas``); contacts that develop after the embedding and are
index-distant in the plane come from the far field
(:func:`planified_frame_far`: the activation-scheduled rebuild with
kernel K2 and the v4 bucketed apply, K7 above 256 pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import PhysicsConstants, StaticConfig, UserInput
from ..state import SimState
from ..utils.profiling import device_mark
from .farfield import (
    _chunk_dims,
    crop_active,
    rebuild_far_list_planes_active,
)
from .farfield4 import BlockOrder, bucketed_far_delta_from_fn
from .forces import beam_terms, endpoint_sums
from .compiled import Compiled
from .stencil import (
    EdgeClass,
    LatticeSpec,
    LatticeState,
    Scalars,
    frame_decisions,
    frame_scalars,
    lattice_substep,
)


@dataclasses.dataclass
class ExceptionBeams:
    """Flat residual beams the embedding could not make local.  ``ia`` /
    ``ib`` are linear plane cells (int64); arrays are padded to a static
    capacity with ``alive=False`` tails."""

    ia: torch.Tensor
    ib: torch.Tensor
    length: torch.Tensor
    target_length: torch.Tensor
    last_length: torch.Tensor
    spring: torch.Tensor
    damp: torch.Tensor
    yield_strain: torch.Tensor
    strain_limit: torch.Tensor
    strain: torch.Tensor
    stress: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.ia.shape[0]


EXCEPTION_FIELDS = tuple(ExceptionBeams.__dataclass_fields__)


@dataclasses.dataclass
class PlanifiedState:
    """Plane-embedded world: the dense lattice state plus the exception
    beam list."""

    lat: LatticeState
    x: ExceptionBeams

    @property
    def pos(self) -> torch.Tensor:
        """Plane-shaped positions (as ``SimState.pos`` /
        ``LatticeState.pos``)."""
        return self.lat.pos


@dataclasses.dataclass(frozen=True)
class PlanifyAux:
    """Host-side maps of an embedding.

    ``cell_of[p]``: linear plane cell of particle p.  ``beam_class[m]`` /
    ``beam_cell[m]``: dense class and anchor cell of beam m, or class −1
    and its exception slot."""

    width: int
    height: int
    cell_of: np.ndarray
    beam_class: np.ndarray
    beam_cell: np.ndarray
    n_exceptions: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _assign_cells(pos: np.ndarray, w: int, h: int) -> np.ndarray:
    """Equal-count column partition + globally aligned monotone rows: a
    global y → row map (the same scale in every column) keeps
    y-neighbours in adjacent columns on nearby rows."""
    n = pos.shape[0]
    order_x = np.argsort(pos[:, 0], kind="stable")
    cell_of = np.full(n, -1, np.int64)
    per_col = -(-n // w)
    if per_col > h:
        raise ValueError(f"plane {w}x{h} too small for {n} particles")
    ymin = float(pos[:, 1].min())
    yspan = max(float(pos[:, 1].max()) - ymin, 1e-6)
    for cx in range(w):
        col = order_x[cx * per_col : (cx + 1) * per_col]
        if col.size == 0:
            continue
        col = col[np.argsort(pos[col, 1], kind="stable")]
        desired = ((pos[col, 1] - ymin) / yspan * (h - 1)).astype(np.int64)
        ar = np.arange(col.size, dtype=np.int64)
        # strictly increasing rows ≥ desired: subtract the rank, running
        # max, add the rank back (a running max alone would repeat rows
        # and overwrite plane cells)
        rows = np.maximum.accumulate(desired - ar) + ar
        if int(rows[-1]) > h - 1:
            rows = np.minimum(rows, h - col.size + ar)
        cell_of[col] = cx * h + rows
    return cell_of


def _classify(cell_of: np.ndarray, ba: np.ndarray, bb: np.ndarray,
              h: int, dense_reach: int):
    """Beam classification for an embedding: ``(is_exc, odx, ody,
    anchor)``.  A beam is an exception when its offset is not local or it
    loses a dense-slot conflict (two beams on one (offset, anchor) cell:
    the first in input order keeps the slot)."""
    ca, cb = cell_of[ba], cell_of[bb]
    dx = ca // h - cb // h
    dy = ca % h - cb % h
    flip = (dx > 0) | ((dx == 0) & (dy > 0))
    anchor = np.where(flip, cb, ca)
    odx = np.where(flip, dx, -dx)
    ody = np.where(flip, dy, -dy)
    local = ((np.abs(odx) <= dense_reach) & (np.abs(ody) <= dense_reach)
             & ((odx != 0) | (ody != 0)))
    r = dense_reach
    kid = (odx + r) * (2 * r + 1) + (ody + r)
    sid = kid.astype(np.int64) * np.int64(cell_of.size + h) + anchor
    is_exc = ~local
    li = np.where(local)[0]
    if li.size:
        _, first = np.unique(sid[li], return_index=True)
        keep = np.zeros(li.size, bool)
        keep[first] = True
        is_exc[li[~keep]] = True
    return is_exc, odx, ody, anchor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _search_layout(pos: np.ndarray, alive: np.ndarray, ba: np.ndarray,
                   bb: np.ndarray, balive: np.ndarray, *, dense_reach: int,
                   slack: float, lane_multiple: int, width: Optional[int],
                   chunk_multiple: int) -> Tuple[int, int, np.ndarray]:
    """``(w, h, cell_of)``: candidate widths around the aspect-matched
    square, each at the exact and the slack height, scored by the live
    beams' exception count plus a quarter of the rows stretched inside
    occupied column spans; the best wins (0 stops the search)."""
    n = pos.shape[0]
    live = np.where(alive)[0]
    span = (pos[live].max(axis=0) - pos[live].min(axis=0)) if live.size \
        else np.ones(2)
    aspect = max(float(span[0]) / max(float(span[1]), 1e-6), 1e-3)
    # far-armed embeddings need chunk-grid-aligned dims for the v4
    # apply's chunk-id decode (ops/farfield4.py): the lane dim a multiple
    # of chunk·tile_chunks, the width of the 4-row record
    cm = max(1, chunk_multiple)
    w0 = max(4, int(round(np.sqrt(n * aspect))))
    cands = [w0, _round_up(w0, 4)] if width is None else [width]
    for f in (0.85, 1.0, 1.15):
        cands.append(max(4, _round_up(int(w0 * f * np.sqrt(slack)), 4)))
    if cm > 1:
        cands = [_round_up(c, 4) for c in cands]
    lane_multiple = max(lane_multiple, cm)
    wh = []
    for w in sorted(set(cands)):
        h_slack = max(lane_multiple,
                      _round_up(max(-(-int(n * slack) // w), -(-n // w)),
                                lane_multiple))
        h_exact = max(lane_multiple, _round_up(-(-n // w), lane_multiple))
        # exact fit first: lattice-like scenes embed perfectly there
        wh += [(w, h_exact)] + ([(w, h_slack)] if h_slack != h_exact
                                else [])
    best = None
    for w, h in wh:
        try:
            cell_of = _assign_cells(pos, w, h)
        except ValueError:
            continue
        is_exc, *_ = _classify(cell_of, ba[balive], bb[balive], h,
                               dense_reach)
        cols, rows = cell_of // h, cell_of % h
        stretch = 0
        for cx in range(w):
            r = rows[cols == cx]
            if r.size:
                stretch += int(r.max() - r.min() + 1 - r.size)
        score = float(is_exc.sum()) + 0.25 * stretch
        if best is None or score < best[0]:
            best = (score, w, h, cell_of)
        if score == 0:
            break
    if best is None:
        raise ValueError("no feasible plane embedding")
    return best[1], best[2], best[3]


def planify(state: SimState, *, dense_reach: int = 3, slack: float = 1.35,
            lane_multiple: int = 8, exception_pad: int = 32,
            collision_stencil: int = 2, width: Optional[int] = None,
            chunk_multiple: int = 1):
    """Embed a :class:`SimState` into a plane layout.

    Returns ``(PlanifiedState, LatticeSpec, PlanifyAux)``, the state on
    the input state's device.  Host-side (NumPy), like the reference's
    buffer rebuild on a snapshot load (engineWorker.ts:532-538).
    ``chunk_multiple``: the far field's ``chunk · tile_chunks`` when the
    plane will run far-armed (its lane dim must be a multiple of it)."""
    pos = _host(state.pos).astype(np.float64)
    ba = _host(state.beam_a).astype(np.int64)
    bb = _host(state.beam_b).astype(np.int64)
    balive = _host(state.beam_alive)
    w, h, cell_of = _search_layout(
        pos, _host(state.particle_alive), ba, bb, balive,
        dense_reach=dense_reach, slack=slack, lane_multiple=lane_multiple,
        width=width, chunk_multiple=chunk_multiple)

    # every beam, dead ones included, is classified (its state must
    # survive a round trip)
    is_exc, odx, ody, anchor = _classify(cell_of, ba, bb, h, dense_reach)
    m = ba.shape[0]
    beam_class = np.full(m, -1, np.int64)
    beam_cell = np.full(m, -1, np.int64)
    di = np.where(~is_exc)[0]
    r = dense_reach
    kid = (odx + r) * (2 * r + 1) + (ody + r)
    ukids, inv = (np.unique(kid[di], return_inverse=True)
                  if di.size else (np.zeros(0, np.int64),
                                   np.zeros(0, np.int64)))
    beam_class[di] = inv
    beam_cell[di] = anchor[di]
    ex = np.where(is_exc)[0]
    beam_cell[ex] = np.arange(len(ex))
    edge_offsets = tuple(
        (int(k) // (2 * r + 1) - r, int(k) % (2 * r + 1) - r) for k in ukids)
    spec = LatticeSpec(w, h, collision_stencil=collision_stencil,
                       edge_offsets=edge_offsets)
    aux = PlanifyAux(width=w, height=h, cell_of=cell_of.copy(),
                     beam_class=beam_class, beam_cell=beam_cell,
                     n_exceptions=len(ex))
    return embed(state, aux, exception_pad=exception_pad), spec, aux


def embed(state: SimState, aux: PlanifyAux, *,
          exception_pad: int = 32) -> PlanifiedState:
    """The planes and the exception list of ``state`` in the layout
    ``aux`` (on the state's device): empty cells are dead particles at the
    origin, empty edge slots dead edges with length 1 and yield / limit
    ∞; the list is padded to a multiple of ``exception_pad``."""
    dev = state.pos.device
    w, h, cell_of = aux.width, aux.height, aux.cell_of
    n_cls = int(aux.beam_class.max()) + 1 if aux.beam_class.size else 0

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def particle_plane(vals, fill=0.0, dtype=np.float32):
        out = np.full(w * h, fill, dtype)
        out[cell_of] = vals
        return out.reshape(w, h)

    def vec_planes(name):
        v = _host(getattr(state, name)).astype(np.float32)
        return on_dev(np.stack([particle_plane(v[:, 0]),
                                particle_plane(v[:, 1])], -1))

    beam = {k: _host(getattr(state, "beam_" + k)) for k in (
        "length", "target_length", "last_length", "spring", "damp",
        "yield_strain", "strain_limit", "strain", "stress", "alive")}
    fills = {"length": 1.0, "target_length": 1.0, "last_length": 1.0,
             "yield_strain": np.inf, "strain_limit": np.inf}

    edges = []
    for ci in range(n_cls):
        sel = aux.beam_class == ci
        cells = aux.beam_cell[sel]

        def cls_plane(k):
            dtype = bool if k == "alive" else np.float32
            out = np.full(w * h, fills.get(k, 0), dtype)
            out[cells] = beam[k][sel]
            return on_dev(out.reshape(w, h))

        edges.append(EdgeClass(**{k: cls_plane(k) for k in beam}))

    ex = np.where(aux.beam_class < 0)[0]
    ex = ex[np.argsort(aux.beam_cell[ex], kind="stable")]
    e_cap = max(_round_up(max(len(ex), 1), exception_pad), exception_pad)
    ba = _host(state.beam_a).astype(np.int64)
    bb = _host(state.beam_b).astype(np.int64)

    def ex_field(k):
        dtype = bool if k == "alive" else np.float32
        out = np.full(e_cap, fills.get(k, 0), dtype)
        out[:len(ex)] = beam[k][ex]
        return on_dev(out)

    def ex_cells(ends):
        out = np.zeros(e_cap, np.int64)
        out[:len(ex)] = cell_of[ends[ex]]
        return on_dev(out)

    x = ExceptionBeams(ia=ex_cells(ba), ib=ex_cells(bb),
                       **{k: ex_field(k) for k in beam})
    lat = LatticeState(
        pos=vec_planes("pos"), vel=vec_planes("vel"), acc=vec_planes("acc"),
        alive=on_dev(particle_plane(_host(state.particle_alive), False,
                                    bool)),
        pinned=on_dev(particle_plane(_host(state.particle_pinned), False,
                                     bool)),
        edges=tuple(edges))
    return PlanifiedState(lat=lat, x=x)


def _exception_pass(lat: LatticeState, x: ExceptionBeams,
                    cfg: StaticConfig):
    """Flat beam pass over the exception list (``forces.beam_terms``):
    the force planes for the dense accumulator (int32 at scale 65536
    when quantized, else float32) and the updated list, bit-exact
    against the JAX package's."""
    w, h = lat.shape
    flat_pos = lat.pos.reshape(-1, 2)
    fal = lat.alive.reshape(-1)
    pa, pb = flat_pos[x.ia], flat_pos[x.ib]
    active = x.alive & fal[x.ia] & fal[x.ib]
    t = beam_terms(
        pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1], active,
        target=x.target_length, last=x.last_length, length=x.length,
        spring=x.spring, damp=x.damp, yield_strain=x.yield_strain,
        strain_limit=x.strain_limit, strain=x.strain, stress=x.stress)
    x2 = dataclasses.replace(
        x, target_length=t.target, last_length=t.last, strain=t.strain,
        stress=t.stress, alive=x.alive & ~t.breaks)
    fv = torch.stack([torch.where(active, t.fx, 0.0),
                      torch.where(active, t.fy, 0.0)], -1)
    acc = endpoint_sums(w * h, x.ia, x.ib, fv,
                        cfg.force_mode == "quantized")
    return (acc[:, 0].reshape(w, h), acc[:, 1].reshape(w, h)), x2


def planified_substep(ps: PlanifiedState, consts: PhysicsConstants,
                      uin: UserInput, spec: LatticeSpec, cfg: StaticConfig,
                      update_observability: bool = True, far=None,
                      ffspec=None, far_delta=None,
                      scalars: Optional[Scalars] = None) -> PlanifiedState:
    """One substep: the exception pass merged into the dense substep's
    spring accumulator (``lattice_substep(extra_force=)``; ``scalars`` as
    it takes them)."""
    extra, x2 = _exception_pass(ps.lat, ps.x, cfg)
    lat2 = lattice_substep(
        ps.lat, consts, uin, spec, cfg,
        update_observability=update_observability, far=far, ffspec=ffspec,
        extra_force=extra, far_delta=far_delta, scalars=scalars)
    return PlanifiedState(lat=lat2, x=x2)


def planified_frame(ps: PlanifiedState, consts: PhysicsConstants,
                    uin: UserInput, spec: LatticeSpec, cfg: StaticConfig,
                    n_sub: Optional[int] = None) -> PlanifiedState:
    """One frame: ``n − 1`` substeps, then one that writes the edges'
    strain / stress (``n = cfg.subticks`` unless ``n_sub``)."""
    n = cfg.subticks if n_sub is None else n_sub
    sc = frame_scalars(consts, uin, cfg, spec.height, ps.lat.pos.device)
    for _ in range(n - 1):
        ps = planified_substep(ps, consts, uin, spec, cfg,
                               update_observability=False, scalars=sc)
    return planified_substep(ps, consts, uin, spec, cfg, scalars=sc)


def planified_frame_far(ps: PlanifiedState, consts: PhysicsConstants,
                        uin: UserInput, spec: LatticeSpec, cfg: StaticConfig,
                        ffspec, n_sub: Optional[int] = None,
                        buckets: Tuple[int, ...] = (1024, 4096)):
    """One frame with far-field self-collision, fixed cadence (the JAX
    ``planified_frame_far``): blocks of ``R = min(horizon, n)`` substeps
    and a remainder block, each starting with a rebuild whose list is
    sorted by activation substep
    (``farfield.rebuild_far_list_planes_active``: K2 on the card).  Each
    substep applies the sorted list's active prefix (``crop_active`` with
    the block's device count ``n_active[j]``) through the v4 bucketed
    apply on the embedded plane itself (``w, h`` of ``spec``: its lane
    dim is a multiple of ``chunk · tile_chunks``; on the card K8 with the
    block's destination order, built at its first apply; on the CPU
    buckets ≤ 256 narrow, larger ones through the record table), then
    runs :func:`planified_substep`; the frame's last substep observes.

    Every decision is made on the device, as JAX makes it: the bucket is
    ``farfield4.bucketed_far_delta_from_fn(n_pairs=None)``'s switch (one
    counted host read a substep eagerly on the card, an IF node per rung
    captured), zero delta planes for an empty prefix (which add nothing:
    the collision sums they join start from +0.0 and are never −0.0).
    Device marks as ``fused_frame4``'s (``rebuild``, ``far_apply``,
    ``substep``: :func:`planified_substep`, ``end``).  Returns ``(ps', stats)``, ``stats`` an int32 ``[4]`` on the device:
    rebuilds, max n_pairs, max overflow, max active pairs."""
    ff = ffspec
    n = cfg.subticks if n_sub is None else n_sub
    R = min(ff.horizon, n)
    blocks = [R] * (n // R) + ([n % R] if n % R else [])
    kw = dict(s=spec.collision_stencil, ff=ff, radius=cfg.particle_radius)
    dev = ps.lat.pos.device
    sc = frame_scalars(consts, uin, cfg, spec.height, dev)
    # the apply runs on the width padded to whole tiles, as the rebuild's
    # chunk grid is: the list's empty slots name that grid's last chunk,
    # past the plane's own width when it is not a multiple of the tile
    # (JAX's gather clamps such rows, and the masked slots add nothing;
    # torch's indexing raises)
    wp = _chunk_dims(spec.width, spec.height, ff)[2]
    st = torch.zeros(4, dtype=torch.int32, device=dev)
    for bi, size in enumerate(blocks):
        lat = ps.lat
        device_mark("rebuild", lat.pos)
        fl, n_act = rebuild_far_list_planes_active(
            lat.pos[..., 0], lat.pos[..., 1], lat.alive, vx=lat.vel[..., 0],
            vy=lat.vel[..., 1], dt=cfg.dt, R=R, **kw)
        st = torch.stack([st[0] + 1, torch.maximum(st[1], fl.n_pairs),
                          torch.maximum(st[2], fl.overflow),
                          torch.maximum(st[3], n_act[size - 1])])
        order = BlockOrder(fl)
        for j in range(size):
            lat = ps.lat
            device_mark("far_apply", lat.pos)

            def planes5(lat=lat):
                return torch.stack([
                    lat.pos[..., 0], lat.pos[..., 1], lat.vel[..., 0],
                    lat.vel[..., 1], lat.alive.to(torch.float32)])

            delta = bucketed_far_delta_from_fn(
                planes5, crop_active(fl, n_act[j]), None, dt=cfg.dt,
                ecoeff=sc.ecoeff, friction=sc.friction, w=wp,
                h=spec.height, buckets=buckets, order=order,
                out=lat.pos.new_empty((5, spec.width, spec.height)), **kw)
            observing = bi == len(blocks) - 1 and j == size - 1
            device_mark("substep", lat.pos)
            ps = planified_substep(ps, consts, uin, spec, cfg,
                                   update_observability=observing,
                                   far_delta=delta, ffspec=ff, scalars=sc)
    device_mark("end", ps.lat.pos)
    return ps, st


# the compiled counterparts of the JAX package's jitted frames
# (``softbody_tpu/ops/planify.py:457-479``, donating ``ps``; ``ops/
# compiled.py``): one CUDA graph a frame on the card, the bucket of each
# far apply an IF node; the functions on the CPU
planified_frame_jit = Compiled(
    planified_frame, static_argnames=("spec", "cfg", "n_sub"),
    decide=frame_decisions)
planified_frame_far_jit = Compiled(
    planified_frame_far,
    static_argnames=("spec", "cfg", "ffspec", "n_sub", "buckets"),
    decide=frame_decisions)


def unplanify(ps: PlanifiedState, template: SimState,
              aux: PlanifyAux) -> SimState:
    """Plane-embedded state → flat :class:`SimState` on the template's
    device (host-side extraction, ≙ BufferMapper.loadState,
    engineMapping.ts:521): particle fields from ``cell_of``, beam state
    from each beam's class plane or exception slot."""
    cell = aux.cell_of

    def particles(t, width=None):
        a = _host(t)
        return a.reshape(-1, width)[cell] if width else a.reshape(-1)[cell]

    beam = {k: _host(getattr(template, "beam_" + k)).copy()
            for k in ("target_length", "last_length", "strain", "stress",
                      "alive")}
    for ci, e in enumerate(ps.lat.edges):
        sel = aux.beam_class == ci
        cells = aux.beam_cell[sel]
        for k, dst in beam.items():
            dst[sel] = _host(getattr(e, k)).reshape(-1)[cells]
    xsel = (aux.beam_class < 0) & (aux.beam_cell >= 0)
    slots = aux.beam_cell[xsel]
    for k, dst in beam.items():
        dst[xsel] = _host(getattr(ps.x, k))[slots]

    dev = template.pos.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dataclasses.replace(
        template,
        pos=on_dev(particles(ps.lat.pos, 2)),
        vel=on_dev(particles(ps.lat.vel, 2)),
        acc=on_dev(particles(ps.lat.acc, 2)),
        particle_alive=on_dev(particles(ps.lat.alive)),
        particle_pinned=on_dev(particles(ps.lat.pinned)),
        **{"beam_" + k: on_dev(v) for k, v in beam.items()},
    )
