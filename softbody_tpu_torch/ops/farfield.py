"""Far-field self-collision for the dense lattice path: the port of
``softbody_tpu/ops/farfield.py`` (rebuild and apply math).

The stencil applies the pair math only between index neighbours within
Chebyshev radius ``s``; folds and torn pieces bring index-distant
regions into contact.  Index space is cut into ``chunk × chunk`` chunks
and ``tile_chunks × tile_chunks`` tiles; every pair with index distance
> s falls in exactly one of three candidate sources by chunk distance:

1. **band** (same or adjacent chunk): a particle-level test over the
   offset band (index Chebyshev in [s+1, 2·chunk−1]), kernel K2;
2. **annulus** (chunk Chebyshev in [2, 2·tile_chunks−1]): swept chunk
   AABBs that overlap;
3. **far** (chunk Chebyshev ≥ 2·tile_chunks): tile AABBs tested all
   pairs, overlapping tile pairs refined chunk against chunk.

Candidates are compacted into a fixed-capacity :class:`FarList`
(ascending, first ``max_pairs``; the rest counted in ``overflow``).
Each substep then applies the exact reference pair math
(compute.wgsl:150-168) over every candidate pair's 16×16 cross product,
masked to index distance > s and alive endpoints, antisymmetrically.

The rebuild runs on the unpadded ``[W, H]`` planes, so chunk ids
``cx·cwy + cy`` use this grid's ``cwy`` (:func:`_chunk_dims`); the apply
decodes with the same ``cwy``.  Everything but the band pass is plain
torch and stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .cuda.band_detect import band_flag_call, band_flags_plain
from .stencil import (
    _mul32,
    device_constant,
    device_scalar,
    f32_to_i32,
    index_sum,
    shifted,
    sqrt32,
)

_BIG = 3.0e38


def _nz(flags: torch.Tensor, size: int) -> torch.Tensor:
    """First ``size`` indices of true elements (ascending, flattened),
    int64; slots past the true count hold ``n − 1`` (the JAX ``_nz``
    contract: callers mask them by counts).  A cumsum compaction, with
    no host synchronisation."""
    flat = flags.reshape(-1)
    n = flat.numel()
    pos = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (pos < size), pos, size)
    out = torch.full((size + 1,), n - 1, dtype=torch.int64,
                     device=flat.device)
    out.scatter_(0, slot, torch.arange(n, device=flat.device))
    return out[:size]


def _shifted_stack(plane: torch.Tensor, offsets: Sequence[Tuple[int, int]],
                   fill) -> torch.Tensor:
    """``[n_off, W, H]``: ``out[o] = shifted(plane, *offsets[o], fill)``,
    as one gather from a padded copy."""
    w, h = plane.shape
    host = np.asarray(offsets, np.int64).reshape(-1, 2)
    offs = device_constant(host, plane.device)
    p = int(np.abs(host).max()) if len(host) else 0
    padded = torch.full((w + 2 * p, h + 2 * p), fill, dtype=plane.dtype,
                        device=plane.device)
    padded[p : p + w, p : p + h] = plane
    xi = torch.arange(w, device=plane.device)[None, :, None] + p
    yi = torch.arange(h, device=plane.device)[None, None, :] + p
    return padded[xi + offs[:, 0, None, None], yi + offs[:, 1, None, None]]


class ChunkPlanes(NamedTuple):
    """Chunk-level detection state ``[cwx, cwy]`` (swept, inflated
    AABBs; any-alive and band-hit flags) and the alive COM ``[2]``."""

    iminx: torch.Tensor
    imaxx: torch.Tensor
    iminy: torch.Tensor
    imaxy: torch.Tensor
    cany: torch.Tensor
    cband: torch.Tensor
    com: torch.Tensor


class RawChunkPlanes(NamedTuple):
    """Pre-extrusion chunk planes ``[cwx, cwy]``: alive-masked position
    and velocity AABBs (±BIG for empty chunks) and the band hit flag."""

    minx: torch.Tensor
    maxx: torch.Tensor
    miny: torch.Tensor
    maxy: torch.Tensor
    vminx: torch.Tensor
    vmaxx: torch.Tensor
    vminy: torch.Tensor
    vmaxy: torch.Tensor
    band: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FarFieldSpec:
    """Static far-field configuration (the JAX ``FarFieldSpec``).

    ``skin``: detection margin in world units.  ``horizon``: the rebuild
    cadence in substeps (chunk AABBs are swept along their velocity span
    for that long).  ``max_pairs``/``max_tile_pairs``/``max_hit_chunks``:
    static capacities; what they drop is counted in ``overflow``."""

    chunk: int = 4
    tile_chunks: int = 4
    max_pairs: int = 512
    max_tile_pairs: int = 256
    skin: float = 2.0
    horizon: int = 16
    speed_safety: float = 2.0
    max_hit_chunks: int = 4096

    @property
    def tile(self) -> int:
        return self.chunk * self.tile_chunks

    def band_half_offsets(self, s: int) -> Tuple[Tuple[int, int], ...]:
        """Particle-offset half-plane band: chebyshev in [s+1, 2*chunk-1]."""
        r = 2 * self.chunk - 1
        return tuple(
            (dx, dy)
            for dx in range(0, r + 1)
            for dy in range(-r, r + 1)
            if (dx > 0 or dy > 0) and max(abs(dx), abs(dy)) > s
        )

    def annulus_half_offsets(self) -> Tuple[Tuple[int, int], ...]:
        """Chunk-offset half-plane annulus: chebyshev in [2, 2*tc-1]."""
        r = 2 * self.tile_chunks - 1
        return tuple(
            (dx, dy)
            for dx in range(0, r + 1)
            for dy in range(-r, r + 1)
            if max(abs(dx), abs(dy)) >= 2 and (dx > 0 or dy > 0)
        )


@dataclasses.dataclass
class FarList:
    """Candidate chunk-pair list (fixed capacity, valid prefix first)."""

    ca: torch.Tensor        # [K] int64 chunk id cx * cwy + cy
    cb: torch.Tensor        # [K] int64; ca <= cb
    valid: torch.Tensor     # [K] bool
    n_pairs: torch.Tensor   # [] int32
    overflow: torch.Tensor  # [] int32: candidates dropped at any capacity
    px_ref: torch.Tensor    # [W, H] positions / velocities at rebuild
    py_ref: torch.Tensor
    com_ref: torch.Tensor   # [2] alive-mean position at rebuild
    vx_ref: torch.Tensor
    vy_ref: torch.Tensor
    # [] int32 substeps since the rebuild, on the list's device (a host
    # int given here is put there): the triggered frames decide their
    # rebuilds on the device
    age: Optional[torch.Tensor] = None

    def __post_init__(self):
        if not isinstance(self.age, torch.Tensor):
            self.age = torch.full((), 0 if self.age is None else self.age,
                                  dtype=torch.int32,
                                  device=self.n_pairs.device)

    @property
    def capacity(self) -> int:
        return self.ca.shape[0]

    def counts(self) -> Tuple[int, int]:
        """``(n_pairs, overflow)`` on the host, in one read."""
        n, o = torch.stack([self.n_pairs, self.overflow]).tolist()
        return int(n), int(o)


def _chunk_dims(w: int, h: int, ff: FarFieldSpec) -> Tuple[int, int, int, int]:
    """(cwx, cwy, wp, hp): chunk-grid dims (padded to whole tiles) and
    the padded particle dims."""
    c = ff.chunk
    cwx = -(-w // c)
    cwy = -(-h // c)
    cwx = -(-cwx // ff.tile_chunks) * ff.tile_chunks
    cwy = -(-cwy // ff.tile_chunks) * ff.tile_chunks
    return cwx, cwy, cwx * c, cwy * c


def _pad_plane(x: torch.Tensor, wp: int, hp: int, fill) -> torch.Tensor:
    w, h = x.shape
    out = torch.full((wp, hp), fill, dtype=x.dtype, device=x.device)
    out[:w, :h] = x
    return out


def chunk_view(x: torch.Tensor, ff: FarFieldSpec) -> torch.Tensor:
    """Padded ``[Wp, Hp]`` plane → chunk-major ``[Cn, chunk·chunk]``."""
    c = ff.chunk
    wp, hp = x.shape
    return (x.reshape(wp // c, c, hp // c, c).permute(0, 2, 1, 3)
            .reshape((wp // c) * (hp // c), c * c))


def unchunk_view(x: torch.Tensor, wp: int, hp: int,
                 ff: FarFieldSpec) -> torch.Tensor:
    """Chunk-major ``[Cn, chunk·chunk]`` → padded ``[Wp, Hp]`` plane."""
    c = ff.chunk
    return (x.reshape(wp // c, hp // c, c, c).permute(0, 2, 1, 3)
            .reshape(wp, hp))


def _chunk_reduce(plane, op, c):
    wp, hp = plane.shape
    return op(plane.reshape(wp // c, c, hp // c, c), dim=(1, 3))


# ---------------------------------------------------------------------------
# rebuild


BAND_IMPLS = ("kernel", "plain")


def raw_chunk_planes(pxu, pyu, alive, *, s: int, ff: FarFieldSpec,
                     radius: float, vxu=None, vyu=None, T_band: float = 0.0,
                     vbar=None, band_impl: str = "kernel"):
    """Particle planes → ``(RawChunkPlanes, cany, com)``.

    Band reach per pair is ``(2r + skin + dev_i) + dev_j`` with
    ``dev = |v − v̄|·T_band`` (zero without velocities); the band pass is
    kernel K2 (``band_flag_call``: its plain version on CPU tensors), or
    under ``band_impl="plain"`` the plain loop on every device (the JAX
    package's ``band_impl="xla"``, a measurement option)."""
    if band_impl not in BAND_IMPLS:
        raise ValueError(f"band_impl {band_impl!r}: one of {BAND_IMPLS}")
    w, h = pxu.shape
    cwx, cwy, wp, hp = _chunk_dims(w, h, ff)
    c = ff.chunk
    alv = _pad_plane(alive, wp, hp, False)

    def creduce(plane, op, fill):
        v = torch.where(alv, _pad_plane(plane, wp, hp, 0.0), fill)
        return _chunk_reduce(v, op, c)

    cminx = creduce(pxu, torch.amin, _BIG)
    cmaxx = creduce(pxu, torch.amax, -_BIG)
    cminy = creduce(pyu, torch.amin, _BIG)
    cmaxy = creduce(pyu, torch.amax, -_BIG)
    cany = _chunk_reduce(alv, torch.any, c)
    if vxu is not None:
        vminx = creduce(vxu, torch.amin, _BIG)
        vmaxx = creduce(vxu, torch.amax, -_BIG)
        vminy = creduce(vyu, torch.amin, _BIG)
        vmaxy = creduce(vyu, torch.amax, -_BIG)
        vbx, vby = vbar
        ddx = vxu - vbx
        ddy = vyu - vby
        dev = sqrt32(ddx * ddx + ddy * ddy) * float(np.float32(T_band))
        dev = torch.where(alive, dev, 0.0)
    else:
        vminx = vmaxx = vminy = vmaxy = torch.zeros(
            (cwx, cwy), dtype=torch.float32, device=pxu.device)
        dev = torch.zeros_like(pxu)
    base_reach = float(np.float32(2.0 * radius + ff.skin))
    band_args = (pxu.contiguous(), pyu.contiguous(), dev, base_reach + dev,
                 alive.contiguous())
    flag = (band_flag_call(*band_args, offsets=ff.band_half_offsets(s))
            if band_impl == "kernel" else
            band_flags_plain(*band_args, ff.band_half_offsets(s)))
    cflag = _chunk_reduce(_pad_plane(flag, wp, hp, False), torch.any, c)

    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    com = torch.stack([
        torch.where(alive, pxu, 0.0).sum() / n_alive,
        torch.where(alive, pyu, 0.0).sum() / n_alive,
    ])
    raw = RawChunkPlanes(cminx, cmaxx, cminy, cmaxy,
                         vminx, vmaxx, vminy, vmaxy, cflag)
    return raw, cany, com


def extrude_chunk_planes(raw: RawChunkPlanes, cany, *, ff: FarFieldSpec,
                         radius: float, T: float, extruded: bool):
    """Sweep each chunk's AABB along its own velocity span for ``T`` (a
    host float, or a 0-d float32 tensor on the planes' device) and
    inflate by ``r + skin/2`` → ``(iminx, imaxx, iminy, imaxy)``."""
    m0 = float(np.float32(radius + 0.5 * ff.skin))
    if not extruded:
        return (raw.minx - m0, raw.maxx + m0, raw.miny - m0, raw.maxy + m0)
    tf = T if isinstance(T, torch.Tensor) else float(np.float32(T))
    # empty chunks reduce to ±BIG; zero them so ±BIG·T stays finite
    vminx = torch.where(cany, raw.vminx, 0.0)
    vmaxx = torch.where(cany, raw.vmaxx, 0.0)
    vminy = torch.where(cany, raw.vminy, 0.0)
    vmaxy = torch.where(cany, raw.vmaxy, 0.0)
    return (
        raw.minx + torch.clamp(vminx * tf, max=0.0) - m0,
        raw.maxx + torch.clamp(vmaxx * tf, min=0.0) + m0,
        raw.miny + torch.clamp(vminy * tf, max=0.0) - m0,
        raw.maxy + torch.clamp(vmaxy * tf, min=0.0) + m0,
    )


def _chunk_detection(pxu, pyu, alive, *, s: int, ff: FarFieldSpec,
                     radius: float, vxu=None, vyu=None, dt: float = 0.0,
                     return_raw: bool = False, band_impl: str = "kernel"):
    """Particle planes → :class:`ChunkPlanes` (with ``return_raw``, also
    the :class:`RawChunkPlanes` they were swept from); with velocities
    the AABBs are swept for ``horizon`` substeps."""
    if vxu is not None:
        n_alive_v = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
        vbar = (torch.where(alive, vxu, 0.0).sum() / n_alive_v,
                torch.where(alive, vyu, 0.0).sum() / n_alive_v)
        T = float(ff.horizon * dt)
    else:
        vbar = None
        T = 0.0
    raw, cany, com = raw_chunk_planes(
        pxu, pyu, alive, s=s, ff=ff, radius=radius, vxu=vxu, vyu=vyu,
        T_band=T, vbar=vbar, band_impl=band_impl)
    iminx, imaxx, iminy, imaxy = extrude_chunk_planes(
        raw, cany, ff=ff, radius=radius, T=T, extruded=vxu is not None)
    cp = ChunkPlanes(iminx, imaxx, iminy, imaxy, cany, raw.band, com)
    return (cp, raw) if return_raw else cp


def _candidates_from_chunks(cp: ChunkPlanes, *, ff: FarFieldSpec):
    """Chunk-level candidate masks + tile-refinement tables (everything
    before compaction), on ``[cwx, cwy]`` chunk planes."""
    iminx, imaxx, iminy, imaxy = cp.iminx, cp.imaxx, cp.iminy, cp.imaxy
    cany, cflag = cp.cany, cp.cband
    cwx, cwy = cany.shape
    tc = ff.tile_chunks
    dev = cany.device

    # ---- source 1: band pairs (base, base+o) for the half-plane
    # neighbour set, when EITHER endpoint chunk is flagged
    adj_offsets = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))
    band_stack = torch.stack([
        (cflag | shifted(cflag, dx, dy, False)) & cany
        & shifted(cany, dx, dy, False)
        for dx, dy in adj_offsets
    ])  # [5, cwx, cwy]

    # ---- source 2: chunk annulus (chebyshev in [2, 2*tc-1]) -------------
    ann_offsets = ff.annulus_half_offsets()
    hit = (
        cany & _shifted_stack(cany, ann_offsets, False)
        & (iminx <= _shifted_stack(imaxx, ann_offsets, -_BIG))
        & (_shifted_stack(iminx, ann_offsets, _BIG) <= imaxx)
        & (iminy <= _shifted_stack(imaxy, ann_offsets, -_BIG))
        & (_shifted_stack(iminy, ann_offsets, _BIG) <= imaxy)
    )  # [n_off, cwx, cwy]
    ann_any = hit.any(dim=0)
    ann_count = hit.sum(dim=0, dtype=torch.int32)
    # per-chunk offset bitmask: word w bit b ⟺ offset 32w+b hit (int64
    # words: torch's uint32 shifts are partial)
    n_words = -(-len(ann_offsets) // 32)
    bitv = torch.arange(32, device=dev, dtype=torch.int64)
    ann_words = torch.stack([
        (hit[32 * i : 32 * i + 32].to(torch.int64)
         << bitv[: min(32, len(ann_offsets) - 32 * i), None, None]).sum(0)
        for i in range(n_words)
    ])  # [n_words, cwx, cwy]

    # ---- source 3: far tile pairs + chunk refinement ---------------------
    tx, ty = cwx // tc, cwy // tc
    tn = tx * ty

    def treduce(plane, op):
        return op(plane.reshape(tx, tc, ty, tc), dim=(1, 3)).reshape(tn)

    tminx = treduce(iminx, torch.amin)
    tmaxx = treduce(imaxx, torch.amax)
    tminy = treduce(iminy, torch.amin)
    tmaxy = treduce(imaxy, torch.amax)
    tany = treduce(cany, torch.any)
    lin_t = torch.arange(tn, device=dev)
    tix, tiy = lin_t // ty, lin_t % ty

    ov = (
        (tminx[:, None] <= tmaxx[None, :])
        & (tminx[None, :] <= tmaxx[:, None])
        & (tminy[:, None] <= tmaxy[None, :])
        & (tminy[None, :] <= tmaxy[:, None])
        & tany[:, None] & tany[None, :]
    )
    tcheb = torch.maximum((tix[:, None] - tix[None, :]).abs(),
                          (tiy[:, None] - tiy[None, :]).abs())
    far_tile = ov & (tcheb >= 2) & (lin_t[:, None] < lin_t[None, :])

    k1 = ff.max_tile_pairs
    # two-stage compaction: rows with any pair first, then their pairs
    row_any = far_tile.any(dim=1)
    n_rows = row_any.sum()
    r_idx = _nz(row_any, k1)
    row_ok = torch.arange(k1, device=dev) < torch.clamp(n_rows, max=k1)
    strip = far_tile[r_idx] & row_ok[:, None]  # [k1, tn]
    total_tiles = far_tile.sum()
    taken = torch.clamp(strip.sum(), max=k1)
    e3 = _nz(strip, k1)
    ti_a = r_idx[e3 // tn]
    ti_b = e3 % tn
    tile_valid = torch.arange(k1, device=dev) < taken
    tile_overflow = total_tiles - taken

    lin_ids = (torch.arange(cwx, device=dev)[:, None] * cwy
               + torch.arange(cwy, device=dev)[None, :])

    def tile_major(plane):
        return (plane.reshape(tx, tc, ty, tc).permute(0, 2, 1, 3)
                .reshape(tn, tc * tc))

    def rows(plane):
        t = tile_major(plane)
        return t[ti_a], t[ti_b]

    aminx, bminx = rows(iminx)
    amaxx, bmaxx = rows(imaxx)
    aminy, bminy = rows(iminy)
    amaxy, bmaxy = rows(imaxy)
    aany, bany = rows(cany)
    ca_ids, cb_ids = rows(lin_ids)  # [k1, tc*tc]
    acx, bcx = ca_ids // cwy, cb_ids // cwy
    acy, bcy = ca_ids % cwy, cb_ids % cwy

    ref_ov = (
        (aminx[:, :, None] <= bmaxx[:, None, :])
        & (bminx[:, None, :] <= amaxx[:, :, None])
        & (aminy[:, :, None] <= bmaxy[:, None, :])
        & (bminy[:, None, :] <= amaxy[:, :, None])
        & aany[:, :, None] & bany[:, None, :]
        & tile_valid[:, None, None]
    )
    ccheb = torch.maximum((acx[:, :, None] - bcx[:, None, :]).abs(),
                          (acy[:, :, None] - bcy[:, None, :]).abs())
    ref_ov = ref_ov & (ccheb >= 2 * tc)

    return (band_stack, ann_any, ann_count, ann_words, ref_ov, ca_ids,
            cb_ids, tile_overflow, adj_offsets, ann_offsets, cwy)


def rebuild_far_list_from_chunks(cp: ChunkPlanes, px_ref, py_ref, vx_ref,
                                 vy_ref, *, ff: FarFieldSpec) -> FarList:
    """Candidate-list build from :class:`ChunkPlanes`: compaction of the
    three sources into ``ff.max_pairs`` slots (band + annulus through
    one hit-chunk strip, far pairs through a second)."""
    (band_stack, ann_any, ann_count, ann_words, ref_ov, ca_ids, cb_ids,
     tile_overflow, adj_offsets, ann_offsets, cwy) = \
        _candidates_from_chunks(cp, ff=ff)
    dev = ann_any.device
    k2 = ff.max_pairs
    mc = min(ff.max_hit_chunks, k2)

    def arange(n):
        return torch.arange(n, device=dev)

    def strip_extract(rows, h_idx, offs, total):
        """rows [m, n_off] bool → (ca, cb, valid, n, overflow); entry
        (r, o) is the pair (h_idx[r], h_idx[r] + offset o)."""
        n_off = rows.shape[1]
        kk = min(k2, rows.numel())
        e_flat = _nz(rows, kk)
        e_r = e_flat // n_off
        e_o = e_flat % n_off
        n = torch.clamp(rows.sum(), max=kk)
        hx = h_idx[e_r] // cwy
        hy = h_idx[e_r] % cwy
        ca = hx * cwy + hy
        cb = (hx + offs[e_o, 0]) * cwy + (hy + offs[e_o, 1])
        return ca, cb, arange(kk) < n, n, total - n

    # band + annulus share one hit-chunk compaction
    n_off_a = len(ann_offsets)
    hit_any = band_stack.any(dim=0) | ann_any
    h_idx = _nz(hit_any, mc)
    h_ok = arange(mc) < torch.clamp(hit_any.sum(), max=mc)
    b_rows = band_stack.reshape(band_stack.shape[0], -1)[:, h_idx].T
    words = ann_words.reshape(ann_words.shape[0], -1)[:, h_idx].T
    bits = ((words[:, :, None] >> torch.arange(32, device=dev)) & 1)
    bits = bits.reshape(mc, -1)[:, :n_off_a] > 0
    ba_rows = torch.cat([b_rows, bits], dim=1) & h_ok[:, None]
    ba_offs = device_constant(
        np.asarray(adj_offsets + ann_offsets, np.int64), dev)
    ban_ca, ban_cb, _ban_valid, ba_n, ba_over = strip_extract(
        ba_rows, h_idx, ba_offs,
        band_stack.sum() + ann_count.sum())

    # far: entry (pair, i, j) → (ca_ids[pair, i], cb_ids[pair, j])
    k1, tcc = ref_ov.shape[0], ref_ov.shape[1]
    any_j = ref_ov.any(dim=2)  # [k1, tc*tc]
    mcf = min(mc, k1 * tcc)
    ri_flat = _nz(any_j, mcf)
    r_p = ri_flat // tcc
    r_i = ri_flat % tcc
    row_ok = arange(mcf) < torch.clamp(any_j.sum(), max=mcf)
    jrows = ref_ov[r_p, r_i, :] & row_ok[:, None]  # [mcf, tc*tc]
    kkf = min(k2, mcf * tcc)
    ej_flat = _nz(jrows, kkf)
    e_r2 = ej_flat // tcc
    f_j = ej_flat % tcc
    f_n = torch.clamp(jrows.sum(), max=kkf)
    far_ca = ca_ids[r_p[e_r2], r_i[e_r2]]
    far_cb = cb_ids[r_p[e_r2], f_j]
    f_over = ref_ov.sum() - f_n

    # pack: band+annulus's strip at 0, far's live prefix right after
    # band+annulus's live prefix (overwriting its dead tail)
    kb, kf = ban_ca.shape[0], far_ca.shape[0]

    def pack(a_src, b_src):
        out = torch.zeros(kb + kf, dtype=a_src.dtype, device=dev)
        out[:kb] = a_src
        return out.scatter(0, ba_n + arange(kf), b_src)

    ca = pack(ban_ca, far_ca)
    cb = pack(ban_cb, far_cb)
    lo = torch.minimum(ca, cb)[:k2]
    hi = torch.maximum(ca, cb)[:k2]
    total = ba_n + f_n
    n_pairs = torch.clamp(total, max=k2)
    short = k2 - lo.shape[0]
    if short > 0:
        lo = torch.cat([lo, lo.new_zeros(short)])
        hi = torch.cat([hi, hi.new_zeros(short)])
    overflow = (ba_over + f_over + torch.clamp(total - k2, min=0)
                + tile_overflow)
    return FarList(
        ca=lo, cb=hi, valid=arange(k2) < n_pairs,
        n_pairs=n_pairs.to(torch.int32), overflow=overflow.to(torch.int32),
        px_ref=px_ref, py_ref=py_ref, com_ref=cp.com,
        vx_ref=vx_ref, vy_ref=vy_ref,
    )


def rebuild_far_list_planes(px, py, alive, *, s: int, ff: FarFieldSpec,
                            radius: float, vx=None, vy=None,
                            dt: float = 0.0,
                            band_impl: str = "kernel") -> FarList:
    """Build the candidate chunk-pair list from current positions (and,
    with ``vx``/``vy``/``dt``, velocity-swept)."""
    cp = _chunk_detection(px, py, alive, s=s, ff=ff, radius=radius,
                          vxu=vx, vyu=vy, dt=dt, band_impl=band_impl)
    return rebuild_far_list_from_chunks(
        cp, px, py,
        torch.zeros_like(px) if vx is None else vx,
        torch.zeros_like(py) if vy is None else vy,
        ff=ff)


def pair_activation(fl: FarList, raw: RawChunkPlanes, *, ff: FarFieldSpec,
                    radius: float, dt: float, R: int):
    """Per-pair activation schedule for one cadence block of ``R``
    substeps (the JAX ``pair_activation``).

    For each listed chunk pair, a lower bound ``s0`` on the first
    substep at which any of its particles can touch: per axis, the raw
    AABB gap above ``2r + skin`` closes at most at the difference of the
    chunks' velocity extremes per substep, and contact needs both axes,
    so ``s0 = ceil(min(max(tx, ty), R))``.  The list is reordered by
    ``s0`` (stable; invalid entries last) and ``n_active[s]`` counts the
    valid entries with ``s0 ≤ s``: the apply at substep ``s`` crops to
    that prefix.  A pair gated off contributes zero to the pair math
    (impulses act only below ``2r``), so the schedule changes the far
    apply's f32 summation order and nothing else.

    The float32 expressions are the JAX package's, the division between
    two tensors (see ``stencil.device_scalar``), so ``s0`` and the
    order are bit-exact against it.  Returns ``(fl_sorted, n_active)``,
    ``n_active`` int32 ``[R]`` on the list's device."""
    tab = torch.stack([raw.minx, raw.maxx, raw.miny, raw.maxy,
                       raw.vminx, raw.vmaxx, raw.vminy, raw.vmaxy],
                      dim=-1).reshape(-1, 8)
    a = tab[fl.ca]
    b = tab[fl.cb]
    dev = tab.device
    thr = float(np.float32(2.0 * radius + ff.skin))
    dtf = float(np.float32(dt))
    tiny = device_scalar(1e-30, dev)

    def t_dir(gap, rate):
        t = (gap - thr) / torch.maximum(rate * dtf, tiny)
        return torch.where(gap > thr, t, 0.0)

    def axis_time(lo, hi, vlo, vhi):
        # first substep count at which the axis gap can reach ``thr``;
        # at most one direction has a positive gap
        g1 = b[:, lo] - a[:, hi]                       # b right of a
        r1 = torch.clamp(a[:, vhi] - b[:, vlo], min=0.0)
        g2 = a[:, lo] - b[:, hi]
        r2 = torch.clamp(b[:, vhi] - a[:, vlo], min=0.0)
        return torch.maximum(t_dir(g1, r1), t_dir(g2, r2))

    t = torch.maximum(axis_time(0, 1, 4, 5), axis_time(2, 3, 6, 7))
    s0 = f32_to_i32(torch.ceil(torch.clamp(t, max=float(R))))
    key = torch.where(fl.valid, s0, R + 1)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    valid_s = fl.valid[order]
    steps = torch.arange(R, dtype=key_s.dtype, device=dev)
    n_active = ((key_s[None, :] <= steps[:, None]) & valid_s[None, :]).sum(
        dim=1, dtype=torch.int32)
    fl_sorted = dataclasses.replace(fl, ca=fl.ca[order], cb=fl.cb[order],
                                    valid=valid_s)
    return fl_sorted, n_active


def rebuild_far_list_planes_active(px, py, alive, *, s: int,
                                   ff: FarFieldSpec, radius: float, vx, vy,
                                   dt: float, R: int,
                                   band_impl: str = "kernel"):
    """:func:`rebuild_far_list_planes` (velocity-swept) and
    :func:`pair_activation` over one chunk detection: ``(fl, n_active
    [R])`` with the list sorted by activation substep."""
    cp, raw = _chunk_detection(px, py, alive, s=s, ff=ff, radius=radius,
                               vxu=vx, vyu=vy, dt=dt, return_raw=True,
                               band_impl=band_impl)
    fl = rebuild_far_list_from_chunks(cp, px, py, vx, vy, ff=ff)
    return pair_activation(fl, raw, ff=ff, radius=radius, dt=dt, R=R)


def chunk_any_alive(alive, ff: FarFieldSpec) -> torch.Tensor:
    """Per-chunk any-alive plane ``[cwx, cwy]`` (fixed for a fused frame,
    whose particle alive mask does not change)."""
    w, h = alive.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, ff)
    return _chunk_reduce(_pad_plane(alive, wp, hp, False), torch.any,
                         ff.chunk)


def raw_planes_from_side(side, plane_w: int, plane_h: int,
                         interior_off: Tuple[int, int],
                         ff: FarFieldSpec) -> RawChunkPlanes:
    """The fused kernel's detection side planes → :class:`RawChunkPlanes`
    on the chunk grid of ``(plane_w, plane_h)``.

    ``side [9, wi/4, hi]`` holds per group of four rows (row ``j``: rows
    ``[4j, 4j+4)`` of the kernel's interior) and per column the min and
    max of px py vx vy and the band flag; this finishes the reduce over
    each four columns and places the result at the interior's chunk
    offset, the other chunks empty (±3e38, band false).  A partial last
    group of columns is filled as ``_pad_plane`` fills (the JAX
    package's interiors are whole chunks)."""
    c = ff.chunk
    cwx, cwy, _, _ = _chunk_dims(plane_w, plane_h, ff)
    ox, oy = interior_off
    if ox % c or oy % c:
        raise ValueError("interior offset must be chunk-aligned")
    rows, hi = side.shape[1:]
    hc = -(-hi // c)

    def lred(plane, op, fill):
        v = torch.full((rows, hc * c), fill, dtype=torch.float32,
                       device=side.device)
        v[:, :hi] = plane
        out = torch.full((cwx, cwy), fill, dtype=torch.float32,
                         device=side.device)
        out[ox // c:ox // c + rows, oy // c:oy // c + hc] = op(
            v.reshape(rows, hc, c), dim=2)
        return out

    return RawChunkPlanes(
        minx=lred(side[0], torch.amin, _BIG),
        maxx=lred(side[1], torch.amax, -_BIG),
        miny=lred(side[2], torch.amin, _BIG),
        maxy=lred(side[3], torch.amax, -_BIG),
        vminx=lred(side[4], torch.amin, _BIG),
        vmaxx=lred(side[5], torch.amax, -_BIG),
        vminy=lred(side[6], torch.amin, _BIG),
        vmaxy=lred(side[7], torch.amax, -_BIG),
        band=lred(side[8], torch.amax, 0.0) > 0.0,
    )


def kernel_side_from_planes(pxu, pyu, alive, vxu, vyu, *, s: int,
                            ff: FarFieldSpec, radius: float,
                            T_band: float, vbar,
                            interior_off: Tuple[int, int] = (0, 0),
                            interior_shape: Optional[Tuple[int, int]] = None,
                            band_impl: str = "kernel") -> torch.Tensor:
    """The fused kernel's detection side planes ``[9, ceil(wi/4), hi]``
    from :func:`raw_chunk_planes` (K2's band pass): what seeds the side
    carry before the kernel has detected.  Row ``j`` holds chunk row
    ``j``'s values, each column its chunk's value (the reduce over four
    columns that :func:`raw_planes_from_side` finishes is exact on
    repeats), so ``raw_planes_from_side(kernel_side_from_planes(...))``
    equals ``raw_chunk_planes(...)``.  ``interior_off``/``interior_shape``
    (default: the whole plane) as in the JAX package; the side planes'
    row group is four, so ``ff.chunk`` must be 4."""
    c = ff.chunk
    if c != 4:
        raise ValueError("the side planes group four rows: chunk must be 4")
    raw, _cany, _com = raw_chunk_planes(
        pxu, pyu, alive, s=s, ff=ff, radius=radius, vxu=vxu, vyu=vyu,
        T_band=T_band, vbar=vbar, band_impl=band_impl)
    ox, oy = interior_off
    wi, hi = pxu.shape if interior_shape is None else interior_shape
    if ox % c or oy % c:
        raise ValueError("interior offset must be chunk-aligned")

    def emb(plane):
        sl = plane[ox // c:ox // c + -(-wi // c), oy // c:oy // c + -(-hi // c)]
        return torch.repeat_interleave(sl.to(torch.float32), c, dim=1)[:, :hi]

    return torch.stack([emb(p) for p in raw])


def list_invalid(px, py, vx, vy, alive, fl: FarList, dt: float,
                 ff: FarFieldSpec) -> torch.Tensor:
    """True (a 0-d bool tensor on the planes' device) when the extruded
    list no longer covers the next substep: some alive particle's
    deviation from its linear reference motion ``p_ref + v_ref·τ`` (τ =
    ``fl.age·dt``) plus the margin ``speed_safety·|v − v_ref|·dt``
    exceeds skin/2, or the list has reached its extrusion horizon.  In
    float32 on the device, as the JAX package's."""
    tau = fl.age.to(torch.float32) * float(np.float32(dt))
    ddx = px - (fl.px_ref + fl.vx_ref * tau)
    ddy = py - (fl.py_ref + fl.vy_ref * tau)
    dev = sqrt32(ddx * ddx + ddy * ddy)
    dvx = vx - fl.vx_ref
    dvy = vy - fl.vy_ref
    margin = float(np.float32(ff.speed_safety * dt)) * sqrt32(
        dvx * dvx + dvy * dvy)
    slack = torch.where(alive, dev + margin, 0.0)
    return (slack.amax() > float(np.float32(0.5 * ff.skin))) | (
        fl.age >= ff.horizon)


def crop_active(fl: FarList, n_active) -> FarList:
    """The sorted list cut to its first ``n_active`` entries (a host int
    or a 0-d int32 tensor on the list's device, which becomes its
    ``n_pairs``, as in the JAX package): the pairs that can touch by the
    current substep."""
    keep = torch.arange(fl.capacity, device=fl.valid.device) < n_active
    n = (n_active.to(torch.int32) if isinstance(n_active, torch.Tensor)
         else torch.full_like(fl.n_pairs, n_active))
    return dataclasses.replace(fl, valid=fl.valid & keep, n_pairs=n)


def rebuild_far_list(pos, alive, *, s: int, ff: FarFieldSpec,
                     radius: float) -> FarList:
    """:func:`rebuild_far_list_planes` on an interleaved ``[W, H, 2]``
    position array, without velocities (as ``LatticeBackend`` calls
    it)."""
    return rebuild_far_list_planes(pos[..., 0], pos[..., 1], alive, s=s,
                                   ff=ff, radius=radius)


def far_candidate_count(pos, alive, *, s: int, ff: FarFieldSpec,
                        radius: float):
    """Detection only: ``(total candidate pairs, dropped tile pairs
    included, as a 0-d int64 tensor; alive COM [2])``.  Lets the backend
    skip the compaction on a frame with no fold."""
    cp = _chunk_detection(pos[..., 0], pos[..., 1], alive, s=s, ff=ff,
                          radius=radius)
    (band_stack, _ann_any, ann_count, _ann_words, ref_ov, _ca, _cb,
     tile_overflow, *_rest) = _candidates_from_chunks(cp, ff=ff)
    total = (band_stack.sum() + ann_count.sum(dtype=torch.int64)
             + ref_ov.sum() + tile_overflow)
    return total, cp.com


def _alive_mean(v, alive):
    """Mean of ``v [W, H, 2]`` over alive particles (``[2]``)."""
    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    return torch.where(alive[..., None], v, 0.0).sum(dim=(0, 1)) / n_alive


def displacement_check(pos, alive, fl: FarList):
    """Max COM-relative displacement since the rebuild (0-d tensor): the
    backend's rebuild trigger (the list holds while it stays ≤ skin/2)."""
    com = _alive_mean(pos, alive)
    ddx = (pos[..., 0] - fl.px_ref) - (com[0] - fl.com_ref[0])
    ddy = (pos[..., 1] - fl.py_ref) - (com[1] - fl.com_ref[1])
    d2 = torch.where(alive, ddx * ddx + ddy * ddy, 0.0)
    return sqrt32(d2.max())


def max_relative_speed(vel, alive):
    """Max speed relative to the alive mean velocity (0-d tensor)."""
    dv = vel - _alive_mean(vel, alive)
    v2 = torch.where(alive, dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1],
                     0.0)
    return sqrt32(v2.max())


def empty_far_list_at(pos, com, ff: FarFieldSpec) -> FarList:
    """An all-invalid list anchored at ``pos [W, H, 2]`` and ``com``:
    what a rebuild returns when detection found nothing."""
    k = ff.max_pairs
    z = torch.zeros(k, dtype=torch.int64, device=pos.device)
    i0 = torch.zeros((), dtype=torch.int32, device=pos.device)
    return FarList(
        ca=z, cb=z.clone(),
        valid=torch.zeros(k, dtype=torch.bool, device=pos.device),
        n_pairs=i0, overflow=i0.clone(),
        px_ref=pos[..., 0], py_ref=pos[..., 1], com_ref=com,
        vx_ref=torch.zeros_like(pos[..., 0]),
        vy_ref=torch.zeros_like(pos[..., 1]),
    )


def crop_far_list(fl: FarList, k: int) -> FarList:
    """The first ``k`` slots (valid entries are prefix-packed)."""
    return dataclasses.replace(fl, ca=fl.ca[:k], cb=fl.cb[:k],
                               valid=fl.valid[:k])


def empty_far_list(w: int, h: int, ff: FarFieldSpec,
                   device=None) -> FarList:
    """An all-invalid list anchored far outside the world, on ``device``
    (default: the CUDA device; ``config.resolve_device``)."""
    device = resolve_device(device)
    k = ff.max_pairs
    z = torch.zeros(k, dtype=torch.int64, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return FarList(
        ca=z, cb=z.clone(), valid=torch.zeros(k, dtype=torch.bool,
                                              device=device),
        n_pairs=i0, overflow=i0.clone(),
        px_ref=torch.full((w, h), -1.0e9, device=device),
        py_ref=torch.full((w, h), -1.0e9, device=device),
        com_ref=torch.zeros(2, device=device),
        vx_ref=torch.zeros((w, h), device=device),
        vy_ref=torch.zeros((w, h), device=device),
    )


# ---------------------------------------------------------------------------
# per-substep pair processing


def far_gather_windows(stack, cx_ids, cy_ids, *, c: int, w: int, h: int):
    """``stack [5, W, H]`` (px py vx vy alive) → ``g [n, 5·c²]`` windows
    of the given chunks.  A window reaching past the plane reads its
    last row/column (clamped) with alive zeroed, so the phantoms mask
    out of every pair."""
    cc = c * c
    n = cx_ids.shape[0]
    ii = torch.arange(c, device=stack.device)
    xi = (cx_ids[:, None] * c + ii[None, :])[:, :, None]  # [n, c, 1]
    yj = (cy_ids[:, None] * c + ii[None, :])[:, None, :]  # [n, 1, c]
    gw = stack[:, xi.clamp(max=w - 1), yj.clamp(max=h - 1)]  # [5, n, c, c]
    g = gw.permute(1, 0, 2, 3).reshape(n, 5 * cc)
    in_bounds = ((xi < w) & (yj < h)).reshape(n, cc)
    al = g[:, 4 * cc :] * in_bounds.to(torch.float32)
    return torch.cat([g[:, : 4 * cc], al], dim=1)


def far_pair_contributions(g, fl: FarList, cx_ids, cy_ids, *, s: int,
                           ff: FarFieldSpec, radius: float, dt: float,
                           ecoeff: float, friction: float, world_h: int):
    """Exact reference pair math on windows ``g [2k, 5·c²]`` (k A-side
    then k B-side chunks) → ``[2k, 5, c²]`` (dvx dvy dax day dyn): A-side
    rows carry each term, B-side rows its exact negation."""
    terms = far_pair_terms(g, fl, cx_ids, cy_ids, s=s, ff=ff, radius=radius,
                           dt=dt, ecoeff=ecoeff, friction=friction,
                           world_h=world_h)
    return torch.cat([
        torch.stack([t.sum(dim=2) for t in terms], dim=1),
        torch.stack([-t.sum(dim=1) for t in terms], dim=1),
    ], dim=0)


def far_pair_terms(g, fl: FarList, cx_ids, cy_ids, *, s: int,
                   ff: FarFieldSpec, radius: float, dt: float,
                   ecoeff: float, friction: float, world_h: int):
    """The cell-pair terms of :func:`far_pair_contributions` before they
    are summed: five ``[k, c², c²]`` tensors (dvx dvy dax day dyn), A
    cell by B cell, zero where a pair does not touch."""
    c = ff.chunk
    cc = c * c
    k = fl.capacity
    kk = torch.arange(cc, device=g.device)[None, :]
    g_ix = cx_ids[:, None] * c + kk // c
    g_iy = cy_ids[:, None] * c + kk % c
    g_lin = g_ix * world_h + g_iy
    fields = dict(px=g[:, 0:cc], py=g[:, cc:2 * cc], vx=g[:, 2 * cc:3 * cc],
                  vy=g[:, 3 * cc:4 * cc], al=g[:, 4 * cc:5 * cc], ix=g_ix,
                  iy=g_iy, lin=g_lin)
    A = {name: v[:k, :, None] for name, v in fields.items()}  # [k, cc, 1]
    B = {name: v[k:, None, :] for name, v in fields.items()}  # [k, 1, cc]

    cheb = torch.maximum((A["ix"] - B["ix"]).abs(), (A["iy"] - B["iy"]).abs())
    self_pair = (fl.ca == fl.cb)[:, None, None]
    valid = (
        fl.valid[:, None, None]
        & (A["al"] > 0.0) & (B["al"] > 0.0)
        & (cheb > s)
        & (~self_pair | (A["lin"] < B["lin"]))
    )
    ddx = B["px"] - A["px"]
    ddy = B["py"] - A["py"]
    dist = sqrt32(ddx * ddx + ddy * ddy)
    two_r = _mul32(2.0, radius)
    coincident = valid & (dist == 0.0)
    overlap = valid & (dist > 0.0) & (dist < two_r)
    co = torch.where(coincident,
                     torch.sign(A["lin"] - B["lin"]).to(torch.float32), 0.0)

    inv = torch.where(
        overlap, torch.reciprocal(torch.where(overlap, dist, 1.0)), 0.0)
    nx, ny = ddx * inv, ddy * inv
    rvx = A["vx"] - B["vx"]
    rvy = A["vy"] - B["vy"]
    imp_n = ecoeff * (rvx * nx + rvy * ny)
    max_fric = imp_n * friction
    imp_t = torch.minimum(torch.maximum(rvx * -ny + rvy * nx, -max_fric),
                          max_fric)
    pdvx = torch.where(overlap, -(imp_n * nx + imp_t * -ny), 0.0)
    pdvy = torch.where(overlap, -(imp_n * ny + imp_t * nx), 0.0)
    clip = (two_r - dist) * 0.5 / device_scalar(_mul32(dt, dt), g.device)
    pdax = torch.where(overlap, -nx * clip, 0.0)
    pday = torch.where(overlap, -ny * clip, 0.0)
    return pdvx, pdvy, pdax, pday, co


def far_scatter_contributions(contrib, cx_ids, cy_ids, *, c: int, wp: int,
                              hp: int, valid: torch.Tensor):
    """Scatter-add ``contrib [n, 5, c²]`` into ``[5, wp, hp]`` planes, each
    cell's sums in list order on every device (``stencil.index_sum``);
    the sides of empty slots (``valid [n]`` false: all zeros) left out."""
    cc = c * c
    kk = torch.arange(cc, device=contrib.device)
    lin = ((cx_ids[:, None] * c + kk[None, :] // c) * hp
           + (cy_ids[:, None] * c + kk[None, :] % c)).reshape(-1)
    vals = contrib.permute(0, 2, 1).reshape(-1, 5)
    keep = valid[:, None].expand(-1, cc).reshape(-1)
    return index_sum(lin, vals, wp * hp, keep).T.reshape(5, wp, hp)


def far_collision_terms(px, py, vx, vy, alive, fl: FarList, *, s: int,
                        ff: FarFieldSpec, radius: float, dt: float,
                        ecoeff: float, friction: float,
                        world_h: Optional[int] = None):
    """Reference pair math over the candidate chunk pairs → dense
    (dvx, dvy, dax, day, dyn) delta planes ``[W, H]``: gather windows →
    pair contributions → scatter.  ``world_h`` only orders linear
    indices (the coincident nudge); it defaults to the padded grid."""
    w, h = px.shape
    _cwx, cwy, wp, hp = _chunk_dims(w, h, ff)
    c = ff.chunk
    ids = torch.cat([fl.ca, fl.cb])
    cx_ids, cy_ids = ids // cwy, ids % cwy
    stack = torch.stack([px, py, vx, vy, alive.to(torch.float32)])
    g = far_gather_windows(stack, cx_ids, cy_ids, c=c, w=w, h=h)
    contrib = far_pair_contributions(
        g, fl, cx_ids, cy_ids, s=s, ff=ff, radius=radius, dt=dt,
        ecoeff=ecoeff, friction=friction,
        world_h=hp if world_h is None else world_h)
    planes = far_scatter_contributions(
        contrib, cx_ids, cy_ids, c=c, wp=wp, hp=hp,
        valid=torch.cat([fl.valid, fl.valid]))[:, :w, :h]
    return tuple(planes[i] for i in range(5))
