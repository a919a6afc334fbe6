"""Far-field v4 pair apply: the port of ``softbody_tpu/ops/farfield4.py``
(the mirror-record route, of any lane block ``mb`` that is a multiple
of 32; 32 by default), and on the card its pair step as kernel K8.

The candidate list is cropped to the smallest capacity bucket ≥
``n_pairs`` (a light frame does not pay for the full capacity; the rung is chosen on
the device, as ``lax.switch`` chooses it: ``compiled.device_switch``),
then each rung takes one of three routes, by what the call shows:

- CUDA tensors with the default record layout (``mb`` 32, ``mb_out``
  None or 32): K8 (:func:`far_delta_planes_kernel`, ``ops/cuda/
  far_apply.py``) on every rung.  K8a computes each valid slot's pair
  terms from windows read straight from the planes and sums them per
  side cell; K8b sums each destination chunk's side rows in the list
  order (:class:`BlockOrder`, built once per rebuild) from +0.0 into the
  delta planes.  ``narrow_max`` and ``krec`` pick nothing here: the two
  routes below gave the same bits.
- CUDA tensors with an explicit lane block (JAX's ``far_mb`` /
  ``far_mb_out`` measurement knobs), and CPU tensors (the reference the
  tests hold against JAX), keep the JAX package's two routes:

  - buckets ≤ ``narrow_max`` (256; :func:`far_delta_planes_narrow`): each
    pair side's window is gathered as 20 narrow rows (5 fields × 4 plane
    rows × 32 lanes) of a ``[5·W·Hm/32, 32]`` view of the planes, and the
    deltas are scatter-added back the same way, in list order on every
    device (``stencil.index_sum``);
  - larger buckets: the planes are relaid once into the (4, mb) record
    table (:func:`mirror_table`, kernel K7 on the card), one record row
    is gathered per pair side (:func:`far_terms_from_mirror`), the delta
    records are scatter-added into a table of lane block ``mb_out``
    (default ``mb``) and laid back into planes (:func:`unmirror_table`).

Layout: record row ``b·(W/4) + cx`` holds plane rows ``4cx..4cx+3``,
lanes ``[mb·b, mb·b + mb)``, as ``[5 fields × 4 rows × mb lanes]`` (640
floats at mb = 32).  A 4 × 4 chunk's window always lies in one record;
its offset is selected by sums of masked slices started from +0.0, as in
the JAX package: above 32 lanes first the 32-lane part (``mb/32``
slices), then the chunk's place in it (eight), and the delta rows are
placed back the same two ways round.  So a ``-0.0`` reads back as
``+0.0`` on both sides, and a wider block adds only ``+0.0`` terms to
each sum: every lane block gives the same bits.

The apply runs on the rebuild's tile-padded grid ``(wp, hp)``
(``farfield._chunk_dims``; 1008 × 1008 at 1M), where the chunk id
``cx·(hp/4) + cy`` decodes as the rebuild encoded it; the pad is alive 0
and the deltas are cropped back to ``[W, H]``.  Linear indices (the
coincident nudge's order) use ``world_h = Hm``, the padded height
rounded up to the gather's lane block, as the JAX package passes.

Under the JAX kernel variant ``krec`` every bucket takes the record
table (``softbody_tpu/ops/farfield4.py:277``: ``k <= 256 and not
as_table``): ``narrow_max=0``.  The pre-built ``table=`` / ``as_table=``
records (K1's record side output and input in JAX) are not ported: the
functions raise on them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .cuda import far_apply
from .cuda.recmirror import MB, NF, RX, mirror_records_call
from .farfield import (
    FarFieldSpec,
    FarList,
    _chunk_dims,
    crop_far_list,
    far_pair_contributions,
)
from .stencil import index_sum

PX, PY, VX, VY = range(4)
# buckets at or below this take the narrow-row route
NARROW_MAX = 256
# bucketed applies run, by route (each mirror apply launches K7 once on
# CUDA tensors; each kernel apply K8a and K8b once each)
APPLY_ROUTES = {"narrow": 0, "mirror": 0, "kernel": 0}


def _mh(h: int, mb: int = MB) -> int:
    return -(-h // mb) * mb


def _check_layout(mb: int, mb_out: Optional[int] = None) -> None:
    """A record lane block (and the scatter side's, when given) is a
    positive multiple of 32 (``softbody_tpu/ops/farfield4.py:130``,
    ``:179``)."""
    for name, v in (("mb", mb), ("mb_out", mb_out)):
        if v is not None and (int(v) != v or v <= 0 or v % MB):
            raise ValueError(f"record lane block {name}={v}: a positive "
                             f"multiple of {MB}")


def bucket_capacity(n_pairs: int, ff: FarFieldSpec,
                    buckets: Tuple[int, ...]) -> int:
    """Smallest bucket ≥ ``n_pairs`` (the list's capacity caps it)."""
    ladder = tuple(b for b in buckets if b < ff.max_pairs) + (ff.max_pairs,)
    return next(b for b in ladder if b >= min(n_pairs, ff.max_pairs))


def _padded_stack(planes, w: int, h: int) -> torch.Tensor:
    """``[5, w, h]``: the five planes zero-padded (no copy if they already
    are a ``[5, w, h]`` tensor)."""
    if isinstance(planes, torch.Tensor) and tuple(planes.shape) == (NF, w, h):
        return planes
    stack = torch.stack(tuple(planes))
    out = stack.new_zeros((NF, w, h))
    out[:, :stack.shape[1], :stack.shape[2]] = stack
    return out


def mirror_table(planes, *, mb: int = MB, w: Optional[int] = None,
                 h: Optional[int] = None) -> torch.Tensor:
    """``[5, W, H]`` (px, py, vx, vy, alive), or a sequence of five
    ``[W, H]`` planes, → the ``[(Hm/mb)·(w/4), 20·mb]`` record table of
    the planes zero-padded to ``[w, Hm]`` (``w``/``h`` default to
    ``W``/``H``; ``Hm`` is ``h`` rounded up to ``mb``).  Kernel K7 on
    CUDA tensors, its plain version on CPU tensors."""
    _check_layout(mb)
    planes = tuple(planes)
    w0, h0 = planes[0].shape
    w = w0 if w is None else w
    h = h0 if h is None else h
    return mirror_records_call(planes, w_out=w, h_out=_mh(h, mb), mb=mb)


def unmirror_table(table: torch.Tensor, *, w: int, h: int,
                   mb: int = MB) -> torch.Tensor:
    """Inverse of :func:`mirror_table` (delta tables → delta planes
    ``[5, w, h]``, a view)."""
    _check_layout(mb)
    hm = _mh(h, mb)
    t = table.reshape(hm // mb, w // RX, NF, RX, mb).permute(2, 1, 3, 0, 4)
    return t.reshape(NF, w, hm)[:, :, :h]


def _decode(fl: FarList, c: int, h: int):
    """Both sides' chunk coordinates ``[2k]`` and the lane of their
    window's first column."""
    ids = torch.cat([fl.ca, fl.cb])
    cwy = h // c
    cx = ids // cwy
    cy = ids % cwy
    return cx, cy, cy * c


def _select_windows(seg: torch.Tensor, off: torch.Tensor,
                    c: int) -> torch.Tensor:
    """``seg [n, 5, c, mb]`` → window fields ``[n, 5·c²]``: above 32
    lanes the sum of the ``mb/32`` masked 32-lane parts (the part holding
    the window), then the sum of the eight masked ``c``-lane slices, each
    started from +0.0 (``softbody_tpu/ops/farfield4.py:153-175``)."""
    n, mb = seg.shape[0], seg.shape[-1]
    o32 = off % MB
    if mb > MB:
        part = seg.new_zeros((n, NF, c, MB))
        for o in range(0, mb, MB):
            hit = ((off - o32) == o)[:, None, None, None]
            part = part + torch.where(hit, seg[..., o:o + MB], 0.0)
        seg = part
    win = seg.new_zeros((n, NF, c, c))
    for o in range(0, MB, c):
        hit = (o32 == o)[:, None, None, None]
        win = win + torch.where(hit, seg[..., o:o + c], 0.0)
    return win.reshape(n, NF * c * c)


def _place_windows(contrib: torch.Tensor, off: torch.Tensor, c: int,
                   mb: int = MB) -> torch.Tensor:
    """``contrib [n, 5, c²]`` → ``[n, 5, c, mb]`` lane segments, each
    window at its offset ``off`` (the inverse of :func:`_select_windows`:
    the eight places in a 32-lane part, then above 32 lanes the
    ``mb/32`` places of the part; ``softbody_tpu/ops/farfield4.py:
    177-206``)."""
    n = contrib.shape[0]
    cb4 = contrib.reshape(n, NF, c, c)
    o32 = off % MB
    seg = contrib.new_zeros((n, NF, c, MB))
    for o in range(0, MB, c):
        hit = (o32 == o)[:, None, None, None]
        seg = seg + torch.where(hit, F.pad(cb4, (o, MB - c - o)), 0.0)
    if mb > MB:
        rows = contrib.new_zeros((n, NF, c, mb))
        for o in range(0, mb, MB):
            hit = ((off - o32) == o)[:, None, None, None]
            rows = rows + torch.where(hit, F.pad(seg, (o, mb - MB - o)), 0.0)
        seg = rows
    return seg


def _check_chunk(ff: FarFieldSpec) -> int:
    if ff.chunk != RX:
        raise ValueError(f"the record layout assumes {RX}x{RX} chunks, got "
                         f"chunk {ff.chunk}")
    return ff.chunk


def far_terms_from_mirror(table: torch.Tensor, fl: FarList, *, s: int,
                          ff: FarFieldSpec, radius: float, dt: float,
                          ecoeff: float, friction: float, w: int, h: int,
                          mb: int = MB, mb_out: Optional[int] = None,
                          ) -> torch.Tensor:
    """Pair apply against a (4, mb)-record mirror: returns the
    ``[(Hm'/mb')·(w/4), 20·mb']`` delta table (dvx dvy dax day dyn in the
    record layout of lane block ``mb' = mb_out``, default ``mb``; ``Hm'``
    is ``h`` rounded up to it).  One gathered row per pair side, the
    windows selected per offset, the exact pair math
    (``farfield.far_pair_contributions``), the inverse placement and one
    row scatter-add, in list order on every device
    (``stencil.index_sum``; the empty slots' rows left out)."""
    _check_layout(mb, mb_out)
    c = _check_chunk(ff)
    mo = mb if mb_out is None else mb_out
    hm = _mh(h, mb)
    cw = w // RX
    cx, cy, lane0 = _decode(fl, c, h)
    row_ids = (lane0 // mb) * cw + cx
    n2k = row_ids.shape[0]
    g = _select_windows(table[row_ids].reshape(n2k, NF, RX, mb),
                        lane0 % mb, c)
    contrib = far_pair_contributions(
        g, fl, cx, cy, s=s, ff=ff, radius=radius, dt=dt, ecoeff=ecoeff,
        friction=friction, world_h=hm)
    drows = _place_windows(contrib, lane0 % mo, c, mo)
    return index_sum((lane0 // mo) * cw + cx,
                     drows.reshape(n2k, NF * RX * mo),
                     (_mh(h, mo) // mo) * cw,
                     keep=torch.cat([fl.valid, fl.valid]))


def far_delta_planes_narrow(planes5, fl: FarList, *, s: int,
                            ff: FarFieldSpec, radius: float, dt: float,
                            ecoeff: float, friction: float, w: int,
                            h: int) -> torch.Tensor:
    """Mirror-free apply for small buckets: each pair side's window is
    gathered as 20 narrow rows (5 fields × 4 plane rows × 32 lanes) of a
    reshaped plane view, and the deltas are scatter-added back the same
    way.  ``planes5``: ``[5, w, h]``, or five planes that are zero-padded
    to it.  Returns the delta planes ``[5, w, h]`` (a view)."""
    c = _check_chunk(ff)
    hm = _mh(h)
    nb = hm // MB
    view = _padded_stack(planes5, w, hm).reshape(NF * w * nb, MB)
    cx, cy, lane0 = _decode(fl, c, h)
    blk, off = lane0 // MB, lane0 % MB
    n2k = cx.shape[0]
    fidx = torch.arange(NF, device=cx.device)[None, :, None]
    ridx = cx[:, None, None] * c + torch.arange(c, device=cx.device)[None,
                                                                       None]
    rows = ((fidx * w + ridx) * nb + blk[:, None, None]).reshape(-1)
    seg = view[rows].reshape(n2k, NF, c, MB)
    contrib = far_pair_contributions(
        _select_windows(seg, off, c), fl, cx, cy, s=s, ff=ff, radius=radius,
        dt=dt, ecoeff=ecoeff, friction=friction, world_h=hm)
    keep = torch.cat([fl.valid, fl.valid])[:, None].expand(-1, NF * c)
    out = index_sum(rows, _place_windows(contrib, off, c).reshape(-1, MB),
                    NF * w * nb, keep=keep.reshape(-1))
    return out.reshape(NF, w, hm)[:, :, :h]


def bucket_index(n_pairs: torch.Tensor, ff: FarFieldSpec,
                 buckets: Tuple[int, ...]) -> torch.Tensor:
    """The JAX package's branch of ``lax.switch`` (``farfield4.py:295-308``)
    on the device: 0 for an empty list, else ``1 +`` the rung of the
    smallest bucket ≥ ``n_pairs`` in the ladder (the list's capacity caps
    it), a 0-d int64 tensor."""
    ladder = tuple(b for b in buckets if b < ff.max_pairs) + (ff.max_pairs,)
    n = n_pairs.to(torch.int64)
    bidx = sum(((n > b).to(torch.int64) for b in ladder[:-1]),
               torch.zeros_like(n))
    return (n > 0).to(torch.int64) * (bidx + 1)


def kernel_route(device, mb: int = MB, mb_out: Optional[int] = None) -> bool:
    """Whether an apply on ``device`` with the lane blocks ``mb`` /
    ``mb_out`` takes K8: CUDA tensors with the default record layout."""
    return (torch.device(device).type == "cuda" and mb == MB
            and mb_out in (None, MB))


class BlockOrder:
    """K8's destination order (``far_apply.dest_order``) for the applies
    of one rebuild's list ``fl``, built once, at the first apply that
    takes the kernel route (after that apply's ``far_apply`` mark), and
    kept on the device for the block's later applies.  Off the kernel
    route nothing is built.

    ``same_list``: every apply of the block is given ``fl`` itself (no
    active prefix), so the order is built inside the rungs of the first
    apply's switch, and a block whose list is empty builds nothing;
    otherwise (an active prefix, which can be empty at first while the
    list is not) it is built before the first apply's switch."""

    def __init__(self, fl: FarList, same_list: bool = False) -> None:
        self.fl = fl
        self.same_list = same_list
        self.order: Optional[far_apply.DestOrder] = None

    def take(self, w: int, h: int):
        """At an apply on the grid ``[w, h]``: ``(order, build)``, where
        ``build`` (or None) fills ``order`` from the full list and must
        run in each applying rung before K8."""
        chunks = (w // RX) * (h // RX)
        if self.order is not None:
            if self.order.offsets.shape[0] != chunks + 1:
                raise ValueError("one block's applies on two grids")
            return self.order, None
        fl = self.fl
        self.order = far_apply.empty_order(fl.capacity, chunks,
                                           fl.ca.device)

        def build():
            far_apply.dest_order(fl.ca, fl.cb, fl.valid, chunks,
                                 into=self.order)

        if self.same_list:
            return self.order, build
        build()
        return self.order, None


def far_delta_planes_kernel(planes5, fl: FarList,
                            order: far_apply.DestOrder, *, s: int,
                            ff: FarFieldSpec, radius: float, dt: float,
                            ecoeff, friction, w: int, h: int,
                            out: Optional[torch.Tensor] = None,
                            ) -> torch.Tensor:
    """K8 on the list ``fl`` cropped to a rung: K8a's side rows from the
    five planes (``[w, h]`` or smaller, read as dead past their extent),
    then K8b's delta planes in ``order`` (the full list's) into ``out``
    (``[5, w', h']``, the grid's corner; ``[5, w, h]`` if None), which
    is returned."""
    rows = far_apply.far_pairs_call(
        planes5, fl, s=s, ff=ff, radius=radius, dt=dt, ecoeff=ecoeff,
        friction=friction, h=h, world_h=_mh(h))
    if out is None:
        out = rows.new_empty((NF, w, h))
    return far_apply.far_accumulate_call(rows, order, fl.valid, out, h=h)


def _apply_bucket(planes5_fn, fl: FarList, k: int, narrow_max: int,
                  kw: dict, mb: int = MB, mb_out: Optional[int] = None,
                  order=None, out: Optional[torch.Tensor] = None,
                  ) -> torch.Tensor:
    """The list cropped to capacity ``k``, applied through K8 (``order``
    given: ``(DestOrder, build or None)``), else narrow (``k ≤
    narrow_max``; 32-lane rows whatever ``mb``, as in JAX) or through the
    mirror table of lane block ``mb`` (delta records of ``mb_out``):
    delta planes ``[5, w, h]`` (a view), or written into ``out`` (``[5,
    w', h']``, the corner) and returned."""
    flk = crop_far_list(fl, k)
    w, h = kw["w"], kw["h"]
    if order is not None:
        dest, build = order
        if build is not None:
            build()
        APPLY_ROUTES["kernel"] += 1
        return far_delta_planes_kernel(planes5_fn(), flk, dest, out=out,
                                       **kw)
    if k <= narrow_max:
        APPLY_ROUTES["narrow"] += 1
        d = far_delta_planes_narrow(planes5_fn(), flk, **kw)
    else:
        APPLY_ROUTES["mirror"] += 1
        dtab = far_terms_from_mirror(mirror_table(planes5_fn(), mb=mb, w=w,
                                                  h=h),
                                     flk, mb=mb, mb_out=mb_out, **kw)
        d = unmirror_table(dtab, w=w, h=h,
                           mb=mb if mb_out is None else mb_out)
    if out is None:
        return d
    return out.copy_(d[:, :out.shape[1], :out.shape[2]])


def bucketed_far_delta_from_fn(
    planes5_fn: Callable[[], Sequence[torch.Tensor]],
    fl: FarList,
    n_pairs: Optional[int] = None,
    *,
    s: int,
    ff: FarFieldSpec,
    radius: float,
    dt: float,
    ecoeff: float,
    friction: float,
    w: int,
    h: int,
    buckets: Tuple[int, ...] = (1024, 4096),
    mb: int = MB,
    mb_out: Optional[int] = None,
    table: Optional[torch.Tensor] = None,
    as_table: bool = False,
    narrow_max: int = NARROW_MAX,
    out: Optional[torch.Tensor] = None,
    order: Optional[BlockOrder] = None,
) -> Optional[torch.Tensor]:
    """Core bucketed apply over a deferred plane source: crop the list to
    the smallest capacity bucket ≥ its pair count and apply it through
    K8 (CUDA tensors, the default lane blocks: :func:`kernel_route`), or
    narrow (≤ ``narrow_max``, 256; 0 under ``krec``) or through the
    mirror table.  ``planes5_fn()`` returns the five planes (px, py, vx,
    vy, alive), of ``[w, h]`` or smaller (zero-padded to it); it is
    called only by a rung that applies.  ``mb``/``mb_out``: the mirror
    route's record lane blocks (gather, scatter), multiples of 32.
    ``order``: K8's destination order of the block's full list
    (:class:`BlockOrder`); None builds one from ``fl`` for this call.

    ``n_pairs=None`` (the JAX semantics, ``lax.switch``): the rung is
    chosen on the device from ``fl.n_pairs`` (:func:`bucket_index`,
    ``compiled.device_switch``: read on the host eagerly, an IF node per
    rung under capture), and every rung, the empty list's too (zeros),
    writes the delta planes into ``out`` (``[5, w', h']``, ``w' ≤ w``,
    ``h' ≤ h``: the planes' corner; allocated ``[5, w, h]`` if None),
    which is returned.  ``n_pairs`` a host int (the count already read
    there): that rung is applied and its delta planes returned (a view,
    or ``out`` written when given), or None when the list is empty."""
    from . import compiled

    _check_layout(mb, mb_out)
    if table is not None or as_table:
        raise ValueError("pre-built mirror tables (table=, as_table=; "
                         "kernel variants kmirror/krec) are not ported")
    # the chunk-id decode (cx = id // (h / chunk)) matches the rebuild's
    # tile-padded chunk grid only under these alignments
    if h % (ff.chunk * ff.tile_chunks) != 0:
        raise ValueError(f"far apply needs h ({h}) % chunk*tile_chunks "
                         f"({ff.chunk * ff.tile_chunks}) == 0")
    if w % ff.chunk != 0:
        raise ValueError(f"far apply needs w ({w}) % chunk == 0")
    kw = dict(s=s, ff=ff, radius=radius, dt=dt, ecoeff=ecoeff,
              friction=friction, w=w, h=h)
    if n_pairs is not None and n_pairs == 0:
        return None
    dest = None
    if kernel_route(fl.ca.device, mb, mb_out):
        dest = (order or BlockOrder(fl, same_list=True)).take(w, h)
    if n_pairs is not None:
        return _apply_bucket(planes5_fn, fl,
                             bucket_capacity(n_pairs, ff, buckets),
                             narrow_max, kw, mb, mb_out, dest, out)
    if out is None:
        out = fl.n_pairs.new_empty((NF, w, h), dtype=torch.float32)
    ladder = tuple(b for b in buckets if b < ff.max_pairs) + (ff.max_pairs,)
    compiled.device_switch(
        bucket_index(fl.n_pairs, ff, buckets),
        [out.zero_] + [lambda k=k: _apply_bucket(
            planes5_fn, fl, k, narrow_max, kw, mb, mb_out, dest, out)
            for k in ladder])
    return out


def bucketed_far_delta_planes(hot: torch.Tensor, alive_f: torch.Tensor,
                              fl: FarList, n_pairs: Optional[int] = None,
                              *, s: int, ff: FarFieldSpec, radius: float,
                              dt: float, ecoeff: float, friction: float,
                              buckets: Tuple[int, ...] = (1024, 4096),
                              plane_idx: Tuple[int, int, int, int] = (
                                  PX, PY, VX, VY),
                              mb: int = MB, mb_out: Optional[int] = None,
                              table: Optional[torch.Tensor] = None,
                              as_table: bool = False,
                              narrow_max: int = NARROW_MAX,
                              order: Optional[BlockOrder] = None,
                              ) -> Optional[torch.Tensor]:
    """Far delta planes ``[5, W, H]`` (dvx dvy dax day dyn, contiguous)
    for the packed state ``hot`` (px py vx vy at ``plane_idx``) and the
    float alive plane.  The apply runs on the rebuild's tile-padded grid
    (:func:`bucketed_far_delta_from_fn` with ``w, h = wp, hp``) and is
    cropped back to ``[W, H]``.  ``n_pairs=None``: the rung chosen on the
    device, zeros for an empty list (the JAX semantics); a host int: None
    for an empty list."""
    w, h = alive_f.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, ff)
    ipx, ipy, ivx, ivy = plane_idx

    def planes5_fn():
        return (hot[ipx], hot[ipy], hot[ivx], hot[ivy], alive_f)

    return bucketed_far_delta_from_fn(
        planes5_fn, fl, n_pairs, s=s, ff=ff, radius=radius, dt=dt,
        ecoeff=ecoeff, friction=friction, w=wp, h=hp, buckets=buckets,
        mb=mb, mb_out=mb_out, table=table, as_table=as_table,
        narrow_max=narrow_max, out=hot.new_empty((5, w, h)), order=order)
