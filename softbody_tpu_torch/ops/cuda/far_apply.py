"""The far apply's pair step (kernels K8a and K8b, ``csrc/far_apply.cu``)
and the destination order they sum in.

- :func:`dest_order`: each destination chunk's list sides in the order
  ``stencil.index_sum`` sums them (every A side by ascending slot, then
  every B side by ascending slot), built once per rebuild from the full
  list: a crop to a rung's capacity or an active prefix only masks
  entries, so one order serves every rung and substep of a block.  Plain
  torch on every device (a stable sort of the sides by chunk and a
  search of each chunk's run).
- K8a ``far_pairs_call``: each valid slot's 256 cell-pair terms
  (``farfield.far_pair_terms``) summed per side cell over the partner
  cells in ascending order from +0.0 (the B side negated) into a
  ``[2k, 80]`` scratch of side rows.
- K8b ``far_accumulate_call``: every cell of the delta planes ``[5, wo,
  ho]``: its chunk's rows valid at this substep, summed in the order's
  run from +0.0 (zeros where none).

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors; the plain versions add in the kernels' order, so
the two agree bit for bit.  ``ops/farfield4.py`` routes the card's
default record layout through them."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..farfield import FarList, far_gather_windows, far_pair_terms
from ..stencil import _mul32
from . import _lib

C = 4              # chunk side
CC = C * C         # cells per chunk
NF = 5             # px py vx vy alive / dvx dvy dax day dyn
ROW = NF * CC      # floats per side row of the scratch

# launches of the CUDA kernels (the plain versions do not count)
K8A_LAUNCHES = 0
K8B_LAUNCHES = 0


@dataclasses.dataclass
class DestOrder:
    """A list's destination order.  ``sides [2K]`` int64: the side ids
    (slot for A, ``K + slot`` for B) sorted stably by their chunk, the
    slots the list leaves empty last; ``offsets [chunks + 1]`` int32:
    chunk ``c``'s run is ``sides[offsets[c]:offsets[c + 1]]``;
    ``capacity`` is ``K``."""

    sides: torch.Tensor
    offsets: torch.Tensor
    capacity: int


def empty_order(capacity: int, chunks: int, device) -> DestOrder:
    """Buffers for :func:`dest_order` (``into=``), unfilled."""
    return DestOrder(
        torch.empty(2 * capacity, dtype=torch.int64, device=device),
        torch.empty(chunks + 1, dtype=torch.int32, device=device), capacity)


def dest_order(ca: torch.Tensor, cb: torch.Tensor, valid: torch.Tensor,
               chunks: int, into: DestOrder = None) -> DestOrder:
    """The destination order of the list ``(ca, cb, valid)`` of capacity
    ``K`` over ``chunks`` chunks (a stable sort of the sides by chunk,
    the empty slots' sides on chunk ``chunks``), written into ``into``
    when given (its buffers then serve later applies; no host read)."""
    k = ca.shape[0]
    chunk = torch.where(torch.cat([valid, valid]),
                        torch.cat([ca, cb]).to(torch.int32), chunks)
    by_chunk, sides = torch.sort(chunk, stable=True)
    starts = torch.arange(chunks + 1, dtype=torch.int32, device=ca.device)
    offsets = torch.searchsorted(by_chunk, starts, out_int32=True)
    if into is None:
        return DestOrder(sides, offsets, k)
    if into.capacity != k or into.offsets.shape[0] != chunks + 1:
        raise ValueError("order buffers of another list shape")
    into.sides.copy_(sides)
    into.offsets.copy_(offsets)
    return into


def _check_plane(name, t, shape):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_list(fl: FarList):
    for name in ("ca", "cb"):
        t = getattr(fl, name)
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"the list's {name} must be contiguous int64")
    if fl.valid.dtype != torch.bool or not fl.valid.is_contiguous():
        raise ValueError("the list's valid must be contiguous bool")


def far_pairs_plain(planes: Sequence[torch.Tensor], fl: FarList, *, s: int,
                    ff, radius: float, dt: float, ecoeff, friction, h: int,
                    world_h: int) -> torch.Tensor:
    """K8a's plain version: ``[2k, 80]`` side rows of the list ``fl``
    (capacity k; chunk ids ``cx · (h/4) + cy``) on the five planes
    (zero-padded past their extent).  The rows of invalid slots are
    zeros here; the kernel leaves them unwritten."""
    planes = tuple(planes)
    pw, ph = planes[0].shape
    k = fl.capacity
    ids = torch.cat([fl.ca, fl.cb])
    cx, cy = ids // (h // C), ids % (h // C)
    g = far_gather_windows(torch.stack(planes), cx, cy, c=C, w=pw, h=ph)
    terms = far_pair_terms(g, fl, cx, cy, s=s, ff=ff, radius=radius, dt=dt,
                           ecoeff=ecoeff, friction=friction, world_h=world_h)
    a = torch.zeros((k, NF, CC), dtype=torch.float32, device=g.device)
    b = torch.zeros_like(a)
    for j in range(CC):
        a = a + torch.stack([t[:, :, j] for t in terms], dim=1)
        b = b + torch.stack([t[:, j, :] for t in terms], dim=1)
    return torch.cat([a, -b]).reshape(2 * k, ROW)


def _by_value(x, device):
    """``(host value, device pointer)`` of a scalar the kernel reads:
    a host float by value, a 0-d tensor in device memory."""
    if isinstance(x, torch.Tensor):
        t = x.reshape(()).to(device=device, dtype=torch.float32)
        return 0.0, t
    return float(np.float32(x)), None


def far_pairs_call(planes: Sequence[torch.Tensor], fl: FarList, *, s: int,
                   ff, radius: float, dt: float, ecoeff, friction, h: int,
                   world_h: int) -> torch.Tensor:
    """K8a: the side rows ``[2k, 80]`` of the list ``fl`` (capacity k,
    cropped to the rung) on five float32 ``[W, H]`` planes (px py vx vy,
    alive as 0/1; any strides, equal for the five).  ``radius``, ``dt``:
    host floats; ``ecoeff``, ``friction``: host floats or 0-d float32
    tensors on the planes' device (read in device memory, so a captured
    frame reads each replay's).  The rows of invalid slots are left
    unwritten on the card."""
    global K8A_LAUNCHES
    planes = tuple(planes)
    if len(planes) != NF:
        raise ValueError(f"need {NF} planes, got {len(planes)}")
    pw, ph = planes[0].shape
    for i, p in enumerate(planes):
        _check_plane(f"plane {i}", p, (pw, ph))
    _check_list(fl)
    if ff.chunk != C or h % C:
        raise ValueError(f"K8 takes {C}x{C} chunks on a grid height that "
                         f"is a multiple of {C}, got chunk {ff.chunk}, h {h}")
    device = planes[0].device
    if {p.device for p in planes} | {fl.ca.device, fl.cb.device,
                                     fl.valid.device} != {device}:
        raise ValueError("the planes and the list on several devices")
    if device.type == "cpu":
        return far_pairs_plain(planes, fl, s=s, ff=ff, radius=radius, dt=dt,
                               ecoeff=ecoeff, friction=friction, h=h,
                               world_h=world_h)
    if device.type != "cuda":
        raise ValueError(f"no K8a kernel for device {device}")
    if len({p.stride() for p in planes}) != 1:
        planes = tuple(p.contiguous() for p in planes)
    k = fl.capacity
    scratch = torch.empty((2 * k, ROW), dtype=torch.float32, device=device)
    if k == 0:
        return scratch
    e_val, e_dev = _by_value(ecoeff, device)
    f_val, f_dev = _by_value(friction, device)
    sx, sy = planes[0].stride()
    lib = _lib.library()
    with torch.cuda.device(device):
        err = lib.sb_far_pairs(
            *(p.data_ptr() for p in planes), sx, sy, pw, ph,
            fl.ca.data_ptr(), fl.cb.data_ptr(), fl.valid.data_ptr(), k,
            h // C, world_h, s, _mul32(2.0, radius), _mul32(dt, dt), e_val,
            f_val, None if e_dev is None else e_dev.data_ptr(),
            None if f_dev is None else f_dev.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _lib.check(err, "K8a far_pairs")
    K8A_LAUNCHES += 1
    return scratch


def far_accumulate_plain(scratch: torch.Tensor, order: DestOrder,
                         valid: torch.Tensor, out: torch.Tensor, *,
                         h: int) -> torch.Tensor:
    """K8b's plain version: each cell of ``out [5, wo, ho]`` the sum of
    its chunk's side rows valid now (slot < k = ``valid``'s length and
    ``valid[slot]``), added in the order's run from +0.0 (a left-out
    entry adds +0.0, which changes no such sum)."""
    k, cap = valid.shape[0], order.capacity
    cwy = h // C
    chunks = order.offsets.shape[0] - 1
    starts = order.offsets[:-1].to(torch.int64)
    runs = order.offsets[1:].to(torch.int64) - starts
    acc = scratch.new_zeros((chunks, ROW))
    for p in range(int(runs.max()) if k and chunks else 0):
        side = order.sides[(starts + p).clamp(max=2 * cap - 1)]
        b_side = side >= cap
        slot = torch.where(b_side, side - cap, side).clamp(max=k - 1)
        ok = (p < runs) & (side % cap < k) & valid[slot]
        row = torch.where(b_side, k + slot, slot)
        acc = acc + torch.where(ok[:, None], scratch[row], 0.0)
    wo, ho = out.shape[1:]
    cwx = -(-wo // C)
    planes = (acc.reshape(chunks // cwy, cwy, NF, C, C)[:cwx]
              .permute(2, 0, 3, 1, 4).reshape(NF, cwx * C, cwy * C))
    return out.copy_(planes[:, :wo, :ho])


def far_accumulate_call(scratch: torch.Tensor, order: DestOrder,
                        valid: torch.Tensor, out: torch.Tensor, *,
                        h: int) -> torch.Tensor:
    """K8b: the delta planes ``out [5, wo, ho]`` (float32, contiguous;
    its cells those of the apply's grid ``[w, h]`` from the corner) from
    K8a's rows ``scratch [2k, 80]``, ``valid`` the rung's ``[k]`` slots
    at this substep, ``order`` the full list's.  Returns ``out``."""
    global K8B_LAUNCHES
    k = valid.shape[0]
    if scratch.shape != (2 * k, ROW) or scratch.dtype != torch.float32:
        raise ValueError(f"scratch must be float32 [{2 * k}, {ROW}]")
    if out.dim() != 3 or out.shape[0] != NF or not out.is_contiguous():
        raise ValueError("out must be contiguous [5, wo, ho]")
    if out.dtype != torch.float32 or k > order.capacity:
        raise ValueError("out must be float32, and k at most the order's "
                         "capacity")
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError("valid must be contiguous bool")
    chunks = order.offsets.shape[0] - 1
    if (order.sides.dtype != torch.int64
            or order.sides.shape != (2 * order.capacity,)
            or order.offsets.dtype != torch.int32
            or not order.offsets.is_contiguous()):
        raise ValueError("order: int64 sides [2K], int32 offsets")
    wo, ho = out.shape[1:]
    if h % C or ho > h or -(-wo // C) * (h // C) > chunks:
        raise ValueError(f"out [{wo}, {ho}] lies outside the order's grid "
                         f"of {chunks} chunks, {h // C} high")
    if {scratch.device, valid.device, order.sides.device,
            order.offsets.device} != {out.device}:
        raise ValueError("K8b's tensors on several devices")
    if out.device.type == "cpu":
        return far_accumulate_plain(scratch, order, valid, out, h=h)
    if out.device.type != "cuda":
        raise ValueError(f"no K8b kernel for device {out.device}")
    lib = _lib.library()
    with torch.cuda.device(out.device):
        err = lib.sb_far_accumulate(
            scratch.data_ptr(), order.sides.data_ptr(),
            order.offsets.data_ptr(), valid.data_ptr(), k, order.capacity,
            h // C, out.data_ptr(), out.shape[1], out.shape[2],
            torch.cuda.current_stream(out.device).cuda_stream)
    _lib.check(err, "K8b far_accumulate")
    K8B_LAUNCHES += 1
    return out
