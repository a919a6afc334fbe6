"""The dense collision stencil (kernel K3): the port of
``softbody_tpu/ops/pallas/collide_stencil.py``.

Every particle sums the reference pair math (compute.wgsl:150-168) over
its **full** offset set ``(2s+1)² − 1`` in K3's order — dx-major from
−s to s, then dy — with no reactions: each unordered pair is evaluated
at both ends.  This is not the half-offset sum order of the XLA stencil
(``ops/stencil.py::_stencil_collisions``), so the plain version here
loops over K3's offsets itself.

``collide_stencil_call`` is the K3 wrapper: on CUDA tensors it launches
the hand-written kernel (``csrc/collide_stencil.cu``) on the planes where
they lie (any strides; the interleaved views ``pos[..., 0]``,
``pos[..., 1]`` of a ``[W, H, 2]`` state are read as pairs), on CPU
tensors it runs the plain version ``collide_stencil_plain``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..stencil import shifted, sqrt32
from . import _lib

MAX_STENCIL = 8

# launches of the CUDA kernel (the plain version does not count)
K3_LAUNCHES = 0


def full_offsets(s: int) -> Tuple[Tuple[int, int], ...]:
    """K3's offsets of radius ``s``, in summation order."""
    return tuple((dx, dy) for dx in range(-s, s + 1)
                 for dy in range(-s, s + 1) if (dx, dy) != (0, 0))


def _scalars(radius, dt):
    """``(2r, 1/dt²)`` in float32, as K3 forms them (0-d tensors where
    ``radius`` and ``dt`` are)."""
    if isinstance(radius, torch.Tensor):
        return 2.0 * radius, torch.reciprocal(dt * dt)
    r, t = np.float32(radius), np.float32(dt)
    return float(np.float32(2.0) * r), float(np.float32(1.0) / (t * t))


def offset_terms(px, py, vx, vy, alive, dx: int, dy: int, *, radius: float,
                 dt: float, ecoeff: float, friction: float):
    """K3's terms of offset ``(dx, dy)``: ``(d2, (tvx, tvy, tax, tay,
    tdyn))``, each ``[W, H]``, with ``d2 = ddx² + ddy²`` to the partner.
    The plain version sums ``acc − t`` (dvx dvy dax day) and ``acc + t``
    (dyn) over ``full_offsets``.

    Terms are masked by multiplying with ``ovf`` (1.0 / 0.0) as K3 does,
    so a non-finite term gives NaN where a ``where`` would give 0.  The
    coincident nudge ``sign(lin_i − lin_j)`` with ``lin = x·H + y`` is the
    per-offset constant ``−sign(dx·H + dy)`` (exact in float32 below
    2²⁴).  Out-of-range neighbours read as dead particles at the origin."""
    h = px.shape[1]
    two_r, inv_dt2 = _scalars(radius, dt)
    valid = alive & shifted(alive, dx, dy, False)
    ddx = shifted(px, dx, dy) - px
    ddy = shifted(py, dx, dy) - py
    d2 = ddx * ddx + ddy * ddy
    dist = sqrt32(d2)
    coincident = valid & (dist == 0.0)
    overlap = valid & (dist > 0.0) & (dist < two_r)
    tdyn = torch.where(coincident, -float(np.sign(dx * h + dy)), 0.0)
    inv = torch.where(
        overlap, torch.reciprocal(torch.where(overlap, dist, 1.0)), 0.0)
    nx, ny = ddx * inv, ddy * inv
    rvx = vx - shifted(vx, dx, dy)
    rvy = vy - shifted(vy, dx, dy)
    imp_n = ecoeff * (rvx * nx + rvy * ny)
    max_fric = imp_n * friction
    imp_t = torch.minimum(torch.maximum(rvx * -ny + rvy * nx, -max_fric),
                          max_fric)
    ovf = overlap.to(torch.float32)
    clip = (two_r - dist) * 0.5 * inv_dt2
    return d2, ((imp_n * nx + imp_t * -ny) * ovf,
                (imp_n * ny + imp_t * nx) * ovf,
                nx * clip * ovf, ny * clip * ovf, tdyn)


def collide_stencil_plain(px, py, vx, vy, alive, *, radius: float, dt: float,
                          ecoeff: float, friction: float, stencil: int):
    """Plain torch version of K3: ``(dvx, dvy, dax, day, dyn)`` ``[W, H]``,
    the terms of ``offset_terms`` summed in K3's order."""
    z = torch.zeros_like(px)
    dvx, dvy, dax, day, dyn = z, z, z, z, z
    for dx, dy in full_offsets(stencil):
        _d2, (tvx, tvy, tax, tay, tdyn) = offset_terms(
            px, py, vx, vy, alive, dx, dy, radius=radius, dt=dt,
            ecoeff=ecoeff, friction=friction)
        dvx, dvy = dvx - tvx, dvy - tvy
        dax, day = dax - tax, day - tay
        dyn = dyn + tdyn
    return dvx, dvy, dax, day, dyn


def collide_stencil_call(px, py, vx, vy, alive, *, radius, dt, ecoeff,
                         friction, stencil: int, consts=None, skip=None):
    """Collision deltas ``(dvx, dvy, dax, day, dyn)`` of the full offset
    set of radius ``stencil`` (kernel K3).

    ``px py vx vy`` float32 ``[W, H]`` at any strides (the kernel reads
    them in place), ``alive`` bool ``[W, H]``, on one device; the scalars
    are float32 values (host floats or 0-d tensors).  ``consts``: the
    frame's consts vector (``config.consts_vector`` order) on the planes'
    device, which the kernel reads there in the scalars' place (radius
    0, dt 1, ecoeff 7, friction 8: a captured frame's constants live in
    device memory), with ``skip``, whether those constants allow K3's
    skip (decided on the host: ``stencil.Decisions.k3_skip``).  On CUDA
    tensors the kernel runs on the current stream without synchronising;
    on CPU tensors the plain version runs."""
    global K3_LAUNCHES
    shape = tuple(px.shape)
    if len(shape) != 2:
        raise ValueError(f"planes must be [W, H], got {shape}")
    for name, t in (("px", px), ("py", py), ("vx", vx), ("vy", vy)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}")
    if alive.dtype != torch.bool or tuple(alive.shape) != shape:
        raise ValueError(f"alive must be bool {shape}")
    devices = {t.device for t in (px, py, vx, vy, alive)}
    if len(devices) != 1:
        raise ValueError(f"planes on several devices: {devices}")
    if not 1 <= stencil <= MAX_STENCIL:
        raise ValueError(f"stencil {stencil} outside [1, {MAX_STENCIL}]")
    kw = dict(radius=radius, dt=dt, ecoeff=ecoeff, friction=friction,
              stencil=stencil)
    device = px.device
    if device.type == "cpu":
        return collide_stencil_plain(px, py, vx, vy, alive, **kw)
    if device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {device}")
    if consts is not None:
        if (consts.device != device or consts.dtype != torch.float32
                or consts.dim() != 1 or consts.shape[0] < 9
                or not consts.is_contiguous()):
            raise ValueError(f"consts must be a contiguous float32 vector "
                             f"of >= 9 on {device}")
        if skip is None:
            raise ValueError("device constants need the host's skip "
                             "decision (skip=)")
    elif any(isinstance(x, torch.Tensor) for x in kw.values()):
        raise ValueError("tensor scalars need their consts vector "
                         "(consts=)")
    lib = _lib.library()
    planes = (px, py, vx, vy)
    strides = np.ascontiguousarray([t.stride() for t in planes], np.int64)
    alive = alive.contiguous()  # a state's alive plane already is
    out = torch.empty((5,) + shape, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in planes]
        if consts is not None:
            err = lib.sb_collide_stencil_dev(
                *ptrs, strides.ctypes.data, alive.data_ptr(),
                out.data_ptr(), consts.data_ptr(), int(skip), shape[0],
                shape[1], stencil, stream)
        else:
            two_r, inv_dt2 = _scalars(radius, dt)
            err = lib.sb_collide_stencil_strided(
                *ptrs, strides.ctypes.data, alive.data_ptr(),
                out.data_ptr(), two_r, inv_dt2,
                float(np.float32(ecoeff)), float(np.float32(friction)),
                shape[0], shape[1], stencil, stream)
    _lib.check(err, "K3 collide_stencil")
    K3_LAUNCHES += 1
    return tuple(out[i] for i in range(5))
