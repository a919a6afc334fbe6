"""Far-field band detection (kernel K2): the port of
``softbody_tpu/ops/pallas/band_detect.py``.

``band_flag_call`` is the K2 wrapper: on CUDA tensors it launches the
hand-written kernel (``csrc/band_detect.cu``), on CPU tensors it runs
the plain version ``band_flags_plain`` — the shifted-compare loop of
``softbody_tpu/ops/farfield.py:403-411``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..stencil import shifted
from . import _lib

# K2's compile-time box: dx in [0, BAND_DX), |dy| <= BAND_DY (the
# half-plane band of chunk <= 4, the TPU kernel's); a wider band, of
# radius r = max(max dx, max |dy|) <= BAND_R_MAX (chunk <= 32), runs the
# kernel whose box is set at launch, with a staged tile of
# wide_smem_bytes(r) in shared memory
BAND_DX = 8
BAND_DY = 7
BAND_R_MAX = 63
# shared memory a block can have on an H100 (227 KB)
SMEM_LIMIT = 232448
_BX, _LANES = 16, 32       # K2's tile: W rows x H lanes per block
_BIG = 3.0e38

# launches of the CUDA kernel (the plain version does not count)
K2_LAUNCHES = 0


def band_flags_plain(px, py, dev, bdev, alive,
                     offsets: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Bool ``[W, H]``: alive particles with an alive partner at some
    offset within ``d² < (bdev_i + dev_j)²`` (``bdev = base + dev``)."""
    flag = torch.zeros_like(alive)
    for dx, dy in offsets:
        ddx = shifted(px, dx, dy, _BIG) - px
        ddy = shifted(py, dx, dy, _BIG) - py
        d2 = ddx * ddx + ddy * ddy
        reach = bdev + shifted(dev, dx, dy, 0.0)
        flag = flag | (alive & shifted(alive, dx, dy, False)
                       & (d2 < reach * reach))
    return flag


def wide_smem_bytes(r: int) -> int:
    """Shared memory of the wide-band kernel at band radius ``r``: the
    tile plus halo of px py dev and each staged row's dev range."""
    sx, sy = _BX + r, _LANES + 2 * r
    return (3 * sx * sy + 2 * sx) * 4


def band_radius(offsets: Sequence[Tuple[int, int]]) -> int:
    """The band radius K2 is launched at for ``offsets`` (0 for none):
    ``max(max dx, max |dy|)``.  Raises where the kernel cannot take them:
    dx < 0, or a radius past BAND_R_MAX (chunk 32), where the per-dy
    offset mask (64 bits) runs out, a little before the staged tile would
    outgrow the shared memory a block can have (radius 82)."""
    offs = np.asarray(offsets, np.int64).reshape(-1, 2)
    if (offs[:, 0] < 0).any():
        raise ValueError("K2 takes half-plane band offsets (dx >= 0)")
    r = int(np.abs(offs).max()) if len(offs) else 0
    if r > BAND_R_MAX:
        raise ValueError(
            f"band radius {r} (chunk {(r + 1) // 2}): K2 takes radii up to "
            f"{BAND_R_MAX} (chunk <= 32; a 64-bit offset mask per dy) and a "
            f"staged tile within the {SMEM_LIMIT} bytes (227 KB) of shared "
            f"memory a block can have on an H100 (this one: "
            f"{wide_smem_bytes(r)} bytes)")
    return r


def band_flag_call(px, py, dev, bdev, alive, *,
                   offsets: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Band hit flags ``[W, H]`` (bool) for the half-plane ``offsets``.

    ``px py dev bdev`` are float32 ``[W, H]``, ``alive`` bool, all
    contiguous on one device; ``dev`` is each particle's deviation
    allowance (zero where dead), ``bdev`` the precomputed
    ``base_reach + dev`` (keeping the ``(base + dev_i) + dev_j``
    association of the plain loop).  On CPU tensors the plain version
    runs, for any offsets.  On CUDA tensors the kernel runs on the current
    stream without synchronising: offsets within ``dx ∈ [0, BAND_DX)``,
    ``|dy| ≤ BAND_DY`` (``FarFieldSpec.band_half_offsets`` at chunk ≤ 4)
    through the compile-time box, wider bands (``band_radius``) through
    the box set at launch."""
    global K2_LAUNCHES
    shape = tuple(px.shape)
    if len(shape) != 2:
        raise ValueError(f"planes must be [W, H], got {shape}")
    for name, t in (("px", px), ("py", py), ("dev", dev), ("bdev", bdev)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}")
    if alive.dtype != torch.bool or tuple(alive.shape) != shape:
        raise ValueError(f"alive must be bool {shape}")
    planes = (px, py, dev, bdev, alive)
    devices = {t.device for t in planes}
    if len(devices) != 1:
        raise ValueError(f"planes on several devices: {devices}")
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("planes must be contiguous")
    device = px.device
    if device.type == "cpu":
        return band_flags_plain(px, py, dev, bdev, alive, offsets)
    if device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {device}")
    band_radius(offsets)
    lib = _lib.library()
    out = torch.empty(shape, dtype=torch.bool, device=device)
    offs_c = np.ascontiguousarray(offsets, np.int32).reshape(-1, 2)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sb_band_flags(
            *(t.data_ptr() for t in planes), out.data_ptr(),
            offs_c.ctypes.data, len(offs_c), shape[0], shape[1], stream)
    _lib.check(err, "K2 band_flags")
    K2_LAUNCHES += 1
    return out
