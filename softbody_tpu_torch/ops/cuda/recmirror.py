"""The record kernels K5, K6 and K7: the port of the three Pallas
kernels of ``scripts/probe_recmirror.py``.

- K5 ``cast_rows_call``: ``[rows, 128] → [4·rows, 32]`` (``cast_kernel``);
- K6 ``uncast_rows_call``: the inverse (``inv_kernel``);
- K7 ``mirror_records_call``: five ``[W, H]`` planes (px py vx vy alive)
  → the far apply's record table (``mirror_kernel``, the semantics of
  ``softbody_tpu/ops/farfield4.py::mirror_table``) of lane block ``mb``,
  any multiple of 32 (the probe's kernel writes mb = 32; JAX's
  ``far_mb`` picks others).

Each wrapper launches its hand-written kernel (``csrc/recmirror.cu``) on
CUDA tensors and runs its plain version on CPU tensors.  K5 and K6 are
copies of the same bytes on a row-major card.  K7 is the far apply's
relayout (``ops/farfield4.py``) where the record table runs on the card:
under an explicit lane block (``far_mb`` / ``far_mb_out``).  The card's
default layout takes K8 (``far_apply.py``), which reads the planes
directly; the CPU keeps the table's plain route."""

from __future__ import annotations

from typing import Sequence

import torch

from . import _lib

MB = 32           # lanes per record block (the default lane block)
RX = 4            # plane rows per record
NF = 5            # px py vx vy alive

# launches of the CUDA kernels (the plain versions do not count)
K5_LAUNCHES = 0
K6_LAUNCHES = 0
K7_LAUNCHES = 0


def cast_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """``[rows, 128] → [4·rows, 32]``, a new tensor."""
    return x.reshape(4 * x.shape[0], 32).clone()


def uncast_rows_plain(y: torch.Tensor) -> torch.Tensor:
    """``[4·rows, 32] → [rows, 128]``, a new tensor."""
    return y.reshape(y.shape[0] // 4, 128).clone()


def _check_float(name, t, shape=None):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _copy_call(x: torch.Tensor, rows: int, out_shape, cast: bool):
    """K5 (``cast``) or K6 on a CUDA tensor."""
    global K5_LAUNCHES, K6_LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"no K5/K6 kernel for device {device}")
    if x.data_ptr() % 16:
        raise ValueError("K5/K6 read 16-byte aligned tensors")
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if rows == 0:
        return out
    lib = _lib.library()
    fn = lib.sb_cast_rows if cast else lib.sb_uncast_rows
    with torch.cuda.device(device):
        err = fn(x.data_ptr(), out.data_ptr(), rows, _stream(device))
    _lib.check(err, "K5 cast_rows" if cast else "K6 uncast_rows")
    if cast:
        K5_LAUNCHES += 1
    else:
        K6_LAUNCHES += 1
    return out


def cast_rows_call(x: torch.Tensor) -> torch.Tensor:
    """K5: ``x [rows, 128]`` float32 contiguous → ``[4·rows, 32]``."""
    if x.dim() != 2 or x.shape[1] != 128:
        raise ValueError(f"x must be [rows, 128], got {tuple(x.shape)}")
    _check_float("x", x)
    if x.device.type == "cpu":
        return cast_rows_plain(x)
    return _copy_call(x, x.shape[0], (4 * x.shape[0], 32), cast=True)


def uncast_rows_call(y: torch.Tensor) -> torch.Tensor:
    """K6: ``y [4·rows, 32]`` float32 contiguous → ``[rows, 128]``."""
    if y.dim() != 2 or y.shape[1] != 32 or y.shape[0] % 4:
        raise ValueError(f"y must be [4·rows, 32], got {tuple(y.shape)}")
    _check_float("y", y)
    if y.device.type == "cpu":
        return uncast_rows_plain(y)
    rows = y.shape[0] // 4
    return _copy_call(y, rows, (rows, 128), cast=False)


def mirror_records_plain(planes: Sequence[torch.Tensor], *, w_out: int,
                         h_out: int, mb: int = MB) -> torch.Tensor:
    """Five ``[W, H]`` planes → ``[(h_out/mb)·(w_out/4), 20·mb]``: stack,
    zero-pad to ``[5, w_out, h_out]``, ``(f, cx, ix, b, l) → (b, cx, f,
    ix, l)`` (``softbody_tpu/ops/farfield4.py:76-84``)."""
    stack = torch.stack(tuple(planes))
    _, w, h = stack.shape
    padded = stack.new_zeros((NF, w_out, h_out))
    padded[:, :w, :h] = stack
    nb, cw = h_out // mb, w_out // RX
    t = padded.reshape(NF, cw, RX, nb, mb).permute(3, 1, 0, 2, 4)
    return t.reshape(nb * cw, NF * RX * mb)


def mirror_records_call(planes: Sequence[torch.Tensor], *, w_out: int,
                        h_out: int, mb: int = MB) -> torch.Tensor:
    """K7: the record table of five float32 contiguous ``[W, H]`` planes
    (px, py, vx, vy, alive as 0/1) zero-padded to ``[w_out, h_out]``
    (``w_out % 4 == 0``, ``h_out % mb == 0``), lane block ``mb`` a
    positive multiple of 32.  Record row ``b·(w_out/4) + cx``, lane
    ``f·4mb + ix·mb + l`` holds plane ``f`` at ``(4cx + ix, mb·b + l)``.
    On CUDA tensors the kernel runs on the current stream without
    synchronising."""
    global K7_LAUNCHES
    planes = tuple(planes)
    if len(planes) != NF:
        raise ValueError(f"need {NF} planes, got {len(planes)}")
    if planes[0].dim() != 2:
        raise ValueError(f"planes must be [W, H], got "
                         f"{tuple(planes[0].shape)}")
    w, h = planes[0].shape
    for i, p in enumerate(planes):
        _check_float(f"plane {i}", p, (w, h))
    if len({p.device for p in planes}) != 1:
        raise ValueError("planes on several devices")
    if mb <= 0 or mb % MB:
        raise ValueError(f"the record lane block must be a positive "
                         f"multiple of {MB}, got {mb}")
    if (w_out < w or h_out < h or w_out % RX or h_out % mb
            or max(w_out, h_out) >= 2 ** 31):
        raise ValueError(f"cannot pad [{w}, {h}] to [{w_out}, {h_out}] "
                         f"(w_out % {RX} == 0, h_out % {mb} == 0)")
    device = planes[0].device
    if device.type == "cpu":
        return mirror_records_plain(planes, w_out=w_out, h_out=h_out, mb=mb)
    if device.type != "cuda":
        raise ValueError(f"no K7 kernel for device {device}")
    out = torch.empty(((h_out // mb) * (w_out // RX), NF * RX * mb),
                      dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(device):
        err = lib.sb_mirror_records(*(p.data_ptr() for p in planes),
                                    out.data_ptr(), w, h, w_out, h_out, mb,
                                    _stream(device))
    _lib.check(err, "K7 mirror_records")
    K7_LAUNCHES += 1
    return out
