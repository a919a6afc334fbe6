"""Bucketed far-pair apply: the semantics of
``softbody_tpu/ops/farfield4.py::bucketed_far_delta_planes``.

The candidate list is cropped to the smallest capacity bucket ≥
``n_pairs`` (so a light frame does not pay for the full capacity) and
applied through the windowed gather → pair math → ``index_add_``
scatter of ``ops/farfield.py``.  The JAX package's (4, 32)-record mirror
table exists only for the TPU's memory layout and is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .farfield import FarFieldSpec, FarList, crop_far_list, far_collision_terms

PX, PY, VX, VY = range(4)


def bucket_capacity(n_pairs: int, ff: FarFieldSpec,
                    buckets: Tuple[int, ...]) -> int:
    """Smallest bucket ≥ ``n_pairs`` (the list's capacity caps it)."""
    ladder = tuple(b for b in buckets if b < ff.max_pairs) + (ff.max_pairs,)
    return next(b for b in ladder if b >= min(n_pairs, ff.max_pairs))


def bucketed_far_delta_planes(hot: torch.Tensor, alive_f: torch.Tensor,
                              fl: FarList, n_pairs: int, *, s: int,
                              ff: FarFieldSpec, radius: float, dt: float,
                              ecoeff: float, friction: float,
                              buckets: Tuple[int, ...] = (1024, 4096),
                              ) -> Optional[torch.Tensor]:
    """Far delta planes ``[5, W, H]`` (dvx dvy dax day dyn) for the packed
    state ``hot`` (px py vx vy at planes 0-3) and the float alive plane,
    or None when the list is empty.  ``n_pairs`` is ``fl.n_pairs`` read
    on the host once per rebuild: eager torch picks the bucket there, as
    ``lax.switch`` did on the device."""
    if n_pairs == 0:
        return None
    flk = crop_far_list(fl, bucket_capacity(n_pairs, ff, buckets))
    terms = far_collision_terms(
        hot[PX], hot[PY], hot[VX], hot[VY], alive_f > 0.0, flk, s=s, ff=ff,
        radius=radius, dt=dt, ecoeff=ecoeff, friction=friction)
    return torch.stack(terms)
