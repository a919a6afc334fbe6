"""Body forces, semi-implicit Euler integration and the border of the
general engine: the port of ``softbody_tpu/ops/integrate.py`` (the tail
of ``compute_update``, compute.wgsl:171-199).

The flat ``[N, 2]`` arrays are split into component columns and stepped
by the lattice path's ``stencil._integrate_components``: the same
float32 operations in the same order as the JAX package's flat
integrator (gravity, power-law drag on the post-collision velocity,
keyboard force, mouse grab, the beam forces, ``v += a·dt; p += v·dt``,
the x-then-y border clamp with its carried friction acceleration)."""

from __future__ import annotations

import torch

from typing import Optional

from ..config import PhysicsConstants, StaticConfig, UserInput
from .stencil import Scalars, _integrate_components, frame_scalars


def integrate_particles(pos, vel, acc, alive, pinned, coll_dv, coll_da,
                        coll_dy, beam_force, consts: PhysicsConstants,
                        uin: UserInput, cfg: StaticConfig,
                        scalars: Optional[Scalars] = None):
    """Returns the updated ``(pos, vel, acc)`` ``[N, 2]``; dead and pinned
    particles pass through unchanged.  ``scalars``: the consts vector's
    :class:`~.stencil.Scalars` on the state's device where the caller has
    them (a frame forms them once), else formed here."""
    sc = (frame_scalars(consts, uin, cfg, 0, pos.device) if scalars is None
          else scalars)
    px, py, vx, vy, ax, ay = _integrate_components(
        pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], acc[:, 0], acc[:, 1],
        alive, pinned, coll_dv[:, 0], coll_dv[:, 1], coll_da[:, 0],
        coll_da[:, 1], coll_dy, beam_force[:, 0], beam_force[:, 1], sc)
    return (torch.stack([px, py], dim=-1), torch.stack([vx, vy], dim=-1),
            torch.stack([ax, ay], dim=-1))
