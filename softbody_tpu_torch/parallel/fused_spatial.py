"""Spatial sharding of the per-edge fused substep (kernel K4) with a halo
exchange of the packed stacks: the port of
``softbody_tpu/parallel/fused_spatial.py``.

A shard's slab is its own contiguous stack ``[planes, ghost + w_loc +
ghost, H]``: the ghost ring is part of the stack (the JAX package's
``PAD_W`` margin, which is Mosaic layout there), so K4 runs on the slab
through its ordinary entry.

- At pack time each slab is cut from the global stacks with its ghost
  columns, so the ring holds the neighbours' true data; ``immut`` (alive,
  pinned, the edge parameters) never changes within a frame, so it is
  exchanged only then.
- Each substep every shard writes its neighbours' ``hx = max(1,
  stencil)`` edge columns of ``mut`` into its ghosts (``ppermute``); a
  world-edge shard gets zeros (dead particles, the dense path's border)
  written again on its outer side.  The kernel writes every column of its
  stack, ghosts included, so they would go stale otherwise.  Then K4
  runs on the slab.

The spring sums are exact and every term of a cell is evaluated from the
same values in the same order, so a sharded frame equals the
single-device ``fused_frame`` bit for bit.  Sharded stacks are lists,
shard ``j``'s on its device; ``pack_lattice_sharded`` returns them
stacked on the state's device and :func:`shard_stacks` places them.

The JAX package's ``tile_w`` (its slab width must be a multiple) is
Mosaic layout: accepted and ignored, as ``LatticeEngine`` does.  The
frame writes its input ``mut`` stacks' ghost columns in place (the JAX
function donates them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..config import PhysicsConstants, StaticConfig, UserInput, consts_vector
from ..ops.cuda.fused_substep import (
    fused_substep_call,
    pack_lattice,
    unpack_lattice,
)
from ..ops.stencil import LatticeSpec, LatticeState, check_reference_offsets
from .mesh import Mesh, ppermute

# the ghost ring of the pack functions by default: the JAX package's
# PAD_W margin, wide enough for stencils up to 8 and for the far field's
# 2·chunk at chunk 4
GHOST = 8


def ghost_width(spec: LatticeSpec, ffspec=None) -> int:
    """The least ghost ring a sharded frame needs: the stencil's reach
    ``max(1, s)``; with the far field armed, at least ``2·chunk`` (band
    detection reads ``2·chunk − 1`` columns away), in whole chunks."""
    hx = max(1, spec.collision_stencil)
    if ffspec is None:
        return hx
    c = ffspec.chunk
    return -(-max(2 * c, hx) // c) * c


def slab_windows(stack: torch.Tensor, n_dev: int, ghost: int
                 ) -> torch.Tensor:
    """``[P, W, H]`` → ``[n_dev, P, W/n + 2·ghost, H]``: each slab with
    ``ghost`` columns of its neighbours on each side (zeros past the
    world's edges)."""
    w = stack.shape[1]
    w_loc = w // n_dev
    p = torch.nn.functional.pad(stack, (0, 0, ghost, ghost))
    return torch.stack([p[:, d * w_loc:d * w_loc + w_loc + 2 * ghost]
                        for d in range(n_dev)])


def check_slabs(w: int, n_dev: int) -> int:
    if w % n_dev:
        raise ValueError(f"W={w} not divisible by {n_dev} devices")
    return w // n_dev


def pack_lattice_sharded(
    state: LatticeState,
    n_dev: int,
    tile_w: int = 128,
    *,
    ghost: int = GHOST,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """LatticeState → per-shard stacks with authentic ghost rings:
    ``(mut [n, 26, w_loc + 2·ghost, H], immut [n, 22, …], w_loc)``."""
    w_loc = check_slabs(state.shape[0], n_dev)
    mut, immut = pack_lattice(state)
    return (slab_windows(mut, n_dev, ghost),
            slab_windows(immut, n_dev, ghost), w_loc)


def interiors(stacks: Sequence[torch.Tensor], w_loc: int, device
              ) -> torch.Tensor:
    """The slabs' interiors side by side: ``[P, W, H]`` on ``device``."""
    ring = (stacks[0].shape[-2] - w_loc) // 2
    return torch.cat([s[:, ring:ring + w_loc].to(device) for s in stacks],
                     dim=1)


def unpack_lattice_sharded(mut_sh, template: LatticeState, n_dev: int,
                           w_loc: int) -> LatticeState:
    """Per-shard stacks (a list or one stacked tensor) → LatticeState
    (interiors concatenated) on ``template``'s device."""
    core = interiors([mut_sh[d] for d in range(n_dev)], w_loc,
                     template.device)
    return unpack_lattice(core, None, template)


def shard_stacks(mut_sh, immut_sh, mesh: Mesh, *, sp_axis: str = "sp"
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Place each shard's stacks on its device of ``mesh[sp_axis]``."""
    devs = mesh.axis_devices(sp_axis)
    return ([mut_sh[j].to(d).contiguous() for j, d in enumerate(devs)],
            [immut_sh[j].to(d).contiguous() for j, d in enumerate(devs)])


def exchange(stacks: List[torch.Tensor], hx: int, w_loc: int,
             perms) -> None:
    """Write each shard's neighbours' ``hx`` edge columns into its ghost
    columns, in place (zeros at the world's edges)."""
    fwd, bwd = perms
    ring = (stacks[0].shape[1] - w_loc) // 2
    lo, hi = ring, ring + w_loc
    from_l = ppermute([m[:, hi - hx:hi] for m in stacks], fwd)
    from_r = ppermute([m[:, lo:lo + hx] for m in stacks], bwd)
    for m, fl, fr in zip(stacks, from_l, from_r):
        m[:, lo - hx:lo] = fl
        m[:, hi:hi + hx] = fr


def neighbour_perms(n_dev: int):
    return ([(i, i + 1) for i in range(n_dev - 1)],
            [(i + 1, i) for i in range(n_dev - 1)])


def check_ring(stacks: Sequence[torch.Tensor], w_loc: int, hx: int,
               n_dev: int) -> int:
    """The stacks' ghost ring, after checking the shard count and that
    it covers ``hx``."""
    if len(stacks) != n_dev:
        raise ValueError(f"{len(stacks)} slabs for {n_dev} shards")
    ring = (stacks[0].shape[-2] - w_loc) // 2
    if ring < 0 or stacks[0].shape[-2] != w_loc + 2 * ring:
        raise ValueError(f"slab of {stacks[0].shape[-2]} columns for "
                         f"{w_loc} and a ghost ring")
    if hx > ring:
        raise ValueError(f"stencil reach {hx} exceeds margin {ring}")
    return ring


def fused_spatial_frame_fn(
    spec: LatticeSpec,
    cfg: StaticConfig,
    mesh: Mesh,
    *,
    sp_axis: str = "sp",
    tile_w: int = 128,
):
    """A frame step over the stacks of :func:`shard_stacks`:
    ``fn(mut_sh, immut_sh, consts, uin) → mut_sh``."""
    check_reference_offsets(spec)
    n_dev = mesh.shape[sp_axis]
    w_loc = check_slabs(spec.width, n_dev)
    hx = max(1, spec.collision_stencil)
    if w_loc < 2 * hx:
        raise ValueError("slab too narrow for the ghost ring")
    quantized = cfg.force_mode == "quantized"
    stencil = 0 if cfg.collision_mode == "none" else spec.collision_stencil
    perms = neighbour_perms(n_dev)

    def fn(mut_sh: Sequence[torch.Tensor], immut_sh: Sequence[torch.Tensor],
           consts: PhysicsConstants, uin: UserInput) -> List[torch.Tensor]:
        check_ring(mut_sh, w_loc, hx, n_dev)
        cvec = consts_vector(consts, uin, cfg, spec.height)
        ms = list(mut_sh)
        for _ in range(cfg.subticks):
            exchange(ms, hx, w_loc, perms)
            ms = [fused_substep_call(m, im, cvec, stencil=stencil,
                                     quantized=quantized)
                  for m, im in zip(ms, immut_sh)]
        return ms

    return fn
