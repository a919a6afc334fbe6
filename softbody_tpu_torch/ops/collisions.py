"""Particle–particle collisions of the general engine: the port of
``softbody_tpu/ops/collisions.py`` (the collision loop of
``compute_update``, compute.wgsl:142-170).

Per live pair ``(i, j)``, reading the previous substep's state:
coincident particles (``dist == 0``) nudge ``p.y`` by ``sign(i − j)``;
overlapping ones (``dist < 2r``) exchange an elastic impulse along the
normal with coefficient ``(elasticity + 1)/2`` and a tangential friction
impulse clamped by WGSL ``clamp`` — ``min(max(x, lo), hi)``, also when
``lo > hi`` — and resolve penetration through ``a −= clip_shift / dt²``.

Three broad phases, one pair math:

- ``allpairs``: the reference's O(N²) loop, in tiles of
  ``cfg.collision_tile`` partners summed tile after tile;
- ``grid``: particles stably sorted by hash cell (cells of side ``2r``),
  each particle's candidates the first ``grid_cell_capacity`` particles
  of the 9 cells around it (a fuller cell drops its later particles:
  ``broad_phase_overflow`` counts them);
- ``window``: blocks of 256 cell-sorted particles against the run of
  sorted rows between their cell rows ±1, capped at ``window_rows``.

The float32 expressions follow the JAX package (true divisions, square
roots through ``stencil.sqrt32``); sums over partners run in torch's
order, so results agree with it to float32 rounding.  Index floats
(``arange(n)`` as float32, as ``_grid`` and ``_window`` carry them) are
exact below 2²⁴ particles.

``query=(pos_q, vel_q, alive_q, idx_q)`` restricts the terms to a subset
of the particles against the full arrays, as the JAX functions do: the
sharded general engine (``parallel/spatial.py``) evaluates each slab
against the gathered world.  ``idx_q`` are the subset's global indices
(self-exclusion and the nudge's order).  ``allpairs`` and ``grid`` take
any subset; ``window`` takes the full set only, as in JAX.
"""

from __future__ import annotations

import functools

import torch

from ..config import PhysicsConstants, StaticConfig, f32
from .stencil import _mul32, device_scalar, f32_to_i32, sqrt32

WINDOW_BLOCK = 256
# the window phase evaluates at most this many pairs per chunk of blocks
_WINDOW_PAIRS = 1 << 24


def collision_terms(pos: torch.Tensor, vel: torch.Tensor,
                    alive: torch.Tensor, consts: PhysicsConstants,
                    cfg: StaticConfig, *, query=None):
    """Dispatch on ``cfg.collision_mode``.  Returns ``(dv [Q, 2], da [Q,
    2], dy [Q])``: the velocity impulse sum, the acceleration
    (penetration) sum and the coincident shift of ``p.y`` of the queried
    particles (``query``, default all ``N``)."""
    if cfg.collision_mode == "none":
        z2 = torch.zeros_like(pos if query is None else query[0])
        return z2, z2.clone(), torch.zeros_like(z2[:, 0])
    if cfg.collision_mode == "allpairs":
        return _allpairs(pos, vel, alive, consts, cfg, query)
    if cfg.collision_mode == "grid":
        return _grid(pos, vel, alive, consts, cfg, query)
    if cfg.collision_mode == "window":
        if query is not None and query[0].shape[0] != pos.shape[0]:
            raise NotImplementedError("window mode supports full-set queries")
        return _window(pos, vel, alive, consts, cfg)
    raise ValueError(cfg.collision_mode)


def _pair_terms(p_i, v_i, p_j, v_j, valid, consts: PhysicsConstants,
                cfg: StaticConfig, idx_i, idx_j):
    """compute.wgsl:150-168 for a batch of candidate pairs.  ``p_i/v_i
    [..., 2]`` broadcast against ``p_j/v_j [..., K, 2]``; ``valid [..., K]``
    masks partners; ``idx_i [...]``, ``idx_j [..., K]`` the indices that
    order the nudge.  Returns the per-pair components ``(dvx, dvy, dax,
    day, dy)``, each ``[..., K]`` (not yet summed over K)."""
    two_r = _mul32(2.0, cfg.particle_radius)
    dt2 = device_scalar(_mul32(cfg.dt, cfg.dt), p_i.device)
    dx = p_j[..., 0] - p_i[..., None, 0]
    dy = p_j[..., 1] - p_i[..., None, 1]
    dist = sqrt32(dx * dx + dy * dy)

    coincident = valid & (dist == 0.0)
    overlap = valid & (dist > 0.0) & (dist < two_r)
    # compute.wgsl:151-153 — deterministic nudge by index order
    nudge = torch.where(coincident, torch.sign(
        idx_i[..., None].to(torch.float32) - idx_j.to(torch.float32)), 0.0)

    safe = torch.where(overlap, dist, 1.0)
    nx = dx / safe
    ny = dy / safe
    tx, ty = -ny, nx
    rvx = v_i[..., None, 0] - v_j[..., 0]
    rvy = v_i[..., None, 1] - v_j[..., 1]
    imp_n = consts.ecoeff * (rvx * nx + rvy * ny)
    max_fric = imp_n * consts.friction
    # WGSL clamp = min(max(x, lo), hi): not symmetric when lo > hi
    imp_t = torch.minimum(torch.maximum(rvx * tx + rvy * ty, -max_fric),
                          max_fric)
    dvx = -(imp_n * nx + imp_t * tx)
    dvy = -(imp_n * ny + imp_t * ty)
    half = (two_r - dist) * 0.5
    dax = -(nx * half) / dt2
    day = -(ny * half) / dt2
    return (torch.where(overlap, dvx, 0.0), torch.where(overlap, dvy, 0.0),
            torch.where(overlap, dax, 0.0), torch.where(overlap, day, 0.0),
            nudge)


def _summed(terms):
    """Per-pair components → ``(dv [..., 2], da [..., 2], dy [...])``."""
    dvx, dvy, dax, day, dy = (t.sum(dim=-1) for t in terms)
    return (torch.stack([dvx, dvy], dim=-1), torch.stack([dax, day], dim=-1),
            dy)


def _allpairs(pos, vel, alive, consts, cfg, query):
    n = pos.shape[0]
    tile = min(cfg.collision_tile, n)
    idx = torch.arange(n, device=pos.device)
    pos_q, vel_q, alive_q, idx_q = (pos, vel, alive, idx) if query is None \
        else query
    dv = torch.zeros_like(pos_q)
    da = torch.zeros_like(pos_q)
    dy = torch.zeros_like(pos_q[:, 0])
    # tiles in order; the last one is short where the JAX scan reads a
    # zero pad (dead partners, which contribute exact zeros)
    for start in range(0, n, tile):
        j = slice(start, min(start + tile, n))
        valid = (alive_q[:, None] & alive[None, j]
                 & (idx_q[:, None] != idx[None, j]))
        tdv, tda, tdy = _summed(_pair_terms(
            pos_q, vel_q, pos[None, j], vel[None, j], valid, consts, cfg,
            idx_q, idx[None, j]))
        dv = dv + tdv
        da = da + tda
        dy = dy + tdy
    return dv, da, dy


@functools.lru_cache(maxsize=None)
def _grid_geometry(bounds: float, radius: float):
    cell = 2.0 * radius
    g = max(1, int(-(-bounds // cell)))
    return cell, g


def _cell_coords(pos, cfg: StaticConfig):
    """Hash cell coordinates ``(cx, cy)`` int64 ``[N]`` and ``g``."""
    cell, g = _grid_geometry(cfg.bounds_size, cfg.particle_radius)
    side = device_scalar(f32(cell), pos.device)

    def coord(x):
        return f32_to_i32(torch.trunc(x / side)).to(torch.int64).clamp(
            0, g - 1)

    return coord(pos[:, 0]), coord(pos[:, 1]), g


def _sorted_cells(pos, alive, cfg: StaticConfig):
    """Cell ids (dead particles in the pad cell ``g²``), the stable sort
    order and the sorted ids."""
    cx, cy, g = _cell_coords(pos, cfg)
    cid = torch.where(alive, cx * g + cy, g * g)
    sorted_cid, order = torch.sort(cid, stable=True)
    return cx, cy, g, order, sorted_cid


def _packed_table(pos, vel, alive):
    """``[N, 8]`` rows: pos, vel, alive, index (float32), 2 zeros."""
    n = pos.shape[0]
    return torch.cat([
        pos, vel, alive.to(torch.float32)[:, None],
        torch.arange(n, dtype=torch.float32, device=pos.device)[:, None],
        torch.zeros((n, 2), dtype=torch.float32, device=pos.device)], dim=1)


def build_grid(pos, alive, cfg: StaticConfig):
    """Cell list by a stable sort: ``(order [N]`` particle indices sorted
    by cell, ``starts [g²+2]`` per-cell offsets into ``order``, overflow
    — the live particles past ``grid_cell_capacity`` in their cell)."""
    _cx, _cy, g, order, sorted_cid = _sorted_cells(pos, alive, cfg)
    starts = torch.searchsorted(
        sorted_cid, torch.arange(g * g + 2, device=pos.device))
    counts = starts[1:-1] - starts[:-2]
    overflow = torch.clamp(counts - cfg.grid_cell_capacity, min=0).sum()
    return order, starts, overflow


def _grid(pos, vel, alive, consts, cfg, query):
    n = pos.shape[0]
    k = cfg.grid_cell_capacity
    dev = pos.device
    pos_q, vel_q, alive_q, idx_q = (
        (pos, vel, alive, torch.arange(n, device=dev)) if query is None
        else query)
    q = pos_q.shape[0]
    order, starts, _ = build_grid(pos, alive, cfg)
    cx, cy, g = _cell_coords(pos_q, cfg)
    # the 3 x 3 neighbour cells, dx-major (built on the device: a copy
    # from the host would wait for the stream)
    step3 = torch.arange(-1, 2, device=dev)
    nx = cx[:, None] + step3.repeat_interleave(3)[None, :]
    ny = cy[:, None] + step3.repeat(3)[None, :]
    in_range = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
    ncell = torch.where(in_range, nx * g + ny, g * g)      # empty pad cell

    table_sorted = _packed_table(pos, vel, alive)[order]
    c_start = starts[ncell]                                 # [Q, 9]
    c_count = torch.clamp(starts[ncell + 1] - c_start, max=k)
    slot = torch.arange(k, device=dev)
    cand = c_start[..., None] + slot                        # [Q, 9, K]
    in_cell = (slot < c_count[..., None]).reshape(q, 9 * k)
    rows = table_sorted[cand.reshape(q, 9 * k).clamp(0, n - 1)]
    cand_idx = rows[..., 5].to(torch.int64)
    valid = (in_cell & (rows[..., 4] > 0.0) & (cand_idx != idx_q[:, None])
             & alive_q[:, None])
    return _summed(_pair_terms(pos_q, vel_q, rows[..., 0:2], rows[..., 2:4],
                               valid, consts, cfg, idx_q, cand_idx))


def _window_bounds(sorted_cid, g: int, n: int, wrows: int):
    """Per 256-block ``(win_lo, win_hi)`` sorted-row bounds (the cell rows
    of the block ±1) and the rows cut by the ``wrows`` cap."""
    dev = sorted_cid.device
    row_starts = torch.searchsorted(
        sorted_cid, torch.arange(g + 2, device=dev) * g)
    nb = -(-n // WINDOW_BLOCK)
    npad = nb * WINDOW_BLOCK
    scx = torch.zeros(npad, dtype=torch.int64, device=dev)
    scx[:n] = torch.clamp(torch.div(sorted_cid, g, rounding_mode="floor"),
                          0, g - 1)
    # dead and pad rows sort last: give pad rows the last real row's cell
    scx[n:] = scx[n - 1]
    blocks = scx.reshape(nb, WINDOW_BLOCK)
    win_lo = row_starts[torch.clamp(blocks.amin(dim=1) - 1, min=0)]
    win_hi = row_starts[torch.clamp(blocks.amax(dim=1) + 2, max=g + 1)]
    overflow = torch.clamp(win_hi - win_lo - wrows, min=0).sum()
    return win_lo, win_hi, overflow


def _window(pos, vel, alive, consts, cfg):
    n = pos.shape[0]
    dev = pos.device
    bsz = WINDOW_BLOCK
    wrows = cfg.window_rows
    _cx, _cy, g, order, sorted_cid = _sorted_cells(pos, alive, cfg)
    win_lo, win_hi, _ = _window_bounds(sorted_cid, g, n, wrows)
    nb = win_lo.shape[0]
    table_sorted = _packed_table(pos, vel, alive)[order]
    # the blocks' rows, then wrows zero rows so every window is in range
    table_win = torch.zeros((nb * bsz + wrows, 8), dtype=torch.float32,
                            device=dev)
    table_win[:n] = table_sorted
    step = max(1, _WINDOW_PAIRS // (bsz * wrows))
    lane = torch.arange(wrows, device=dev)
    parts = []
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        blk = table_win[b0 * bsz:b1 * bsz].reshape(b1 - b0, bsz, 8)
        wi = win_lo[b0:b1, None] + lane                    # [nbc, wrows]
        win = table_win[wi][:, None]                       # [nbc, 1, W, 8]
        i_idx = blk[..., 5].to(torch.int64)
        j_idx = win[..., 5].to(torch.int64)
        valid = ((blk[..., 4] > 0.0)[..., None] & (win[..., 4] > 0.0)
                 & (wi < win_hi[b0:b1, None])[:, None]
                 & (i_idx[..., None] != j_idx))
        parts.append(_summed(_pair_terms(
            blk[..., 0:2], blk[..., 2:4], win[..., 0:2], win[..., 2:4],
            valid, consts, cfg, i_idx, j_idx)))
    dv, da, dy = (torch.cat([p[i] for p in parts]).reshape(
        (nb * bsz,) + parts[0][i].shape[2:])[:n] for i in range(3))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return dv[inv], da[inv], dy[inv]


def broad_phase_overflow(pos, alive, cfg: StaticConfig) -> torch.Tensor:
    """The broad phase's current truncation count (0-d tensor on the
    device): ``grid`` — live particles past ``grid_cell_capacity`` in
    their cell; ``window`` — sorted-window rows past ``window_rows``
    across the 256-particle blocks; other modes 0."""
    if cfg.collision_mode == "grid":
        return build_grid(pos, alive, cfg)[2]
    if cfg.collision_mode != "window":
        return torch.zeros((), dtype=torch.int64, device=pos.device)
    _cx, _cy, g, _order, sorted_cid = _sorted_cells(pos, alive, cfg)
    return _window_bounds(sorted_cid, g, pos.shape[0], cfg.window_rows)[2]
