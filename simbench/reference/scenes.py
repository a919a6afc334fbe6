"""The benchmark's scenes, built by the reference itself from a
configuration's sizes and the run's seed, as flat :class:`World` s.

They follow the published scene descriptions (BASELINE.json configs 3
and 5): a dense spring lattice with its four beam classes (vertical,
horizontal and both diagonals), the tearing sheet's slits, and the
seed's velocity jitter.  The particle order is the lattice's column-major
index ``x·H + y``; the tearing sheet's beams are laid out as four class
planes ``[4, W, H]`` (the beam from ``(x, y)`` to ``(x + dx, y + dy)``,
dead where the partner lies outside), the cloth's as a list of its
existing beams, class by class."""

from __future__ import annotations

import math

import torch

from .physics import Consts, World

CLASS_OFFSETS = ((0, 1), (1, 0), (1, 1), (1, -1))


def f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def velocity_jitter(shape, sigma: float, seed: int, device) -> torch.Tensor:
    """The seed's velocity jitter ``[*shape, 2]``: normal draws from a
    generator on ``device`` scaled by ``sigma``.  The benchmark adds the
    same draws to the program's initial velocities."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((*shape, 2), generator=g, device=device) * sigma


def _grid_positions(w: int, h: int, spacing: float, ox: float, oy: float,
                    device):
    xs = torch.arange(w, dtype=torch.float32, device=device) * spacing + ox
    ys = torch.arange(h, dtype=torch.float32, device=device) * spacing + oy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([gx, gy], -1)


def tearing_sheet(p: dict, seed: int, device):
    """BASELINE config 5's sheet: ``(World, Consts, (W, H), spacing)``.

    ``p``: ``n_particles``, ``spring``, ``damp``, ``strain_limit``,
    ``yield_strain``, ``fall_speed``, ``slits``, ``jitter`` (the
    velocity jitter's sigma), ``subticks``, ``bounds``, ``gravity`` (per
    ten spacings) and ``radius_scale`` (the contact radius per
    spacing)."""
    side = int(math.sqrt(p["n_particles"]))
    w = h = side
    spacing = 980.0 / (side - 1)
    pos = _grid_positions(w, h, spacing, 10.0, 10.0, device).reshape(-1, 2)
    x = torch.arange(w, device=device)[:, None].expand(w, h)
    y = torch.arange(h, device=device)[None, :].expand(w, h)
    lin = (x * h + y).reshape(-1)
    a, b, length, alive = [], [], [], []
    for ci, (dx, dy) in enumerate(CLASS_OFFSETS):
        inside = (x + dx < w) & (y + dy >= 0) & (y + dy < h)
        live = inside.clone()
        for si in range(p["slits"]):
            cx = (si + 1) * w // (p["slits"] + 1)
            lo, hi = ((0, int(0.85 * h)) if si % 2 == 0
                      else (int(0.15 * h), h))
            if dx != 0:
                live[cx, lo:hi] = False
        partner = torch.where(inside, (x + dx) * h + (y + dy), x * h + y)
        a.append(lin)
        b.append(partner.reshape(-1))
        length.append(torch.full((w * h,), f32(spacing * math.hypot(dx, dy)),
                                 device=device))
        alive.append(live.reshape(-1))
    length = torch.cat(length)
    m = length.shape[0]

    def full(v):
        return torch.full((m,), f32(v), device=device)

    vel = torch.zeros((w, h, 2), device=device)
    vel[..., 1] = -p["fall_speed"]
    vel = vel + velocity_jitter((w, h), p["jitter"], seed, device)
    world = World(
        pos=pos, vel=vel.reshape(-1, 2),
        acc=torch.zeros((w * h, 2), device=device),
        alive=torch.ones(w * h, dtype=torch.bool, device=device),
        pinned=torch.zeros(w * h, dtype=torch.bool, device=device),
        lin=lin, a=torch.cat(a), b=torch.cat(b), length=length,
        target=length.clone(), last=length.clone(), spring=full(p["spring"]),
        damp=full(p["damp"]), yield_strain=full(p["yield_strain"]),
        strain_limit=full(p["strain_limit"]), beam_alive=torch.cat(alive))
    consts = Consts(
        radius=f32(spacing * p["radius_scale"]), dt=1.0 / p["subticks"],
        bounds=p["bounds"], gravity=(0.0, f32(p["gravity"] * spacing / 10.0)),
        border_elasticity=0.5, border_friction=0.2, elasticity=0.5,
        friction=0.1, drag_coeff=0.001, drag_exp=2.0,
        subticks=p["subticks"])
    return world, consts, (w, h), spacing


def cloth_sheet(p: dict, seed: int, device):
    """BASELINE config 3's cloth: ``(World, Consts, (W, H), spacing)``.

    ``p``: ``n_particles``, ``spring``, ``damp``, ``yield_strain``,
    ``strain_limit``, ``origin`` ``[x, y]``, ``jitter``, ``subticks``,
    ``bounds``, ``radius_scale``.  Beams are listed vertical, horizontal,
    diagonal, anti-diagonal, each in particle order."""
    n = p["n_particles"]
    w = int(math.sqrt(n * 4))
    h = max(2, n // w)
    spacing = 900.0 / max(w - 1, 1)
    ox, oy = p["origin"]
    pos = _grid_positions(w, h, spacing, ox, oy, device).reshape(-1, 2)
    x = torch.arange(w, device=device)[:, None].expand(w, h).reshape(-1)
    y = torch.arange(h, device=device)[None, :].expand(w, h).reshape(-1)
    base = x * h + y
    sq2 = math.sqrt(2.0) * spacing
    a, b, length = [], [], []
    for keep, step, ln in ((y < h - 1, 1, spacing), (x < w - 1, h, spacing),
                           ((y < h - 1) & (x < w - 1), h + 1, sq2),
                           ((y > 0) & (x < w - 1), h - 1, sq2)):
        a.append(base[keep])
        b.append(base[keep] + step)
        length.append(torch.full((int(keep.sum()),), f32(ln), device=device))
    length = torch.cat(length)
    m = length.shape[0]

    def full(v):
        return torch.full((m,), f32(v), device=device)

    vel = velocity_jitter((w * h,), p["jitter"], seed, device)
    world = World(
        pos=pos, vel=torch.zeros((w * h, 2), device=device) + vel,
        acc=torch.zeros((w * h, 2), device=device),
        alive=torch.ones(w * h, dtype=torch.bool, device=device),
        pinned=torch.zeros(w * h, dtype=torch.bool, device=device),
        lin=base, a=torch.cat(a).long(), b=torch.cat(b).long(),
        length=length, target=length.clone(), last=length.clone(),
        spring=full(p["spring"]), damp=full(p["damp"]),
        yield_strain=full(p["yield_strain"]),
        strain_limit=full(p["strain_limit"]),
        beam_alive=torch.ones(m, dtype=torch.bool, device=device))
    consts = Consts(
        radius=f32(spacing * p["radius_scale"]), dt=1.0 / p["subticks"],
        bounds=p["bounds"], gravity=(0.0, -0.5), border_elasticity=0.5,
        border_friction=0.2, elasticity=0.5, friction=0.1, drag_coeff=0.001,
        drag_exp=2.0, subticks=p["subticks"])
    return world, consts, (w, h), spacing
