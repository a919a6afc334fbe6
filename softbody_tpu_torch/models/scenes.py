"""Scene families of the general engine (port of
``softbody_tpu/models/scenes.py``): the reference demo scene plus the
five BASELINE.json benchmark configurations, built in numpy exactly as
the JAX package builds them and moved to ``device`` once (default: the
CUDA device; ``config.resolve_device``).  Each returns ``(SimState,
StaticConfig)``.

- ``default_scene`` ≙ the reference's built-in world (main.ts:188-253):
  mixed stiff/soft cubes, a plank, free particles.
- ``cloth`` — config 1: W×H spring-mass cloth under gravity.
- ``blob`` — config 2: triangulated disk with pinned anchors.
- ``self_colliding_cloth`` — config 3: 100k-particle cloth, grid
  broad-phase self-collision.
- ``multi_blob`` — config 4: 64 soft blobs with blob–blob contact.
- ``tearing_cloth`` — config 5: 1M particles / 4M springs, breakage.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..config import StaticConfig
from ..state import SimState, state_from_numpy
from .lattice import lattice_arrays, merge_scenes


def _free_particles(points) -> tuple:
    pos = np.asarray(points, np.float32).reshape(-1, 2)
    return (
        pos,
        np.zeros((0, 2), np.int32),
        np.zeros((0,), np.float32),
        {k: np.zeros((0,), np.float32)
         for k in ("spring", "damp", "yield_strain", "strain_limit")},
    )


def _build(pos, beams, lengths, props, *, pinned=None, vel=None,
           max_particles=None, max_beams=None, device=None) -> SimState:
    return state_from_numpy(
        pos, vel,
        beams=beams if len(beams) else None,
        beam_length=lengths,
        beam_spring=props["spring"], beam_damp=props["damp"],
        beam_yield_strain=props["yield_strain"],
        beam_strain_limit=props["strain_limit"],
        pinned=pinned,
        max_particles=max_particles, max_beams=max_beams, device=device,
    )


def default_scene(max_particles: Optional[int] = None,
                  max_beams: Optional[int] = None, *,
                  device=None) -> Tuple[SimState, StaticConfig]:
    """The reference's default world: two bouncy cubes, a soft 9×4 slab,
    two free particles, a long stiff plank, a 5×5 jelly block, and two
    very soft 2×2 blobs (parameters from main.ts:218-246)."""
    scene = merge_scenes(
        lattice_arrays(185, 10, 60, 2, 2, 1, 50, 1, 2.5),
        lattice_arrays(35, 10, 60, 2, 2, 1, 50, 1, 2.5),
        lattice_arrays(20, 120, 30, 9, 4, 50, 700, 0.2, 0.5),
        _free_particles([[445.0, 10.0], [925.0, 10.0]]),
        lattice_arrays(400, 40, 30, 20, 2, 500, 800, 0.1, 0.5),
        lattice_arrays(700, 400, 40, 5, 5, 3, 50, 2, 5),
        lattice_arrays(20, 900, 50, 2, 2, 0.05, 10, 2, 3),
        lattice_arrays(20, 700, 50, 2, 2, 0.1, 10, 2, 3),
    )
    state = _build(*scene, max_particles=max_particles, max_beams=max_beams,
                   device=device)
    cfg = StaticConfig(subticks=64, collision_mode="allpairs")
    return state, cfg


def cloth(w: int = 32, h: int = 32, spacing: float = 20.0,
          spring: float = 50.0, damp: float = 10.0,
          pin_top: bool = False, *,
          device=None) -> Tuple[SimState, StaticConfig]:
    """Config 1: spring-mass cloth grid, gravity + ground plane."""
    ox = 500.0 - (w - 1) * spacing / 2
    oy = 980.0 - (h - 1) * spacing
    pos, beams, lengths, props = lattice_arrays(
        ox, oy, spacing, w, h, spring, damp, 1.0, 2.5
    )
    pinned = None
    if pin_top:
        pinned = np.zeros(pos.shape[0], bool)
        pinned[pos[:, 1] >= oy + (h - 1) * spacing - 1e-3] = True
    state = _build(pos, beams, lengths, props, pinned=pinned, device=device)
    cfg = StaticConfig(
        subticks=64,
        collision_mode="allpairs" if w * h <= 4096 else "grid",
        particle_radius=min(10.0, spacing * 0.45),
    )
    return state, cfg


def _disk_points(cx: float, cy: float, radius: float, spacing: float):
    """Hex-packed points filling a disk."""
    pts = []
    row_h = spacing * math.sqrt(3) / 2
    n_rows = int(radius / row_h)
    for row in range(-n_rows, n_rows + 1):
        y = cy + row * row_h
        x_off = (row % 2) * spacing / 2
        half_w = math.sqrt(max(radius**2 - (row * row_h) ** 2, 0.0))
        n_cols = int(half_w / spacing)
        for col in range(-n_cols, n_cols + 1):
            pts.append([cx + col * spacing + x_off, y])
    return np.array(pts, np.float32)


def _triangulate(pos: np.ndarray, cutoff: float):
    """Beams between all point pairs within cutoff (the editor's
    auto-triangulation idea, editor.ts:339-343, applied globally)."""
    n = pos.shape[0]
    d = pos[None] - pos[:, None]
    dist = np.sqrt((d * d).sum(-1))
    i, j = np.nonzero((dist > 1e-6) & (dist <= cutoff))
    keep = i < j
    beams = np.stack([i[keep], j[keep]], -1).astype(np.int32)
    lengths = dist[i[keep], j[keep]].astype(np.float32)
    return beams, lengths


def blob(cx: float = 500.0, cy: float = 600.0, radius: float = 150.0,
         spacing: float = 35.0, spring: float = 80.0, damp: float = 15.0,
         pin_anchors: bool = True, *,
         device=None) -> Tuple[SimState, StaticConfig]:
    """Config 2: triangulated soft disk; topmost points pinned as anchors.
    Drive it with ``UserInput.mouse_*`` for drag forces."""
    pos = _disk_points(cx, cy, radius, spacing)
    beams, lengths = _triangulate(pos, spacing * 1.6)
    m = beams.shape[0]
    props = {
        "spring": np.full(m, spring, np.float32),
        "damp": np.full(m, damp, np.float32),
        "yield_strain": np.full(m, 0.5, np.float32),
        "strain_limit": np.full(m, 3.0, np.float32),
    }
    pinned = np.zeros(pos.shape[0], bool)
    if pin_anchors:
        pinned[pos[:, 1] >= pos[:, 1].max() - spacing * 0.6] = True
    state = _build(pos, beams, lengths, props, pinned=pinned, device=device)
    cfg = StaticConfig(subticks=64, collision_mode="allpairs",
                       particle_radius=min(10.0, spacing * 0.45))
    return state, cfg


def self_colliding_cloth(n_particles: int = 100_000,
                         spring: float = 200.0, damp: float = 20.0, *,
                         device=None) -> Tuple[SimState, StaticConfig]:
    """Config 3: ~100k-particle cloth with spatial-hash self-collision.

    The sheet is wider than tall and dropped onto the floor so it folds
    onto itself."""
    w = int(math.sqrt(n_particles * 4))
    h = max(2, n_particles // w)
    spacing = 900.0 / max(w - 1, 1)
    radius = spacing * 0.45
    pos, beams, lengths, props = lattice_arrays(
        50.0, 500.0, spacing, w, h, spring, damp, 0.8, 2.0
    )
    state = _build(pos, beams, lengths, props, device=device)
    cfg = StaticConfig(subticks=64, collision_mode="grid",
                       particle_radius=radius, grid_cell_capacity=8)
    return state, cfg


def multi_blob(n_blobs: int = 64, blob_radius: float = 45.0,
               spacing: float = 18.0, spring: float = 120.0,
               damp: float = 15.0, *,
               device=None) -> Tuple[SimState, StaticConfig]:
    """Config 4: grid of soft blobs raining onto the floor; blob–blob
    contact with friction and restitution through particle collisions."""
    side = int(math.ceil(math.sqrt(n_blobs)))
    scenes = []
    rng = np.random.default_rng(0)
    for k in range(n_blobs):
        gx, gy = k % side, k // side
        cx = 80.0 + gx * (900.0 / side) + rng.uniform(-5, 5)
        cy = 150.0 + gy * (820.0 / side) + rng.uniform(-5, 5)
        pos = _disk_points(cx, cy, blob_radius, spacing)
        beams, lengths = _triangulate(pos, spacing * 1.6)
        m = beams.shape[0]
        props = {
            "spring": np.full(m, spring, np.float32),
            "damp": np.full(m, damp, np.float32),
            "yield_strain": np.full(m, 0.6, np.float32),
            "strain_limit": np.full(m, 3.0, np.float32),
        }
        scenes.append((pos, beams, lengths, props))
    merged = merge_scenes(*scenes)
    state = _build(*merged, device=device)
    cfg = StaticConfig(subticks=64, collision_mode="grid",
                       particle_radius=spacing * 0.45, grid_cell_capacity=8)
    return state, cfg


def tearing_cloth(n_particles: int = 1_000_000, spring: float = 120.0,
                  damp: float = 10.0, strain_limit: float = 0.25, *,
                  device=None) -> Tuple[SimState, StaticConfig]:
    """Config 5: 1M particles / ~4M springs tearing cloth.

    A near-square lattice spanning the world; the top row is pinned and the
    sheet tears under its own weight (strain breakage).  ~4 beams/particle
    (vertical + horizontal + 2 diagonals)."""
    side = int(math.sqrt(n_particles))
    w = h = side
    spacing = 980.0 / (side - 1)
    pos, beams, lengths, props = lattice_arrays(
        10.0, 10.0, spacing, w, h, spring, damp, 0.2, strain_limit
    )
    pinned = np.zeros(pos.shape[0], bool)
    pinned[pos[:, 1] >= 10.0 + (h - 1) * spacing - 1e-3] = True
    state = _build(pos, beams, lengths, props, pinned=pinned, device=device)
    cfg = StaticConfig(subticks=64, collision_mode="grid",
                       particle_radius=spacing * 0.45, grid_cell_capacity=8)
    return state, cfg


SCENES = {
    "default": default_scene,
    "cloth": cloth,
    "blob": blob,
    "self_colliding_cloth": self_colliding_cloth,
    "multi_blob": multi_blob,
    "tearing_cloth": tearing_cloth,
}
