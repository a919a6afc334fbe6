"""Rectangular spring lattice generator (a copy of the numpy builders of
``softbody_tpu/models/lattice.py``) — the workhorse scene primitive
(≙ ``addRectangle``, main.ts:203-213: per grid node, a vertical beam, a
horizontal beam, and both diagonals at √2·spacing), and the
registry-based ``add_rectangle``."""

from __future__ import annotations

import math

import numpy as np

from ..mapping import BeamObj, ParticleObj, SceneRegistry, Vec2


def lattice_arrays(
    ox: float,
    oy: float,
    spacing: float,
    w: int,
    h: int,
    spring: float,
    damp: float,
    yield_strain: float = math.inf,
    strain_limit: float = math.inf,
    *,
    diagonals: bool = True,
    index_offset: int = 0,
):
    """Dense numpy lattice: returns (pos [w*h,2], beams [M,2], lengths [M],
    props dict of per-beam arrays).  Node order is column-major (x outer,
    y inner) like the reference so index arithmetic matches."""
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([gx * spacing + ox, gy * spacing + oy], -1).reshape(-1, 2)

    beams = []
    lengths = []
    sq2 = math.sqrt(2.0) * spacing
    # vectorized beam construction
    x_idx, y_idx = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    base = (x_idx * h + y_idx + index_offset).ravel()
    xf, yf = x_idx.ravel(), y_idx.ravel()

    vert = yf < h - 1
    beams.append(np.stack([base[vert], base[vert] + 1], -1))
    lengths.append(np.full(vert.sum(), spacing, np.float32))
    horiz = xf < w - 1
    beams.append(np.stack([base[horiz], base[horiz] + h], -1))
    lengths.append(np.full(horiz.sum(), spacing, np.float32))
    if diagonals:
        diag = (yf < h - 1) & (xf < w - 1)
        beams.append(np.stack([base[diag], base[diag] + h + 1], -1))
        lengths.append(np.full(diag.sum(), sq2, np.float32))
        anti = (yf > 0) & (xf < w - 1)
        beams.append(np.stack([base[anti], base[anti] + h - 1], -1))
        lengths.append(np.full(anti.sum(), sq2, np.float32))

    beams = np.concatenate(beams).astype(np.int32)
    lengths = np.concatenate(lengths)
    m = beams.shape[0]
    props = {
        "spring": np.full(m, spring, np.float32),
        "damp": np.full(m, damp, np.float32),
        "yield_strain": np.full(m, yield_strain, np.float32),
        "strain_limit": np.full(m, strain_limit, np.float32),
    }
    return pos.astype(np.float32), beams, lengths, props


def add_rectangle(
    reg: SceneRegistry,
    ox: float,
    oy: float,
    spacing: float,
    w: int,
    h: int,
    spring: float,
    damp: float,
    yield_strain: float = math.inf,
    strain_limit: float = math.inf,
) -> None:
    """Registry-based lattice builder mirroring the reference's call shape."""
    pos, beams, lengths, props = lattice_arrays(
        ox, oy, spacing, w, h, spring, damp, yield_strain, strain_limit
    )
    base_ids = []
    for p in pos:
        pid = reg.first_empty_particle_id
        reg.add_particle(ParticleObj(pid, Vec2(float(p[0]), float(p[1]))))
        base_ids.append(pid)
    for k in range(beams.shape[0]):
        bid = reg.first_empty_beam_id
        reg.add_beam(
            BeamObj(
                bid,
                base_ids[int(beams[k, 0])],
                base_ids[int(beams[k, 1])],
                length=float(lengths[k]),
                spring=spring,
                damp=damp,
                yield_strain=yield_strain,
                strain_limit=strain_limit,
            )
        )


def merge_scenes(*scenes):
    """Concatenate (pos, beams, lengths, props) tuples with index fixup."""
    poss, beamss, lens, props_list = [], [], [], []
    offset = 0
    for pos, beams, lengths, props in scenes:
        poss.append(pos)
        beamss.append(beams + offset)
        lens.append(lengths)
        props_list.append(props)
        offset += pos.shape[0]
    keys = props_list[0].keys() if props_list else ()
    props = {
        k: np.concatenate([p[k] for p in props_list]) for k in keys
    }
    return (
        np.concatenate(poss),
        np.concatenate(beamss).astype(np.int32),
        np.concatenate(lens),
        props,
    )
