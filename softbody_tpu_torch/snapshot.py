"""Snapshot (checkpoint) serialization: the port of
``softbody_tpu/snapshot.py``, byte for byte.

The reference's snapshot is its single interchange format between
engine, editor, disk files and the reset slot (engineMapping.ts:377-430,
main.ts:262-276).  Three wire formats, each package reading the other's:

- **v0**, byte-compatible with the reference:
  ``[6×u16 section byte-lengths][8×f32 physics constants]
  [particle mapping u16[pc]][particle data 24 B×pc]
  [beam mapping u16[bc]][beam data 40 B×bc]``; particle data is
  pos/vel/acc ``vec2<f32>`` (engineMapping.ts:103), beam data ``u16 a,
  u16 b, f32 length, target_len, last_len, spring, damp, yield_strain,
  strain_limit, strain, stress`` (engineMapping.ts:151).  The u16
  byte-length header overflows past 2730 particles in the reference
  (engineMapping.ts:388-393); writing v0 beyond that is refused.
- **v1** (``SBT1``): the same widened to u32 counts and i32 endpoints.
- **L1** (``SBL1``): a dense :class:`~.ops.stencil.LatticeState`, W, H,
  the particle planes, then 4 edge classes × 10 field planes.

Loaders build their state on ``device`` (default: the CUDA device;
``config.resolve_device``).  Saving reads the state back to the host.
"""

from __future__ import annotations

import io
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from .config import PhysicsConstants, resolve_device
from .convert import lattice_state_from_numpy
from .ops.stencil import EDGE_OFFSETS, LatticeState
from .state import SimState, state_from_numpy

_V1_MAGIC = b"SBT1"
_L1_MAGIC = b"SBL1"
_PARTICLE_STRIDE = 24
_BEAM_STRIDE_V0 = 40

V0_MAX_PARTICLES = 65535 // _PARTICLE_STRIDE  # 2730 (u16 byte-length header)
V0_MAX_BEAMS = 65535 // _BEAM_STRIDE_V0  # 1638

# beam record fields after the endpoints, in wire order
_BEAM_KEYS = ("length", "target", "last", "spring", "damp", "yield_strain",
              "strain_limit", "strain", "stress")
_BEAM_FIELDS = ("beam_length", "beam_target_length", "beam_last_length",
                "beam_spring", "beam_damp", "beam_yield_strain",
                "beam_strain_limit", "beam_strain", "beam_stress")
# an edge class's float planes in L1 order (its alive mask follows)
_L1_EDGE_FLOATS = ("length", "target_length", "last_length", "spring",
                   "damp", "yield_strain", "strain_limit", "strain",
                   "stress")


class SnapshotError(ValueError):
    pass


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _gather_live(state: SimState):
    """Live particles and beams as dense host arrays; beams with a dead
    endpoint are dropped (the reference leaves them dangling as "invalid
    beams", editor.ts:631-658)."""
    pos = _host(state.pos).astype(np.float32)
    p_alive = _host(state.particle_alive).astype(bool)
    a = _host(state.beam_a).astype(np.int64)
    b = _host(state.beam_b).astype(np.int64)
    b_alive = _host(state.beam_alive).astype(bool) & p_alive[a] & p_alive[b]

    p_idx = np.flatnonzero(p_alive)
    remap = np.full(pos.shape[0], -1, np.int64)
    remap[p_idx] = np.arange(p_idx.size)
    b_idx = np.flatnonzero(b_alive)
    particles = {
        "pos": pos[p_idx],
        "vel": _host(state.vel).astype(np.float32)[p_idx],
        "acc": _host(state.acc).astype(np.float32)[p_idx],
    }
    beams = {"a": remap[a[b_idx]], "b": remap[b[b_idx]]}
    for key, field in zip(_BEAM_KEYS, _BEAM_FIELDS):
        beams[key] = _host(getattr(state, field)).astype(np.float32)[b_idx]
    return particles, beams


def save_snapshot(state: SimState, consts: PhysicsConstants, *,
                  format: str = "auto") -> bytes:
    """Serialize the live state and the physics constants.  ``format``:
    ``"v0"`` (reference-compatible), ``"v1"``, or ``"auto"`` (v0 when it
    fits, else v1)."""
    particles, beams = _gather_live(state)
    pc = particles["pos"].shape[0]
    bc = beams["a"].shape[0]
    fits_v0 = pc <= V0_MAX_PARTICLES and bc <= V0_MAX_BEAMS
    if format == "auto":
        format = "v0" if fits_v0 else "v1"
    if format == "v0":
        if not fits_v0:
            raise SnapshotError(
                f"{pc} particles / {bc} beams exceed the v0 (u16 header) "
                f"capacity of {V0_MAX_PARTICLES}/{V0_MAX_BEAMS}; use v1")
        return _save_v0(particles, beams, consts.to_array())
    if format == "v1":
        return _save_v1(particles, beams, consts.to_array())
    raise ValueError(f"unknown snapshot format {format!r}")


def _particle_records(particles) -> np.ndarray:
    return np.concatenate([particles["pos"], particles["vel"],
                           particles["acc"]], axis=1).astype(np.float32)


def _save_v0(particles, beams, consts8: np.ndarray) -> bytes:
    pc = particles["pos"].shape[0]
    bc = beams["a"].shape[0]
    out = io.BytesIO()
    out.write(struct.pack("<6H", 2 * pc, _PARTICLE_STRIDE * pc, 2 * bc,
                          _BEAM_STRIDE_V0 * bc, 32, 0))
    out.write(consts8.tobytes())
    out.write(np.arange(pc, dtype=np.uint16).tobytes())  # identity mapping
    out.write(_particle_records(particles).tobytes())
    out.write(np.arange(bc, dtype=np.uint16).tobytes())
    brec = np.zeros((bc, _BEAM_STRIDE_V0 // 4), np.float32)
    pair = (beams["a"].astype(np.uint32)
            | (beams["b"].astype(np.uint32) << 16)).astype(np.uint32)
    brec[:, 0] = pair.view(np.float32)
    for i, k in enumerate(_BEAM_KEYS, start=1):
        brec[:, i] = beams[k]
    out.write(brec.tobytes())
    return out.getvalue()


def _save_v1(particles, beams, consts8: np.ndarray) -> bytes:
    out = io.BytesIO()
    out.write(_V1_MAGIC)
    out.write(struct.pack("<II", particles["pos"].shape[0],
                          beams["a"].shape[0]))
    out.write(consts8.tobytes())
    out.write(_particle_records(particles).tobytes())
    out.write(beams["a"].astype(np.int32).tobytes())
    out.write(beams["b"].astype(np.int32).tobytes())
    for k in _BEAM_KEYS:
        out.write(beams[k].astype(np.float32).tobytes())
    return out.getvalue()


def load_snapshot(buf: bytes, *, max_particles: Optional[int] = None,
                  max_beams: Optional[int] = None,
                  build_incidence: bool = True,
                  device=None) -> Tuple[SimState, PhysicsConstants]:
    """Deserialize a v0 or v1 snapshot (auto-detected) into a
    :class:`SimState` on ``device`` and its :class:`PhysicsConstants`.

    Raises :class:`SnapshotError` on malformed bytes and when the snapshot
    exceeds the requested capacity (the reference returns ``false``,
    engineMapping.ts:418, and alerts, main.ts:79-83)."""
    if buf[:4] == _L1_MAGIC:
        raise SnapshotError("lattice (L1) snapshot — use load_lattice_snapshot")
    try:
        parsed = _load_v1(buf) if buf[:4] == _V1_MAGIC else _load_v0(buf)
    except (ValueError, IndexError, struct.error) as e:
        raise SnapshotError(f"malformed snapshot: {e}") from e
    particles, beams, consts8 = parsed
    pc = particles["pos"].shape[0]
    bc = beams["a"].shape[0]
    if max_particles is not None and pc > max_particles:
        raise SnapshotError(f"snapshot has {pc} particles > capacity "
                            f"{max_particles}")
    if max_beams is not None and bc > max_beams:
        raise SnapshotError(f"snapshot has {bc} beams > capacity {max_beams}")
    device = resolve_device(device)
    state = state_from_numpy(
        particles["pos"], particles["vel"], acc=particles["acc"],
        beams=np.stack([beams["a"], beams["b"]], -1) if bc else None,
        beam_length=beams["length"], beam_spring=beams["spring"],
        beam_damp=beams["damp"], beam_yield_strain=beams["yield_strain"],
        beam_strain_limit=beams["strain_limit"],
        beam_target_length=beams["target"], beam_last_length=beams["last"],
        max_particles=max_particles, max_beams=max_beams,
        build_incidence=build_incidence, device=device)
    if bc:
        for key, field in (("strain", "beam_strain"),
                           ("stress", "beam_stress")):
            plane = np.zeros(state.max_beams, np.float32)
            plane[:bc] = beams[key]
            setattr(state, field, torch.from_numpy(plane).to(device))
    return state, PhysicsConstants.from_array(consts8)


def _load_v0(buf: bytes):
    if len(buf) < 12 + 32:
        raise SnapshotError("truncated v0 snapshot")
    p_map_size, p_data_size, b_map_size, b_data_size, meta_size, _ = \
        struct.unpack("<6H", buf[:12])
    off = 12
    consts8 = np.frombuffer(buf, np.float32, meta_size // 4, off).copy()
    off += meta_size
    pc = p_map_size // 2
    bc = b_map_size // 2
    p_map = np.frombuffer(buf, np.uint16, pc, off).astype(np.int64)
    off += p_map_size
    p_rec = np.frombuffer(buf, np.float32, p_data_size // 4, off).reshape(
        pc, 6)
    off += p_data_size
    b_map = np.frombuffer(buf, np.uint16, bc, off).astype(np.int64)
    off += b_map_size
    b_rec = np.frombuffer(buf, np.float32, b_data_size // 4, off).reshape(
        bc, _BEAM_STRIDE_V0 // 4)

    # Honour the ID → index mapping: particle id i lives at buffer index
    # p_map[i]; beam endpoints are buffer indices, inverted back to ids
    # (the reference's ``mBuf.indexOf``, engineMapping.ts:201)
    p_data = p_rec[p_map] if pc else p_rec
    inv = np.full(65536, -1, np.int64)
    inv[p_map] = np.arange(pc)
    b_data = b_rec[b_map] if bc else b_rec
    pair = (np.ascontiguousarray(b_data[:, 0]).view(np.uint32) if bc
            else np.zeros(0, np.uint32))
    idx_a = inv[(pair & 0xFFFF).astype(np.int64)]
    idx_b = inv[(pair >> 16).astype(np.int64)]
    if bc and (np.any(idx_a < 0) or np.any(idx_b < 0)):
        raise SnapshotError("beam references unknown particle index")
    particles = {k: p_data[:, 2 * i:2 * i + 2].astype(np.float32)
                 for i, k in enumerate(("pos", "vel", "acc"))}
    beams = {k: b_data[:, i + 1].astype(np.float32)
             for i, k in enumerate(_BEAM_KEYS)}
    beams["a"] = idx_a
    beams["b"] = idx_b
    return particles, beams, consts8


def _load_v1(buf: bytes):
    pc, bc = struct.unpack("<II", buf[4:12])
    off = 12
    consts8 = np.frombuffer(buf, np.float32, 8, off).copy()
    off += 32
    p_rec = np.frombuffer(buf, np.float32, pc * 6, off).reshape(pc, 6)
    off += pc * _PARTICLE_STRIDE
    beams = {}
    for k in ("a", "b"):
        beams[k] = np.frombuffer(buf, np.int32, bc, off).astype(np.int64)
        off += 4 * bc
    for k in _BEAM_KEYS:
        beams[k] = np.frombuffer(buf, np.float32, bc, off).copy()
        off += 4 * bc
    particles = {k: p_rec[:, 2 * i:2 * i + 2].astype(np.float32)
                 for i, k in enumerate(("pos", "vel", "acc"))}
    return particles, beams, consts8


def save_lattice_snapshot(state: LatticeState,
                          consts: PhysicsConstants) -> bytes:
    """Serialize a dense :class:`LatticeState` (L1): magic, W, H, the
    physics constants, the particle planes, then per edge class its nine
    float planes and its alive mask."""
    w, h = state.shape
    out = io.BytesIO()
    out.write(_L1_MAGIC)
    out.write(struct.pack("<II", w, h))
    out.write(consts.to_array().tobytes())
    for arr in (state.pos, state.vel, state.acc):
        out.write(_host(arr).astype(np.float32).tobytes())
    for mask in (state.alive, state.pinned):
        out.write(_host(mask).astype(bool).astype(np.uint8).tobytes())
    for e in state.edges:
        for f in _L1_EDGE_FLOATS:
            out.write(_host(getattr(e, f)).astype(np.float32).tobytes())
        out.write(_host(e.alive).astype(bool).astype(np.uint8).tobytes())
    return out.getvalue()


def load_lattice_snapshot(buf: bytes, *, device=None
                          ) -> Tuple[LatticeState, PhysicsConstants]:
    """Deserialize an L1 snapshot into a :class:`LatticeState` on
    ``device`` and its :class:`PhysicsConstants`.  Raises
    :class:`SnapshotError` on other formats and malformed sizes."""
    if buf[:4] != _L1_MAGIC:
        raise SnapshotError("not an L1 lattice snapshot")
    if len(buf) < 12 + 32:
        raise SnapshotError("truncated L1 snapshot")
    w, h = struct.unpack("<II", buf[4:12])
    expected = 12 + 32 + (w * h) * (3 * 8 + 2 + 4 * (9 * 4 + 1))
    if len(buf) < expected or w == 0 or h == 0 or w * h > 300_000_000:
        raise SnapshotError(
            f"L1 snapshot malformed: {w}x{h}, {len(buf)} bytes < {expected}")
    device = resolve_device(device)
    off = 12
    consts8 = np.frombuffer(buf, np.float32, 8, off)
    off += 32

    def plane(dtype, shape):
        nonlocal off
        count = int(np.prod(shape))
        arr = np.frombuffer(buf, dtype, count, off).reshape(shape)
        off += count * arr.itemsize
        return arr

    fields = {k: plane(np.float32, (w, h, 2)) for k in ("pos", "vel", "acc")}
    fields["alive"] = plane(np.uint8, (w, h)).astype(bool)
    fields["pinned"] = plane(np.uint8, (w, h)).astype(bool)
    edges = []
    for _ in EDGE_OFFSETS:
        e = {f: plane(np.float32, (w, h)) for f in _L1_EDGE_FLOATS}
        e["alive"] = plane(np.uint8, (w, h)).astype(bool)
        edges.append(e)
    state = lattice_state_from_numpy(**fields, edges=edges, device=device)
    return state, PhysicsConstants.from_array(consts8)
