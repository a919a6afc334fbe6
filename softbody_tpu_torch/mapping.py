"""CPU-side scene data model (port of ``softbody_tpu/mapping.py``): a
stable-ID particle/beam registry with adjacency, convertible to/from
device state and snapshot bytes.

This is the equivalent of the reference's state schema layer
(component C4, SURVEY.md §2.1): ``Vector2D`` (engineMapping.ts:8-91),
``Particle`` (:96-131), ``Beam`` (:136-206) and the ``BufferMapper``
registry (:341-528) that the editor and app shell edit against, with
``writeState``/``loadState`` marshalling between the object world and the
flat buffer world.

Pythonic redesign, not a transcription: dataclasses + dict registries;
IDs are transient and reassigned on write, exactly like the reference
(engineMapping.ts:105,153 "IDs are transient and will be reassigned on
write to buffer").

The registry lives on the host.  ``to_state`` builds a :class:`SimState`
on ``device`` (the CUDA device unless the caller names another);
``save`` and ``load`` go through the port's ``snapshot.py`` on the host,
so their bytes equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Set, Tuple, Union

import numpy as np

from .config import PhysicsConstants
from .snapshot import SnapshotError, load_snapshot, save_snapshot
from .state import SimState, state_from_numpy


@dataclasses.dataclass(frozen=True)
class Vec2:
    """Immutable 2-vector (≙ ``Vector2D``, engineMapping.ts:8-91)."""

    x: float = 0.0
    y: float = 0.0

    @property
    def magnitude(self) -> float:
        return math.hypot(self.x, self.y)

    def __add__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x + o.x, self.y + o.y)

    def __sub__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x - o.x, self.y - o.y)

    def __mul__(self, s: float) -> "Vec2":
        return Vec2(self.x * s, self.y * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec2":
        return Vec2(-self.x, -self.y)

    def dot(self, o: "Vec2") -> float:
        return self.x * o.x + self.y * o.y

    def cross(self, o: "Vec2") -> float:
        return self.x * o.y - self.y * o.x

    def norm(self) -> "Vec2":
        m = self.magnitude
        return Vec2(self.x / m, self.y / m) if m else Vec2()

    def clamp(self, lo: "Vec2", hi: "Vec2") -> "Vec2":
        return Vec2(
            min(max(self.x, lo.x), hi.x), min(max(self.y, lo.y), hi.y)
        )

    @staticmethod
    def turn_direction(p: "Vec2", q: "Vec2", r: "Vec2") -> int:
        """Turn direction of segment PQ vs point R: 0 colinear, ±1 turn
        (determinant form, engineMapping.ts:64-66). Used by the editor's
        rectangle-select segment-intersection test."""
        det = p.x * (r.y - q.y) + r.x * (q.y - p.y) + q.x * (p.y - r.y)
        return (det > 0) - (det < 0)


@dataclasses.dataclass(eq=False)
class ParticleObj:
    """Editable particle (≙ ``Particle``, engineMapping.ts:96-131)."""

    id: int
    position: Vec2 = dataclasses.field(default_factory=Vec2)
    velocity: Vec2 = dataclasses.field(default_factory=Vec2)
    acceleration: Vec2 = dataclasses.field(default_factory=Vec2)


@dataclasses.dataclass(eq=False)
class BeamObj:
    """Editable beam (≙ ``Beam``, engineMapping.ts:136-206).

    ``a``/``b`` are particle IDs.  ``length`` is the rest length;
    ``target_length`` carries plastic deformation; ``last_length`` the
    previous-tick actual length (damping memory)."""

    id: int
    a: int
    b: int
    length: float = 0.0
    spring: float = 0.0
    damp: float = 0.0
    yield_strain: float = 0.0
    strain_limit: float = 0.0
    target_length: Optional[float] = None
    last_length: Optional[float] = None
    strain: float = 0.0
    stress: float = 0.0

    def __post_init__(self):
        if self.target_length is None:
            self.target_length = self.length
        if self.last_length is None:
            self.last_length = self.length


class SceneRegistry:
    """Stable-ID registry of particles and beams with per-particle beam
    adjacency (≙ ``BufferMapper``, engineMapping.ts:341-528).

    Capacity checks mirror the reference's add/remove API; the u16 index
    cap does not apply (int indices on the device)."""

    def __init__(
        self,
        max_particles: int = 65536,
        max_beams: int = 65536,
    ) -> None:
        self.max_particles = int(max_particles)
        self.max_beams = int(max_beams)
        self._particles: Dict[int, ParticleObj] = {}
        self._beams: Dict[int, BeamObj] = {}
        self._particle_beams: Dict[int, Set[int]] = {}
        self.constants: PhysicsConstants = PhysicsConstants.default()

    # -- registry API (≙ engineMapping.ts:432-495) --

    def add_particle(self, p: ParticleObj) -> bool:
        if len(self._particles) >= self.max_particles or p.id in self._particles:
            return False
        self._particles[p.id] = p
        return True

    def add_beam(self, b: BeamObj) -> bool:
        if len(self._beams) >= self.max_beams or b.id in self._beams:
            return False
        self._beams[b.id] = b
        self._particle_beams.setdefault(b.a, set()).add(b.id)
        self._particle_beams.setdefault(b.b, set()).add(b.id)
        return True

    def remove_particle(self, p: Union[ParticleObj, int]) -> bool:
        """Remove a particle AND its incident beams (a beam with a
        missing endpoint is invalid — the reference editor deletes them
        together, editor.ts:264-270)."""
        pid = p if isinstance(p, int) else p.id
        if self._particles.pop(pid, None) is None:
            return False
        for bid in list(self._particle_beams.get(pid, ())):
            self.remove_beam(bid)
        self._particle_beams.pop(pid, None)
        return True

    def remove_beam(self, b: Union[BeamObj, int]) -> bool:
        bid = b if isinstance(b, int) else b.id
        beam = self._beams.pop(bid, None)
        if beam is None:
            return False
        self._particle_beams.get(beam.a, set()).discard(bid)
        self._particle_beams.get(beam.b, set()).discard(bid)
        return True

    def find_particle(self, pid: int) -> Optional[ParticleObj]:
        return self._particles.get(pid)

    def find_beam(self, bid: int) -> Optional[BeamObj]:
        return self._beams.get(bid)

    def connected_beams(self, p: Union[ParticleObj, int]) -> Set[BeamObj]:
        pid = p if isinstance(p, int) else p.id
        return {
            self._beams[bid]
            for bid in self._particle_beams.get(pid, set())
            if bid in self._beams
        }

    @property
    def first_empty_particle_id(self) -> int:
        if len(self._particles) >= self.max_particles:
            return -1
        i = 0
        while i in self._particles:
            i += 1
        return i

    @property
    def first_empty_beam_id(self) -> int:
        if len(self._beams) >= self.max_beams:
            return -1
        i = 0
        while i in self._beams:
            i += 1
        return i

    @property
    def particles(self) -> Tuple[ParticleObj, ...]:
        return tuple(self._particles.values())

    @property
    def beams(self) -> Tuple[BeamObj, ...]:
        return tuple(self._beams.values())

    @property
    def particle_count(self) -> int:
        return len(self._particles)

    @property
    def beam_count(self) -> int:
        return len(self._beams)

    def clear(self) -> None:
        self._particles.clear()
        self._beams.clear()
        self._particle_beams.clear()

    # -- marshalling (≙ writeState/loadState, engineMapping.ts:500-527) --

    def to_arrays(self):
        """Flatten the registry to dense numpy arrays; IDs are remapped to
        dense indices in insertion order (beams referencing missing
        particles are dropped, like invalid beams)."""
        parts = list(self._particles.values())
        id_remap = {p.id: i for i, p in enumerate(parts)}
        pos = np.array([[p.position.x, p.position.y] for p in parts], np.float32).reshape(-1, 2)
        vel = np.array([[p.velocity.x, p.velocity.y] for p in parts], np.float32).reshape(-1, 2)
        acc = np.array([[p.acceleration.x, p.acceleration.y] for p in parts], np.float32).reshape(-1, 2)
        beams = [
            b for b in self._beams.values() if b.a in id_remap and b.b in id_remap
        ]
        pair = np.array([[id_remap[b.a], id_remap[b.b]] for b in beams], np.int32).reshape(-1, 2)

        def f32(attr):
            return np.array([getattr(b, attr) for b in beams], np.float32)

        return {
            "pos": pos, "vel": vel, "acc": acc, "beams": pair,
            "length": f32("length"), "target": f32("target_length"),
            "last": f32("last_length"), "spring": f32("spring"),
            "damp": f32("damp"), "yield_strain": f32("yield_strain"),
            "strain_limit": f32("strain_limit"),
            "strain": f32("strain"), "stress": f32("stress"),
        }

    def to_state(
        self,
        max_particles: Optional[int] = None,
        max_beams: Optional[int] = None,
        build_incidence: bool = True,
        device=None,
    ) -> SimState:
        """A :class:`SimState` on ``device`` (default: the CUDA device)."""
        a = self.to_arrays()
        return state_from_numpy(
            a["pos"], a["vel"], acc=a["acc"],
            beams=a["beams"] if len(a["beams"]) else None,
            beam_length=a["length"], beam_spring=a["spring"],
            beam_damp=a["damp"], beam_yield_strain=a["yield_strain"],
            beam_strain_limit=a["strain_limit"],
            beam_target_length=a["target"], beam_last_length=a["last"],
            max_particles=max_particles, max_beams=max_beams,
            build_incidence=build_incidence, device=device,
        )

    def load_state(self, state: SimState) -> None:
        """Rebuild the registry from a :class:`SimState` on any device
        (live lanes only)."""
        self.clear()

        def host(t):
            return t.detach().cpu().numpy()

        pos = host(state.pos).astype(np.float32)
        vel = host(state.vel).astype(np.float32)
        acc = host(state.acc).astype(np.float32)
        p_alive = host(state.particle_alive).astype(bool)
        live = np.flatnonzero(p_alive)
        remap = {int(old): new for new, old in enumerate(live)}
        for new, old in enumerate(live):
            self.add_particle(
                ParticleObj(new, Vec2(*pos[old]), Vec2(*vel[old]), Vec2(*acc[old]))
            )
        b_alive = host(state.beam_alive).astype(bool)
        a_idx = host(state.beam_a)
        b_idx = host(state.beam_b)
        fields = {
            k: host(getattr(state, f"beam_{k}")).astype(np.float32)
            for k in ("length", "target_length", "last_length", "spring", "damp",
                      "yield_strain", "strain_limit", "strain", "stress")
        }
        nb = 0
        for old in np.flatnonzero(b_alive):
            ia, ib = int(a_idx[old]), int(b_idx[old])
            if ia not in remap or ib not in remap:
                continue
            self.add_beam(
                BeamObj(
                    nb, remap[ia], remap[ib],
                    length=float(fields["length"][old]),
                    spring=float(fields["spring"][old]),
                    damp=float(fields["damp"][old]),
                    yield_strain=float(fields["yield_strain"][old]),
                    strain_limit=float(fields["strain_limit"][old]),
                    target_length=float(fields["target_length"][old]),
                    last_length=float(fields["last_length"][old]),
                    strain=float(fields["strain"][old]),
                    stress=float(fields["stress"][old]),
                )
            )
            nb += 1

    # -- snapshots (≙ createSnapshotBuffer/loadSnapshotbuffer) --

    def save(self, *, format: str = "auto") -> bytes:
        return save_snapshot(
            self.to_state(build_incidence=False, device="cpu"),
            self.constants, format=format,
        )

    def load(self, buf: bytes) -> bool:
        """Returns False (like engineMapping.ts:418) when the snapshot
        exceeds this registry's capacity."""
        try:
            state, consts = load_snapshot(buf, build_incidence=False,
                                          device="cpu")
        except SnapshotError:
            return False
        if (
            int(state.particle_count) > self.max_particles
            or int(state.beam_count) > self.max_beams
        ):
            return False
        self.load_state(state)
        self.constants = consts
        return True
