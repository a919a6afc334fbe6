"""Static and runtime configuration (PyTorch port of ``softbody_tpu.config``).

Three tiers, as in the reference engine: :class:`StaticConfig` holds the
compile-time world constants (bounds, particle radius, substeps),
:class:`PhysicsConstants` the runtime-mutable physics constants and
:class:`UserInput` the per-frame user input.

Scalars are host floats holding float32 values: every value is rounded
to float32 when it is set, and :func:`consts_vector` packs them into the
float32 vector the substep kernels read, so the plain torch versions and
the CUDA kernels see the same float32 numbers.  A compiled frame
(``ops/compiled.py``) receives the fields of :class:`PhysicsConstants`
and :class:`UserInput` as 0-d float32 tensors on its device instead (as
``jax.jit`` traces them): every use of them here works on either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

DEFAULT_BOUNDS_SIZE = 1000.0
DEFAULT_PARTICLE_RADIUS = 10.0
DEFAULT_SUBTICKS = 64
DEFAULT_BLUR = 0.4
# Fixed-point force-accumulation scale (compute.wgsl:70).
PARTICLE_FORCE_SCALE = 65536.0
# Stress visualization scale (compute.wgsl:71): stress = force_mag / 20.
BEAM_STRESS_SCALE = 1.0 / 20.0

# length of the consts vector (the order of ``consts_vector``)
N_CONSTS = 20


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises ``RuntimeError`` when CUDA is asked for (or left to
    the default) and no CUDA device is present: the port never moves to
    the CPU unless told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain torch versions on the CPU")
    return dev


def f32(x) -> float:
    """``x`` rounded to float32, as a host float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """World constants fixed for the life of an engine.

    ``subticks`` is forced even like the reference (engineWorker.ts:90).
    ``collision_mode``: ``"none"`` disables collisions; the general
    engine (``ops/collisions.py``) runs ``"allpairs"`` (the reference's
    O(N²) loop, tiled by ``collision_tile`` partners), ``"grid"`` (a
    spatial hash of cells of ``grid_cell_capacity`` particles) or
    ``"window"`` (sorted-row windows of ``window_rows`` rows); the
    lattice path treats every mode but ``"none"`` the same (the stencil
    supplies the pairs).
    ``force_mode``: ``"quantized"`` (int32 fixed point at scale 65536,
    bit-matching the reference's atomic trick) or ``"segment"`` (f32).
    ``use_pallas``: the JAX package's name for its kernel routes, kept so
    a reader finds the counterpart; here it sends the lattice substep's
    collision stencil through the hand-written kernel K3
    (``ops/cuda/collide_stencil.py``).
    """

    bounds_size: float = DEFAULT_BOUNDS_SIZE
    particle_radius: float = DEFAULT_PARTICLE_RADIUS
    subticks: int = DEFAULT_SUBTICKS
    collision_mode: str = "allpairs"
    force_mode: str = "quantized"
    collision_tile: int = 512
    grid_cell_capacity: int = 8
    window_rows: int = 2048
    use_pallas: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "subticks", max(2, -(-self.subticks // 2) * 2))
        if self.collision_mode not in ("none", "allpairs", "grid", "window"):
            raise ValueError(f"unknown collision_mode {self.collision_mode!r}")
        if self.force_mode not in ("segment", "quantized"):
            raise ValueError(f"unknown force_mode {self.force_mode!r}")

    @property
    def dt(self) -> float:
        """Substep timestep (override ``time_step = 1/subticks``)."""
        return 1.0 / self.subticks


@dataclasses.dataclass
class PhysicsConstants:
    """Runtime physics constants (metadata buffer fields 48..80,
    engineMapping.ts:260); defaults match engineMapping.ts:264-272."""

    gravity: Tuple[float, float] = (0.0, -0.5)
    border_elasticity: float = 0.5
    border_friction: float = 0.2
    elasticity: float = 0.5
    friction: float = 0.1
    drag_coeff: float = 0.001
    drag_exp: float = 2.0

    def __post_init__(self) -> None:
        self.gravity = (f32(self.gravity[0]), f32(self.gravity[1]))
        for name in ("border_elasticity", "border_friction", "elasticity",
                     "friction", "drag_coeff", "drag_exp"):
            setattr(self, name, f32(getattr(self, name)))

    @classmethod
    def default(cls) -> "PhysicsConstants":
        return cls()

    @classmethod
    def from_array(cls, arr) -> "PhysicsConstants":
        """From the 8-float32 layout of the metadata buffer
        (engineMapping.ts:260): gravity x/y, border elasticity/friction,
        elasticity, friction, drag coefficient/exponent."""
        a = [float(x) for x in np.asarray(arr, np.float32).reshape(8)]
        return cls(gravity=(a[0], a[1]), border_elasticity=a[2],
                   border_friction=a[3], elasticity=a[4], friction=a[5],
                   drag_coeff=a[6], drag_exp=a[7])

    def to_array(self) -> np.ndarray:
        """The inverse of :meth:`from_array`: float32 ``[8]``."""
        return np.asarray([*self.gravity, self.border_elasticity,
                           self.border_friction, self.elasticity,
                           self.friction, self.drag_coeff, self.drag_exp],
                          np.float32)

    @property
    def ecoeff(self):
        """Normal-impulse coefficient ``(elasticity + 1) / 2`` in float32
        (a 0-d tensor where ``elasticity`` is one)."""
        e = self.elasticity
        if isinstance(e, torch.Tensor):
            return (e + 1.0) * 0.5
        return float((np.float32(e) + np.float32(1.0)) * np.float32(0.5))


# Input clamping ranges (low, high, step) from the reference's
# clamped-input framework (main.ts:92-133; createClampedInput calls at
# main.ts:120-132).
CLAMP_RANGES = {
    "particle_radius": (1.0, 500.0, 1.0),
    "subticks": (2, 256, 2),
    "keyboard_force": (0.1, 10.0, 0.1),
    "gravity_x": (-10.0, 10.0, 0.02),
    "gravity_y": (-10.0, 10.0, 0.02),
    "border_elasticity": (0.0, 1.0, 0.01),
    "border_friction": (0.0, 10.0, 0.01),
    "elasticity": (0.0, 1.0, 0.01),
    "friction": (0.0, 10.0, 0.01),
    "drag_coeff": (0.0, 2.0**32, 0.001),
    "drag_exp": (1.0, 4.0, 0.1),
    # editor beam settings (main.ts:298-303)
    "beam_spring": (0.0, 2000.0, 0.1),
    "beam_damp": (0.0, 2000.0, 0.1),
    "yield_strain": (0.0, 2000.0, 0.1),
    "strain_limit": (0.0, 2000.0, 0.1),
    "triangulation_distance": (0.0, 1000.0, 10.0),
    "snap_grid_size": (0.0, 100.0, 10.0),
}


def clamp_value(name: str, value: float) -> float:
    """Clamp and snap a configuration value to the reference UI's range
    and step (``updateClamps``, main.ts:93-106: round to the step, then
    clamp; NaN becomes 1, main.ts:101)."""
    lo, hi, step = CLAMP_RANGES[name]
    v = max(lo, min(hi, round(float(value) / step) * step))
    return 1.0 if math.isnan(v) else v


def clamp_constants(consts: PhysicsConstants) -> PhysicsConstants:
    """A copy with every field clamped to the reference UI's ranges."""
    return PhysicsConstants(
        gravity=(clamp_value("gravity_x", consts.gravity[0]),
                 clamp_value("gravity_y", consts.gravity[1])),
        **{name: clamp_value(name, getattr(consts, name))
           for name in ("border_elasticity", "border_friction",
                        "elasticity", "friction", "drag_coeff",
                        "drag_exp")})


@dataclasses.dataclass
class UserInput:
    """Per-frame user input (engineMapping.ts:317-325)."""

    user_strength: float = 1.0
    mouse_active: bool = False
    mouse_pos: Tuple[float, float] = (0.0, 0.0)
    mouse_vel: Tuple[float, float] = (0.0, 0.0)
    applied_force: Tuple[float, float] = (0.0, 0.0)

    def __post_init__(self) -> None:
        self.user_strength = f32(self.user_strength)
        self.mouse_active = bool(self.mouse_active)
        for name in ("mouse_pos", "mouse_vel", "applied_force"):
            v = getattr(self, name)
            setattr(self, name, (f32(v[0]), f32(v[1])))

    @classmethod
    def none(cls) -> "UserInput":
        return cls()


def consts_vector(consts: PhysicsConstants, uin: UserInput,
                  cfg: StaticConfig, world_h: int,
                  device=None) -> torch.Tensor:
    """The 20 float32 scalars of one substep, in the order of the JAX
    package's ``ops/pallas/fused_substep.py::_consts_vector``: radius,
    dt, bounds, gravity x/y, border elasticity/friction, ecoeff,
    friction, drag coeff/exp, user strength, mouse active, mouse pos
    x/y, mouse vel x/y, applied force x/y, world height.

    On ``device`` (default: the CPU, or the device of fields that are
    tensors).  Host fields go there in one copy from pinned memory (no
    synchronisation); fields that are 0-d tensors (a compiled frame's
    lifted inputs) are stacked there, the static configuration's host
    floats filled beside them, so a captured frame makes no host copy."""
    vals = [
        cfg.particle_radius, cfg.dt, cfg.bounds_size,
        consts.gravity[0], consts.gravity[1],
        consts.border_elasticity, consts.border_friction,
        consts.ecoeff, consts.friction, consts.drag_coeff, consts.drag_exp,
        uin.user_strength, uin.mouse_active,
        uin.mouse_pos[0], uin.mouse_pos[1],
        uin.mouse_vel[0], uin.mouse_vel[1],
        uin.applied_force[0], uin.applied_force[1],
        world_h,
    ]
    lifted = [v for v in vals if isinstance(v, torch.Tensor)]
    if device is None:
        device = lifted[0].device if lifted else "cpu"
    device = torch.device(device)
    capturing = (device.type == "cuda"
                 and torch.cuda.is_current_stream_capturing())
    if not lifted and not capturing:
        host = torch.tensor(np.asarray([float(v) for v in vals], np.float32))
        if device.type == "cpu":
            return host
        return host.pin_memory().to(device, non_blocking=True)
    return torch.stack([
        v.to(device, torch.float32) if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float32, device=device)
        for v in vals])
