"""numpy ↔ torch conversion of the states (lattice, planified and
general), constants and user input.

The "weights" of this system are its state: a world built or stepped by
the JAX package, read out as numpy arrays, becomes the same world here
(and back), so both packages can step it and be compared."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .config import PhysicsConstants, UserInput, resolve_device
from .ops.stencil import EdgeClass, LatticeState
from .state import BEAM_FIELDS, PARTICLE_FIELDS, SimState

EDGE_FIELDS = tuple(EdgeClass.__dataclass_fields__)


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _bool(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, bool)).to(device)


def lattice_state_from_numpy(pos, vel, acc, alive, pinned,
                             edges: Sequence[Mapping[str, np.ndarray]], *,
                             device=None) -> LatticeState:
    """A :class:`LatticeState` on ``device`` (default: the CUDA device;
    ``config.resolve_device``) from the numpy fields of a lattice state:
    ``pos``/``vel``/``acc`` ``[W, H, 2]``, ``alive`` and ``pinned``
    ``[W, H]`` bool, and per edge class a mapping of the
    :class:`EdgeClass` field names to ``[W, H]`` arrays."""
    device = resolve_device(device)
    out_edges = []
    for e in edges:
        missing = set(EDGE_FIELDS) - set(e)
        if missing:
            raise ValueError(f"edge class lacks fields {sorted(missing)}")
        out_edges.append(EdgeClass(**{
            k: (_bool if k == "alive" else _f32)(e[k], device)
            for k in EDGE_FIELDS
        }))
    return LatticeState(
        pos=_f32(pos, device), vel=_f32(vel, device), acc=_f32(acc, device),
        alive=_bool(alive, device), pinned=_bool(pinned, device),
        edges=tuple(out_edges),
    )


def lattice_state_to_numpy(state) -> dict:
    """The inverse of :func:`lattice_state_from_numpy`: a dict of numpy
    arrays that it accepts back (``**``).  Works on any object with the
    ``LatticeState`` attributes, the JAX package's included."""
    return dict(
        pos=np.asarray(_host(state.pos), np.float32),
        vel=np.asarray(_host(state.vel), np.float32),
        acc=np.asarray(_host(state.acc), np.float32),
        alive=np.asarray(_host(state.alive), bool),
        pinned=np.asarray(_host(state.pinned), bool),
        edges=[{k: np.asarray(_host(getattr(e, k)),
                              bool if k == "alive" else np.float32)
                for k in EDGE_FIELDS} for e in state.edges],
    )


def planified_state_from_numpy(lat: Mapping, x: Mapping[str, np.ndarray], *,
                               device=None):
    """A :class:`~.ops.planify.PlanifiedState` on ``device`` (default: the
    CUDA device) from numpy fields: ``lat`` in the layout of
    :func:`lattice_state_to_numpy`, ``x`` the exception list's fields
    (``ia``/``ib`` plane cells, the float32 beam fields, ``alive``), as
    :func:`planified_state_to_numpy` returns them.  Carries a state
    embedded by the JAX package into the port without re-embedding."""
    from .ops.planify import EXCEPTION_FIELDS, ExceptionBeams, PlanifiedState

    device = resolve_device(device)
    missing = set(EXCEPTION_FIELDS) - set(x)
    if missing:
        raise ValueError(f"exception list lacks fields {sorted(missing)}")

    def tensor(k, a):
        if k in ("ia", "ib"):
            return torch.from_numpy(np.array(a, np.int64)).to(device)
        return (_bool if k == "alive" else _f32)(a, device)

    return PlanifiedState(
        lat=lattice_state_from_numpy(**lat, device=device),
        x=ExceptionBeams(**{k: tensor(k, x[k]) for k in EXCEPTION_FIELDS}))


def planified_state_to_numpy(ps) -> dict:
    """The inverse of :func:`planified_state_from_numpy`: ``dict(lat=...,
    x=...)`` of numpy arrays (cells int32, as the JAX package keeps
    them).  Works on the JAX package's ``PlanifiedState`` too."""
    from .ops.planify import EXCEPTION_FIELDS

    def field(k):
        a = np.asarray(_host(getattr(ps.x, k)))
        if k in ("ia", "ib"):
            return a.astype(np.int32)
        return a.astype(bool if k == "alive" else np.float32)

    return dict(lat=lattice_state_to_numpy(ps.lat),
                x={k: field(k) for k in EXCEPTION_FIELDS})


def sim_state_from_numpy(*, device=None, inc_beam=None, inc_sign=None,
                         **fields) -> SimState:
    """A :class:`~.state.SimState` on ``device`` (default: the CUDA
    device) from the numpy fields of a general state, as
    :func:`sim_state_to_numpy` returns them (a JAX ``SimState`` read out
    included): ``pos``/``vel``/``acc`` ``[N, 2]``, the particle and beam
    masks, the beam endpoint indices and parameters ``[M]``, and the
    optional incidence ``inc_beam``/``inc_sign`` ``[N, D]``."""
    device = resolve_device(device)
    missing = set(PARTICLE_FIELDS + BEAM_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"state lacks fields {sorted(missing)}")

    def tensor(k, a):
        if k in ("beam_a", "beam_b", "inc_beam"):
            return torch.from_numpy(np.array(a, np.int64)).to(device)
        if k == "inc_sign":
            return torch.from_numpy(np.array(a, np.int8)).to(device)
        if k in ("particle_alive", "particle_pinned", "beam_alive"):
            return _bool(a, device)
        return _f32(a, device)

    out = {k: tensor(k, fields[k]) for k in PARTICLE_FIELDS + BEAM_FIELDS}
    if inc_beam is not None:
        out["inc_beam"] = tensor("inc_beam", inc_beam)
        out["inc_sign"] = tensor("inc_sign", inc_sign)
    return SimState(**out)


def sim_state_to_numpy(state) -> dict:
    """The inverse of :func:`sim_state_from_numpy`: numpy fields (endpoint
    and incidence indices int32, as the JAX package keeps them).  Works on
    any object with the ``SimState`` attributes, the JAX package's
    included; ``inc_beam``/``inc_sign`` are None without an incidence."""
    out = {}
    for k in PARTICLE_FIELDS + BEAM_FIELDS:
        a = np.asarray(_host(getattr(state, k)))
        if k in ("beam_a", "beam_b"):
            a = a.astype(np.int32)
        elif a.dtype != bool:
            a = a.astype(np.float32)
        out[k] = a
    inc = getattr(state, "inc_beam", None)
    out["inc_beam"] = (None if inc is None
                       else np.asarray(_host(inc)).astype(np.int32))
    out["inc_sign"] = (None if inc is None
                       else np.asarray(_host(state.inc_sign)).astype(np.int8))
    return out


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def constants_from_numpy(gravity, border_elasticity, border_friction,
                         elasticity, friction, drag_coeff,
                         drag_exp) -> PhysicsConstants:
    """:class:`PhysicsConstants` from numpy scalars (``gravity`` ``[2]``)."""
    g = np.asarray(gravity, np.float32).reshape(2)
    return PhysicsConstants(
        gravity=(float(g[0]), float(g[1])),
        border_elasticity=float(np.float32(border_elasticity)),
        border_friction=float(np.float32(border_friction)),
        elasticity=float(np.float32(elasticity)),
        friction=float(np.float32(friction)),
        drag_coeff=float(np.float32(drag_coeff)),
        drag_exp=float(np.float32(drag_exp)),
    )


def user_input_from_numpy(user_strength, mouse_active, mouse_pos, mouse_vel,
                          applied_force) -> UserInput:
    """:class:`UserInput` from numpy scalars and ``[2]`` vectors."""
    def vec(v):
        a = np.asarray(v, np.float32).reshape(2)
        return (float(a[0]), float(a[1]))

    return UserInput(
        user_strength=float(np.float32(user_strength)),
        mouse_active=bool(np.asarray(mouse_active)),
        mouse_pos=vec(mouse_pos),
        mouse_vel=vec(mouse_vel),
        applied_force=vec(applied_force),
    )
