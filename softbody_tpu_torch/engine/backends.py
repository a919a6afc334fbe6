"""Lattice engine backends (port of ``softbody_tpu/engine/backends.py``,
the fused lattice backend and the base it uses).

:class:`FusedLatticeBackend` steps persistent packed planes with the
fused substep kernel (K1) and, when far field is armed, the fixed-cadence
far-field frame (rebuilds with the band kernel K2).  Only the strict
physics is ported: the backend raises on any kernel variant, far mode,
detection mode or band implementation it does not run, instead of
dropping it."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import PhysicsConstants, StaticConfig, UserInput
from ..ops.cuda.fused_substep2 import (
    ALIVE,
    EAL,
    N_HOT,
    fused_frame2,
    fused_frame4,
    pack_lattice2,
    unpack_lattice2,
)
from ..ops.stencil import LatticeState

FAR_BANDS = {"cuda": "kernel", "cpu": "plain"}


class LatticeBackend:
    """Base of the lattice backends: static configuration, far-field
    stats and alive counts."""

    def __init__(self, spec, cfg: StaticConfig, farfield=None) -> None:
        self.spec = spec
        self.cfg = cfg
        self.ff = farfield
        self.far_rebuilds = 0
        self.far_pairs = 0
        self.far_overflow = 0

    def far_stats(self) -> dict:
        return {"far_rebuilds": self.far_rebuilds,
                "far_pairs": self.far_pairs,
                "far_overflow": self.far_overflow}

    def counts(self, state: LatticeState) -> Tuple[int, int]:
        """(alive particles, alive beams), in one host read."""
        n = torch.stack([state.alive.sum()]
                        + [e.alive.sum() for e in state.edges]).tolist()
        return int(n[0]), int(sum(n[1:]))


def _stats_merge(a, b):
    """Accumulate frame stats: the rebuild count sums, the rest take the
    running max."""
    return [a[0] + b[0]] + [max(x, y) for x, y in zip(a[1:], b[1:])]


class FusedLatticeBackend(LatticeBackend):
    """Lattice backend over packed planes ``(hot [18,W,H], obs [8,W,H])``
    on ``device``; the immutable planes and edge constants live on the
    backend (edge parameters must be uniform per class).

    ``far_band``: ``"kernel"`` on CUDA, ``"plain"`` on the CPU (None
    picks it from ``device``); the band wrapper itself dispatches on the
    tensor's device, so any other value is an error.  ``far_mode`` must
    be ``"v4"``, ``far_detect`` ``"xla"``, ``far_activation`` False and
    ``kernel_variants`` empty: the strict path is the one ported."""

    def __init__(self, spec, cfg: StaticConfig, farfield=None, *,
                 device="cpu", far_mode: str = "v4",
                 far_buckets: Optional[Tuple[int, ...]] = None,
                 far_band: Optional[str] = None, far_detect: str = "xla",
                 far_activation: bool = False,
                 kernel_variants: Tuple[str, ...] = ()) -> None:
        super().__init__(spec, cfg, farfield=farfield)
        self.device = torch.device(device)
        if self.device.type not in FAR_BANDS:
            raise ValueError(f"no kernels for device {self.device}")
        if tuple(kernel_variants):
            raise ValueError(
                f"kernel variants {tuple(kernel_variants)!r} are not ported: "
                "only the strict path (kernel_variants=()) runs")
        if far_mode != "v4":
            raise ValueError(f"far_mode {far_mode!r} is not ported "
                             "(only 'v4')")
        if far_detect != "xla":
            raise ValueError(f"far_detect {far_detect!r} is not ported "
                             "(only 'xla')")
        if far_activation:
            raise ValueError("far_activation is not ported")
        want = FAR_BANDS[self.device.type]
        if far_band is None:
            far_band = want
        if far_band != want:
            raise ValueError(f"far_band {far_band!r} on {self.device.type}: "
                             f"the band pass there is {want!r}")
        self.far_band = far_band
        self.far_mode = far_mode
        self.far_buckets = far_buckets
        self._immut = None
        self._edge_consts = None
        self._template = None
        self._stats_acc = None

    def pack_state(self, lstate: LatticeState):
        """LatticeState (on the backend's device) → packed ``(hot, obs)``;
        keeps the immutable planes, edge constants and a template."""
        if lstate.shape != (self.spec.width, self.spec.height):
            raise ValueError(f"state {lstate.shape} does not match spec "
                             f"{(self.spec.width, self.spec.height)}")
        if lstate.device.type != self.device.type:
            raise ValueError(f"state on {lstate.device}, backend on "
                             f"{self.device}")
        hot, obs, immut, ec = pack_lattice2(lstate)
        self._immut = immut
        self._edge_consts = ec
        self._template = lstate
        return hot, obs

    def unpack_state(self, state) -> LatticeState:
        hot, obs = state
        return unpack_lattice2(hot, obs, self._template)

    def step(self, state, consts: PhysicsConstants, uin: UserInput):
        """One frame.  Far-field armed: the fixed-cadence frame, stats
        accumulated on the host (``far_stats``)."""
        hot, obs = state
        if self.ff is None or self.cfg.collision_mode == "none":
            return fused_frame2(hot, obs, self._immut, self._edge_consts,
                                consts, uin, self.spec, self.cfg)
        kw = {} if self.far_buckets is None else {"buckets": self.far_buckets}
        hot, obs, st = fused_frame4(hot, obs, self._immut, self._edge_consts,
                                    consts, uin, self.spec, self.cfg, self.ff,
                                    **kw)
        st = st.tolist()
        self._stats_acc = (st if self._stats_acc is None
                           else _stats_merge(self._stats_acc, st))
        return hot, obs

    def far_stats(self) -> dict:
        """Stats since the last read (the accumulator resets on read):
        total rebuilds, max n_pairs, max overflow, max active pairs."""
        if self._stats_acc is None:
            return super().far_stats()
        vals, self._stats_acc = self._stats_acc, None
        return {"far_rebuilds": vals[0], "far_pairs": vals[1],
                "far_overflow": vals[2], "far_active": vals[3]}

    def counts(self, state) -> Tuple[int, int]:
        """(alive particles, alive beams) from the packed planes."""
        hot, _obs = state
        eal = hot[[6 + 3 * c + EAL for c in range((N_HOT - 6) // 3)]]
        n = torch.stack([(self._immut[ALIVE] > 0).sum(),
                         (eal > 0).sum()]).tolist()
        return int(n[0]), int(n[1])
