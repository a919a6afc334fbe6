"""BASELINE config 5, the 1M-particle tearing cloth, at its published
size: ``tearing_cloth_lattice(1_000_000)`` (1000 × 1000 particles, ~3.98M
springs, stencil r = 2, 64 substeps a frame) with the sizes of the file
beside this one, stepped by ``FusedLatticeBackend(...).step`` with its
default kernel variants and the v4 far field, as bench.py runs it: one
captured ``fused_frame4`` graph a frame.  The viewer drives the same
world behind ``LatticeEngine(fused=True)``."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import torch

from simbench import roofline
from simbench.reference import physics, scenes

PARAMS = json.loads(pathlib.Path(__file__).with_suffix(".json").read_text())
SOURCE = ("https://github.com/spsquared/softbody-webgpu (the app this "
          "repository ports; BASELINE.json configs[4], 1M particles / 4M "
          "springs tearing cloth, run as bench.py:79-107 runs it)")
REDUCED = PARAMS["reduced"]


class Sim:
    """The program at this configuration, built from ``seed`` on
    ``device``: ``initial`` (the packed state), ``step`` (one frame, the
    entry the window drives), ``far_stats`` (the far field's counters
    since the last read), ``outcome`` (the far list's overflow since the last read and
    whether a state is finite, on the device), ``world`` (a state read
    into the reference's flat world), the reference's own scene built
    from the same seed, and ``near``, the collision stencil as the
    reference states it.  The sizes are :attr:`PARAMS`, the file
    beside this one."""

    PARAMS = PARAMS

    def __init__(self, seed: int, device) -> None:
        from softbody_tpu_torch.config import UserInput
        from softbody_tpu_torch.engine.backends import FusedLatticeBackend
        from softbody_tpu_torch.models.lattice_dense import (
            tearing_cloth_lattice)
        from softbody_tpu_torch.ops.farfield import FarFieldSpec

        p = self.params = dict(self.PARAMS)
        state, spec, cfg, consts = tearing_cloth_lattice(
            n_particles=p["n_particles"], spring=p["spring"],
            damp=p["damp"], strain_limit=p["strain_limit"],
            yield_strain=p["yield_strain"],
            collision_stencil=p["collision_stencil"],
            fall_speed=p["fall_speed"], slits=p["slits"], device=device)
        w, h = state.shape
        self.spacing = 980.0 / (w - 1)
        self.near = (p["collision_stencil"], h)
        self._check_published(cfg, consts)
        state = dataclasses.replace(state, vel=state.vel + (
            scenes.velocity_jitter((w, h), p["jitter"], seed, device)))
        f = p["far_field"]
        self.ff = FarFieldSpec(
            chunk=f["chunk"], tile_chunks=f["tile_chunks"],
            max_pairs=f["max_pairs"], max_tile_pairs=f["max_tile_pairs"],
            skin=f["skin_spacings"] * self.spacing, horizon=f["horizon"])
        self.spec, self.cfg, self.consts = spec, cfg, consts
        self.uin = UserInput()
        self.lstate = state
        self.be = FusedLatticeBackend(spec, cfg, farfield=self.ff,
                                      device=device)
        self.initial = self.be.pack_state(state)
        self.substeps_per_frame = cfg.subticks
        self.device = torch.device(device)
        self.ref_world, self.ref_consts, _shape, _sp = scenes.tearing_sheet(
            p, seed, device)

    def _check_published(self, cfg, consts) -> None:
        """The program's scene against the sizes this configuration
        states; a drift raises."""
        p = self.params
        want = {
            "subticks": (cfg.subticks, p["subticks"]),
            "bounds": (cfg.bounds_size, p["bounds"]),
            "radius": (scenes.f32(cfg.particle_radius),
                       scenes.f32(self.spacing * p["radius_scale"])),
            "gravity": (consts.gravity[1],
                        scenes.f32(p["gravity"] * self.spacing / 10.0)),
            "force_mode": (cfg.force_mode, p["force_mode"]),
        }
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad:
            raise RuntimeError(f"the program's scene departs from "
                               f"{p['name']}: {bad}")

    def step(self, state):
        return self.be.step(state, self.consts, self.uin)

    def step_without_far(self, state):
        """The frame with its far apply left out (the same backend with no
        far field): a fault the check has to catch."""
        if not hasattr(self, "_be_nofar"):
            from softbody_tpu_torch.engine.backends import (
                FusedLatticeBackend)
            self._be_nofar = FusedLatticeBackend(self.spec, self.cfg,
                                                 device=self.device)
            self._be_nofar.pack_state(self.lstate)
        return self._be_nofar.step(state, self.consts, self.uin)

    def far_stats(self) -> dict:
        return self.be.far_stats()

    def outcome(self, state) -> torch.Tensor:
        """``[far overflow, not finite]`` (int32, on the device): the
        largest overflow of the frames since the last read (the
        backend's device accumulator, taken as ``far_stats()`` takes it
        but not read) and whether ``state``'s particles are not all
        finite."""
        acc, self.be._stats_acc = self.be._stats_acc, None
        bad = ~torch.isfinite(state[0][:6]).all()
        over = (acc[2] if acc is not None
                else torch.zeros((), dtype=torch.int32, device=bad.device))
        return torch.stack([over.to(torch.int32), bad.to(torch.int32)])

    def world(self, state) -> physics.World:
        """The program's state read into the reference's flat world (the
        edge classes as beams ``[4·W·H]``, class by class)."""
        ls = self.be.unpack_state(state)
        ref = self.ref_world

        def cat(field):
            return torch.cat([getattr(e, field).reshape(-1)
                              for e in ls.edges])

        return physics.World(
            pos=ls.pos.reshape(-1, 2).float(),
            vel=ls.vel.reshape(-1, 2).float(),
            acc=ls.acc.reshape(-1, 2).float(),
            alive=ls.alive.reshape(-1).bool(),
            pinned=ls.pinned.reshape(-1).bool(), lin=ref.lin, a=ref.a,
            b=ref.b, length=cat("length").float(),
            target=cat("target_length").float(),
            last=cat("last_length").float(), spring=cat("spring").float(),
            damp=cat("damp").float(),
            yield_strain=cat("yield_strain").float(),
            strain_limit=cat("strain_limit").float(),
            beam_alive=cat("alive").bool())

    def probes(self, state) -> dict:
        """The layers the per-layer readers time at ``state``: the far
        apply (``ops/farfield4.py``) on the list rebuilt there, the
        rebuild (``ops/farfield.py`` with K2), and K1 in the frame's
        instance with the device constants and far deltas the frame
        gives it."""
        from softbody_tpu_torch.ops.cuda.fused_substep2 import (
            NARROW_MAX, PX, PY, VX, VY, _frame_consts, fused_substep2_call,
            pack_lattice2)
        from softbody_tpu_torch.ops.farfield import rebuild_far_list_planes
        from softbody_tpu_torch.ops.farfield4 import (
            bucketed_far_delta_planes)

        hot, _obs = state
        _h, _o, immut, ec = pack_lattice2(self.be.unpack_state(state))
        alive = immut[0] > 0.0
        cfg, consts = self.cfg, self.consts
        kw = dict(s=self.spec.collision_stencil, ff=self.ff,
                  radius=cfg.particle_radius)

        def rebuild():
            return rebuild_far_list_planes(hot[PX], hot[PY], alive,
                                           vx=hot[VX], vy=hot[VY], dt=cfg.dt,
                                           **kw)

        fl = rebuild()
        n_pairs, _overflow = fl.counts()
        far_kw = dict(dt=cfg.dt, ecoeff=consts.ecoeff,
                      friction=consts.friction,
                      buckets=tuple(self.params["far_field"]["buckets"]),
                      narrow_max=0 if "krec" in self.be.kvar else NARROW_MAX,
                      **kw)

        def apply():
            return bucketed_far_delta_planes(hot, immut[0], fl, n_pairs,
                                             **far_kw)

        far = apply() if n_pairs else torch.zeros_like(hot[:5])
        cvec, k1kw = _frame_consts(consts, self.uin, self.spec, cfg, ec,
                                   self.be.kvar,
                                   hot.device)
        n = hot.shape[1] * hot.shape[2]
        return {
            "far_apply": roofline.Probe(apply if n_pairs else None, 3),
            "rebuild": roofline.Probe(rebuild, 5),
            "k1": roofline.Probe(lambda: fused_substep2_call(hot, immut, cvec,
                                                    far=far, **k1kw), 50,
                        roofline.bound(roofline.k1_bytes(n),
                                       roofline.substep_ops(
                                           n, self.spec.collision_stencil))),
        }
