"""BASELINE config 3, the 100k-particle self-colliding cloth, at its
published size: ``models.scenes.self_colliding_cloth(100_000)`` (a 632 ×
158 sheet dropped onto the floor, where it folds onto itself), embedded
into planes by ``PlanifiedBackend`` with ``use_pallas`` (K3) and the far
field armed as ``cli.py run --path planified --farfield`` arms it
(``FarFieldSpec(skin=3·radius, horizon=8)``) but with the 1M sheet's
capacity of 16384 pairs (the CLI's 512 overflows on this embedding from
frame 1), stepped through its captured ``planified_frame_far_jit``."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import torch

from simbench import roofline
from simbench.reference import physics, scenes

PARAMS = json.loads(pathlib.Path(__file__).with_suffix(".json").read_text())
SOURCE = ("https://github.com/spsquared/softbody-webgpu (the app ported; "
          "BASELINE.json configs[2]: 100k-particle cloth with spatial-hash "
          "broad-phase self-collision, on the planified path)")
REDUCED = PARAMS["reduced"]


class Sim:
    """The program at this configuration (see ``tearing_cloth_1m.Sim``)."""

    PARAMS = PARAMS

    def __init__(self, seed: int, device) -> None:
        from softbody_tpu_torch.config import PhysicsConstants, UserInput
        from softbody_tpu_torch.engine.backends import PlanifiedBackend
        from softbody_tpu_torch.models.scenes import self_colliding_cloth
        from softbody_tpu_torch.ops.farfield import FarFieldSpec

        p = self.params = dict(self.PARAMS)
        flat, cfg = self_colliding_cloth(p["n_particles"], spring=p["spring"],
                                         damp=p["damp"], device=device)
        cfg = dataclasses.replace(cfg, use_pallas=p["use_pallas"])
        n = flat.pos.shape[0]
        self.ref_world, self.ref_consts, _shape, self.spacing = (
            scenes.cloth_sheet(p, seed, device))
        self._check_published(cfg)
        flat = dataclasses.replace(flat, vel=flat.vel + (
            scenes.velocity_jitter((n,), p["jitter"], seed, device)))
        f = p["far_field"]
        self.ff = FarFieldSpec(skin=f["skin_radii"] * cfg.particle_radius,
                               horizon=f["horizon"],
                               max_pairs=f["max_pairs"],
                               max_tile_pairs=f["max_tile_pairs"])
        self.cfg, self.consts, self.uin = cfg, PhysicsConstants.default(), (
            UserInput.none())
        self.be = PlanifiedBackend(cfg, collision_stencil=p[
            "collision_stencil"], farfield=self.ff, device=device)
        self.initial = self.be.pack_state(flat)
        self.substeps_per_frame = cfg.subticks
        self.device = torch.device(device)

    def _check_published(self, cfg) -> None:
        p = self.params
        want = {
            "subticks": (cfg.subticks, p["subticks"]),
            "bounds": (cfg.bounds_size, p["bounds"]),
            "radius": (scenes.f32(cfg.particle_radius),
                       scenes.f32(self.spacing * p["radius_scale"])),
            "force_mode": (cfg.force_mode, p["force_mode"]),
        }
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad:
            raise RuntimeError(f"the program's scene departs from "
                               f"{p['name']}: {bad}")

    def step(self, state):
        return self.be.step(state, self.consts, self.uin)

    def far_stats(self) -> dict:
        return self.be.far_stats()

    def outcome(self, state) -> torch.Tensor:
        """``[far overflow, not finite]`` (see ``tearing_cloth_1m``)."""
        acc, self.be._stats_acc = self.be._stats_acc, None
        lat = state.lat
        bad = ~(torch.isfinite(lat.pos).all() & torch.isfinite(lat.vel).all())
        over = (acc[2] if acc is not None
                else torch.zeros((), dtype=torch.int32, device=bad.device))
        return torch.stack([over.to(torch.int32), bad.to(torch.int32)])

    def world(self, state) -> physics.World:
        """The program's state, unplanified, read into the reference's
        flat world."""
        s = self.be.unpack_state(state)
        n = s.pos.shape[0]
        return physics.World(
            pos=s.pos.float(), vel=s.vel.float(), acc=s.acc.float(),
            alive=s.particle_alive.bool(), pinned=s.particle_pinned.bool(),
            lin=torch.arange(n, device=s.pos.device),
            a=s.beam_a.long(), b=s.beam_b.long(),
            length=s.beam_length.float(), target=s.beam_target_length.float(),
            last=s.beam_last_length.float(), spring=s.beam_spring.float(),
            damp=s.beam_damp.float(),
            yield_strain=s.beam_yield_strain.float(),
            strain_limit=s.beam_strain_limit.float(),
            beam_alive=s.beam_alive.bool())

    def probes(self, state) -> dict:
        """K3 on the embedding's planes at ``state``, as the frame calls
        it (on the state's interleaved views)."""
        from softbody_tpu_torch.ops.cuda.collide_stencil import (
            collide_stencil_call)

        lat = state.lat
        s = self.be.spec.collision_stencil
        views = (lat.pos[..., 0], lat.pos[..., 1], lat.vel[..., 0],
                 lat.vel[..., 1])
        kw = dict(radius=self.cfg.particle_radius, dt=self.cfg.dt,
                  ecoeff=self.consts.ecoeff, friction=self.consts.friction,
                  stencil=s)
        n = lat.alive.numel()
        return {"k3": roofline.Probe(
            lambda: collide_stencil_call(*views, lat.alive, **kw), 50,
            roofline.bound(roofline.k3_bytes(n), roofline.k3_ops(n, s)))}
