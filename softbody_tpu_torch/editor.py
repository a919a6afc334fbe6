"""Programmatic scene editor (component C8 — ≙ ``SoftbodyEditor``,
editor.ts:4-884): the port of ``softbody_tpu/editor.py``.

The reference editor is a Canvas2D mouse/keyboard tool on the main
thread.  The port keeps the *semantics* as a headless, event-driven
API (UI toolkits can layer on top): the same action state machine
(editor.ts:143-215), hit-testing margins, snap-to-grid, rectangle
selection with segment-intersection tests, auto-triangulation, velocity
fling on particle add, beam-settings painting, and camera pan/zoom.

Event surface:

- ``pointer_down/ pointer_move / pointer_up(world_pos)``
- modifier state: ``delete_mode`` (shift), ``force_add_mode`` (alt),
  ``select_mode`` (ctrl) — editor.ts:23-27
- ``key(k)`` for delete/escape/'r' — editor.ts:476-504

Editing operates on a :class:`~softbody_tpu_torch.mapping.SceneRegistry`
on the host; the snapshot ArrayBuffer remains the single interchange
format with the engine (≙ SURVEY.md §3.5).  Only :meth:`render` touches
the device: ``device`` (default: the CUDA device) is where it
rasterizes."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Set

from .config import PhysicsConstants
from .mapping import BeamObj, ParticleObj, SceneRegistry, Vec2


@dataclasses.dataclass
class BeamSettings:
    """Settings painted onto new/hovered beams (editor.ts:163-168)."""

    spring: float = 10.0
    damp: float = 10.0
    yield_strain: float = 0.1
    strain_limit: float = 1.0


@dataclasses.dataclass
class Camera:
    """Pan/zoom state (editor.ts:78-81): ``p`` is the world-space origin
    of the view, ``s`` the zoom in [1, 10]."""

    p: Vec2 = dataclasses.field(default_factory=Vec2)
    s: float = 1.0


class SoftbodyEditor:
    def __init__(
        self,
        registry: Optional[SceneRegistry] = None,
        *,
        bounds_size: float = 1000.0,
        particle_radius: float = 10.0,
        device=None,
    ) -> None:
        self.registry = registry or SceneRegistry()
        self.device = device
        self.bounds_size = bounds_size
        self.particle_radius = particle_radius
        self.camera = Camera()

        self.edit_mode: str = "beam"  # 'particle' | 'beam' (editor.ts:157)
        self.delete_mode = False
        self.force_add_mode = False
        self.select_mode = False
        self.beam_settings = BeamSettings()
        self.auto_triangulate_distance: float = 0.0
        self.snap_grid_size: float = 0.0

        self.hover_particle: Optional[ParticleObj] = None
        self.hover_beam: Optional[BeamObj] = None
        self.selected_particles: Set[ParticleObj] = set()
        self.selected_beams: Set[BeamObj] = set()

        self._active_particle: Optional[ParticleObj] = None
        self._active_particle_type: str = "add"
        self._move_origin: dict = {}
        self._active_beam: Optional[BeamObj] = None
        self._select_box: Optional[tuple] = None
        self._auto_tri_targets: Set[ParticleObj] = set()
        self._mouse = Vec2()

    # ---- snapshots (editor.ts:115-120) ----

    def load(self, buf: bytes) -> bool:
        return self.registry.load(buf)

    def save(self) -> bytes:
        return self.registry.save()

    def set_physics_constants(self, c: PhysicsConstants) -> None:
        self.registry.constants = c

    def get_physics_constants(self) -> PhysicsConstants:
        return self.registry.constants

    # ---- mode switching (editor.ts:505-513) ----

    def set_edit_mode(self, mode: str) -> None:
        if mode not in ("particle", "beam"):
            raise ValueError(mode)
        self.pointer_up(self._mouse)  # end any running action
        self.selected_particles.clear()
        self.selected_beams.clear()
        self.edit_mode = mode

    # ---- geometry helpers ----

    def _snap(self, p: Vec2) -> Vec2:
        """Clamp into the world and snap to the grid (editor.ts:132-141)."""
        r = self.particle_radius
        g = self.snap_grid_size
        if g > 0:
            hi = math.floor((self.bounds_size - 2 * r) / g) * g + r
        else:
            hi = self.bounds_size - r
        c = p.clamp(Vec2(r, r), Vec2(hi, hi))
        if g > 0:
            return Vec2(
                round((c.x - r) / g) * g + r,
                round((c.y - r) / g) * g + r,
            )
        return c

    def _particle_margin(self) -> float:
        # click-assist margins shrink as you zoom in (editor.ts:352-353)
        return self.particle_radius * max(1.0, 2.0 - 2.0 * self.camera.s / 10.0)

    def _beam_margin(self) -> float:
        return max(4.0, 10.0 - 8.0 * self.camera.s / 10.0)

    def _closest_particle(self, p: Vec2, exclude: Set[ParticleObj]) -> Optional[ParticleObj]:
        best, best_d = None, math.inf
        margin = self._particle_margin()
        for part in self.registry.particles:
            if part in exclude:
                continue
            d = (part.position - p).magnitude
            if d < best_d and d < margin:
                best, best_d = part, d
        return best

    def _beam_endpoints(self, b: BeamObj):
        pa = self.registry.find_particle(b.a)
        pb = self.registry.find_particle(b.b)
        return (
            pa.position if pa else Vec2(),
            pb.position if pb else Vec2(),
        )

    def _closest_beam(self, p: Vec2) -> Optional[BeamObj]:
        """Point-to-segment distance hit test (editor.ts:376-388)."""
        best, best_d = None, math.inf
        margin = self._beam_margin()
        for b in self.registry.beams:
            a, q = self._beam_endpoints(b)
            d = q - a
            len2 = d.dot(d)
            t = max(0.0, min((p - a).dot(d) / len2, 1.0)) if len2 else 0.0
            closest = a + d * t
            dist = (p - closest).magnitude
            if dist < best_d and dist < margin:
                best, best_d = b, dist
        return best

    def _update_hover(self) -> None:
        exclude: Set[ParticleObj] = set()
        if self._active_beam is not None:
            for pid in (self._active_beam.a, self._active_beam.b):
                pp = self.registry.find_particle(pid)
                if pp is not None:
                    exclude.add(pp)
        if self._active_particle is not None:
            exclude.add(self._active_particle)
        self.hover_particle = self._closest_particle(self._mouse, exclude)
        self.hover_beam = self._closest_beam(self._mouse)

    # ---- pointer events (start/update/endAction, editor.ts:216-475) ----

    def pointer_move(self, p: Vec2) -> None:
        self._mouse = p
        self._update_hover()
        if self._select_box is not None:
            self._select_box = (self._select_box[0], p)
            self._apply_select_box()
        elif self.edit_mode == "particle" and self._active_particle is not None:
            if self._active_particle_type == "move":
                diff = p - self._move_origin[0]
                targets = (
                    self.selected_particles
                    if self._active_particle in self.selected_particles
                    else {self._active_particle}
                )
                for t in targets:
                    if t in self._move_origin:
                        t.position = self._snap(self._move_origin[t] + diff)
        elif self.edit_mode == "beam" and self._active_beam is not None:
            endpoint = self.registry.find_particle(self._active_beam.b)
            if endpoint is not None:
                endpoint.position = self._snap(p)
                self._collect_auto_triangulate(endpoint)

    def pointer_down(self, p: Vec2) -> None:
        self.pointer_move(p)
        reg = self.registry
        if self.select_mode:
            self._select_box = (p, p)
            self.selected_particles.clear()
            self.selected_beams.clear()
            self._apply_select_box()
            return
        if self.edit_mode == "particle":
            if self.delete_mode:
                if self.hover_particle is not None:
                    for b in reg.connected_beams(self.hover_particle):
                        reg.remove_beam(b)
                    reg.remove_particle(self.hover_particle)
                    self.hover_particle = None
                    self.selected_particles.clear()
            elif self.hover_particle is not None and not self.force_add_mode:
                # begin move (whole selection if the grabbed one is in it)
                self._active_particle = self.hover_particle
                self._active_particle_type = "move"
                self._move_origin = {0: p, self._active_particle: self._active_particle.position}
                if self._active_particle in self.selected_particles:
                    for sp in self.selected_particles:
                        self._move_origin[sp] = sp.position
                else:
                    self.selected_particles.clear()
            else:
                # add particle; velocity set by drag on release (fling)
                pid = reg.first_empty_particle_id
                if pid >= 0:
                    self._active_particle = ParticleObj(pid, self._snap(p))
                    reg.add_particle(self._active_particle)
                    self._active_particle_type = "add"
                    self.selected_particles.clear()
        else:  # beam mode
            if self.delete_mode:
                if self.hover_beam is not None:
                    reg.remove_beam(self.hover_beam)
                    self.hover_beam = None
                    self.selected_beams.clear()
            elif self.hover_particle is not None and not self.force_add_mode:
                # new beam from an existing particle to a fresh endpoint
                endpoint = ParticleObj(reg.first_empty_particle_id, self._snap(p))
                reg.add_particle(endpoint)
                self._active_beam = BeamObj(
                    reg.first_empty_beam_id, self.hover_particle.id, endpoint.id
                )
                reg.add_beam(self._active_beam)
                self.selected_beams.clear()
            elif self.hover_beam is not None and not self.force_add_mode:
                # paint settings onto hovered beam (and selection)
                self._paint(self.hover_beam)
                if self.hover_beam in self.selected_beams:
                    for b in self.selected_beams:
                        self._paint(b)
            else:
                # new beam from two fresh particles
                p1 = ParticleObj(reg.first_empty_particle_id, self._snap(p))
                reg.add_particle(p1)
                p2 = ParticleObj(reg.first_empty_particle_id, self._snap(p))
                reg.add_particle(p2)
                self._active_beam = BeamObj(
                    reg.first_empty_beam_id, p1.id, p2.id
                )
                reg.add_beam(self._active_beam)
                self.selected_beams.clear()

    def pointer_up(self, p: Vec2) -> None:
        self._mouse = p
        reg = self.registry
        if self._select_box is not None:
            self._select_box = None
            return
        if self.edit_mode == "particle" and self._active_particle is not None:
            if self._active_particle_type == "add":
                # fling: velocity = drag vector (editor.ts:310-313)
                self._active_particle.velocity = p - self._active_particle.position
            self._active_particle = None
            self._move_origin = {}
        elif self.edit_mode == "beam" and self._active_beam is not None:
            beam = self._active_beam
            self._update_hover()
            if self.hover_particle is not None and not self.force_add_mode:
                # snap the endpoint onto the hovered existing particle
                reg.remove_particle(beam.b)
                reg.remove_beam(beam)
                beam = BeamObj(beam.id, beam.a, self.hover_particle.id)
                reg.add_beam(beam)
            a, b_ = self._beam_endpoints(beam)
            beam.length = (a - b_).magnitude
            beam.target_length = beam.length
            beam.last_length = beam.length
            self._paint(beam)
            # auto-triangulation (editor.ts:339-343)
            if self.auto_triangulate_distance > 0:
                endpoint = self.registry.find_particle(beam.b)
                for t in self._auto_tri_targets:
                    if endpoint is None or t.id == beam.b:
                        continue
                    bid = reg.first_empty_beam_id
                    nb = BeamObj(
                        bid, beam.b, t.id,
                        length=(b_ - t.position).magnitude,
                        spring=self.beam_settings.spring,
                        damp=self.beam_settings.damp,
                        yield_strain=self.beam_settings.yield_strain,
                        strain_limit=self.beam_settings.strain_limit,
                    )
                    reg.add_beam(nb)
            self._auto_tri_targets.clear()
            self._active_beam = None

    def _paint(self, b: BeamObj) -> None:
        b.spring = self.beam_settings.spring
        b.damp = self.beam_settings.damp
        b.yield_strain = self.beam_settings.yield_strain
        b.strain_limit = self.beam_settings.strain_limit

    def _collect_auto_triangulate(self, endpoint: ParticleObj) -> None:
        self._auto_tri_targets.clear()
        if self.auto_triangulate_distance <= 0 or self._active_beam is None:
            return
        a_id = self._active_beam.a
        for part in self.registry.particles:
            if part.id in (a_id, endpoint.id):
                continue
            if self.hover_particle is not None and not self.force_add_mode:
                if part is self.hover_particle:
                    continue
            if (part.position - endpoint.position).magnitude <= self.auto_triangulate_distance:
                self._auto_tri_targets.add(part)

    # ---- rectangle selection (editor.ts:390-433) ----

    def _apply_select_box(self) -> None:
        (a, b) = self._select_box
        left, right = min(a.x, b.x), max(a.x, b.x)
        bottom, top = min(a.y, b.y), max(a.y, b.y)
        if self.edit_mode == "particle":
            self.selected_particles = {
                p for p in self.registry.particles
                if left <= p.position.x <= right and bottom <= p.position.y <= top
            }
        else:
            box = [
                Vec2(left, top), Vec2(right, top),
                Vec2(right, bottom), Vec2(left, bottom),
            ]
            sel = set()
            for beam in self.registry.beams:
                p, q = self._beam_endpoints(beam)
                if (left <= p.x <= right and bottom <= p.y <= top) or (
                    left <= q.x <= right and bottom <= q.y <= top
                ):
                    sel.add(beam)
                    continue
                for i in range(4):
                    u, v = box[i], box[(i + 1) % 4]
                    if (
                        Vec2.turn_direction(u, v, p) != Vec2.turn_direction(u, v, q)
                        and Vec2.turn_direction(p, q, u) != Vec2.turn_direction(p, q, v)
                    ):
                        sel.add(beam)
                        break
            self.selected_beams = sel

    # ---- keyboard actions (editor.ts:476-504) ----

    def key(self, k: str) -> None:
        k = k.lower()
        reg = self.registry
        if k in ("backspace", "delete"):
            if self.edit_mode == "particle":
                for p in self.selected_particles:
                    for b in reg.connected_beams(p):
                        reg.remove_beam(b)
                    reg.remove_particle(p)
                self.selected_particles.clear()
            else:
                for b in self.selected_beams:
                    reg.remove_beam(b)
                self.selected_beams.clear()
        elif k == "escape":
            self.selected_particles.clear()
            self.selected_beams.clear()
        elif k == "r" and self.edit_mode == "beam":
            # reset beam rest state to current geometry (editor.ts:495-503)
            for b in self.selected_beams:
                p, q = self._beam_endpoints(b)
                b.length = (p - q).magnitude
                b.target_length = b.length
                b.last_length = b.length

    # ---- camera (editor.ts:546-574) ----

    def zoom(self, factor: float, pivot: Optional[Vec2] = None) -> None:
        old = self.camera.s
        self.camera.s = max(1.0, min(self.camera.s * factor, 10.0))
        if pivot is not None and self.camera.s != old:
            # keep the pivot stationary on screen
            frac = Vec2(
                (pivot.x - self.camera.p.x) * old / self.bounds_size,
                (pivot.y - self.camera.p.y) * old / self.bounds_size,
            )
            self.camera.p = Vec2(
                pivot.x - frac.x * self.bounds_size / self.camera.s,
                pivot.y - frac.y * self.bounds_size / self.camera.s,
            )
        self._clamp_camera()

    def pan(self, delta: Vec2) -> None:
        self.camera.p = self.camera.p + delta
        self._clamp_camera()

    def _clamp_camera(self) -> None:
        span = self.bounds_size - self.bounds_size / self.camera.s
        self.camera.p = self.camera.p.clamp(Vec2(0, 0), Vec2(span, span))

    # ---- rendering (CPU twin of the stress coloring, editor.ts:630-645) ----

    @property
    def fps(self) -> float:
        """Rolling 1 s render-call count (≙ editor.ts:782-790)."""
        import time as _time

        now = _time.monotonic()
        self._frame_times = [t for t in getattr(self, "_frame_times", [])
                             if t > now - 1.0]
        return float(len(self._frame_times))

    def render(self, resolution: int = 512, overlay: bool = True):
        """Rasterize the current scene via the device renderer, with the
        same stress/strain beam coloring the reference editor computes on
        CPU, plus the visual feedback layer (snap grid, velocity vectors,
        dashed invalid beams, selection outlines, HUD — editor.ts:575-854)
        unless ``overlay=False``."""
        import time as _time

        self._frame_times = getattr(self, "_frame_times", [])
        self._frame_times.append(_time.monotonic())
        from .viz import render_packet

        state = self.registry.to_state(build_incidence=False, device="cpu")
        import numpy as np

        class _Pkt:
            pass

        pkt = _Pkt()
        pkt.pos = state.pos.numpy()
        pkt.particle_alive = state.particle_alive.numpy()
        pkt.beam_a = state.beam_a.numpy()
        pkt.beam_b = state.beam_b.numpy()
        pkt.beam_alive = state.beam_alive.numpy()
        # CPU stress/strain twin (editor.ts:637-639)
        pa = pkt.pos[pkt.beam_a]
        pb = pkt.pos[pkt.beam_b]
        ln = np.sqrt(((pa - pb) ** 2).sum(-1))
        tl = state.beam_target_length.numpy()
        ll = state.beam_last_length.numpy()
        length = np.maximum(state.beam_length.numpy(), 1e-9)
        spring = state.beam_spring.numpy()
        damp = state.beam_damp.numpy()
        limit = np.maximum(state.beam_strain_limit.numpy(), 1e-9)
        pkt.beam_stress = ((tl - ln) * spring + (ll - ln) * damp) / 20.0
        pkt.beam_strain = np.abs(tl - ln) / length / limit
        img = render_packet(
            pkt, resolution=resolution, bounds_size=self.bounds_size,
            particle_radius=self.particle_radius, device=self.device,
        )
        if overlay:
            self._draw_overlay(img, resolution)
        return img

    # -- visual feedback layer (≙ drawFrame, editor.ts:575-854) --

    def _to_px(self, p, resolution: int):
        """World → pixel (y-down), camera ignored for the fixture path."""
        s = resolution / self.bounds_size
        import numpy as np

        p = np.asarray(p, np.float32)
        return np.stack(
            [p[..., 0] * s, resolution - 1 - p[..., 1] * s], axis=-1
        )

    def _draw_overlay(self, img, resolution: int) -> None:
        import numpy as np

        from .viz import (
            draw_circle_outline,
            draw_line,
            draw_text,
        )

        s = resolution / self.bounds_size
        r_px = max(2, int(self.particle_radius * 0.9 * s))
        reg = self.registry

        # snap grid (editor.ts:586-600)
        if self.snap_grid_size > 0:
            g = self.snap_grid_size
            r = self.particle_radius
            hi = (
                math.floor((self.bounds_size - 2 * r) / g) * g + r
            )
            ticks = np.arange(r, hi + 1e-6, g, dtype=np.float32)
            grid_c = (85, 85, 85)
            for t in ticks:
                a = self._to_px(np.array([r, t]), resolution)
                b = self._to_px(np.array([hi, t]), resolution)
                draw_line(img, a, b, grid_c)
                a = self._to_px(np.array([t, r]), resolution)
                b = self._to_px(np.array([t, hi]), resolution)
                draw_line(img, a, b, grid_c)

        # velocity vectors, red (editor.ts:616-625)
        for p in reg.particles:
            a = self._to_px(np.array([p.position.x, p.position.y]), resolution)
            b = self._to_px(
                np.array([p.position.x + p.velocity.x,
                          p.position.y + p.velocity.y]), resolution
            )
            draw_line(img, a, b, (255, 0, 0))

        # invalid beams: dashed magenta, missing endpoints → origin
        # (editor.ts:648-658; getEndpoints falls back to Vector2D.zero)
        for b_ in reg.beams:
            pa = reg.find_particle(b_.a)
            pb = reg.find_particle(b_.b)
            if pa is not None and pb is not None:
                continue
            e0 = (pa.position.x, pa.position.y) if pa else (0.0, 0.0)
            e1 = (pb.position.x, pb.position.y) if pb else (0.0, 0.0)
            draw_line(
                img,
                self._to_px(np.array(e0), resolution),
                self._to_px(np.array(e1), resolution),
                (255, 0, 255), width=2,
                dash=(10 * s * 0 + 10, 5),
            )

        # selection/hover/active outlines (editor.ts:662-698)
        def outline(pobj, color, width=2):
            c = self._to_px(
                np.array([pobj.position.x, pobj.position.y]), resolution
            )
            draw_circle_outline(img, c, r_px, color, width=width)

        if self.edit_mode == "particle":
            for p in self.selected_particles:
                outline(p, (0, 255, 255))
            if self._active_particle is not None:
                outline(self._active_particle, (0, 238, 0), width=3)
            elif self.hover_particle is not None and not self.force_add_mode:
                outline(
                    self.hover_particle,
                    (255, 0, 0) if self.delete_mode else (255, 255, 0),
                    width=3,
                )

        # HUD (editor.ts:792-851): FPS top-left, mode text top-right
        draw_text(img, (8, 8), f"FPS: {int(self.fps)}", (255, 255, 255))
        lines = [f"MODE: {self.edit_mode.upper()}"]
        if self.delete_mode:
            lines.append("DELETE")
        if self.force_add_mode:
            lines.append("FORCED ADD")
        if self.edit_mode == "particle" and self.hover_particle is not None:
            p = self.hover_particle.position
            lines.append(f"HOVER: <{round(p.x)}, {round(p.y)}>")
        elif self.edit_mode == "beam" and self.hover_beam is not None:
            b_ = self.hover_beam
            lines.append(
                f"HOVER: (S={b_.spring}, D={b_.damp})"
            )
        if self.selected_particles or self.selected_beams:
            n_sel = len(self.selected_particles) + len(self.selected_beams)
            lines.append(f"SELECTED: {n_sel}")
        for i, line in enumerate(lines):
            draw_text(img, (resolution - 8, 8 + 14 * i), line,
                      (255, 255, 255), align="right")
