"""Rendering of simulation state to RGB images (component C7 — ≙
``render.wgsl``): the port of ``softbody_tpu/viz.py``.

The reference renders on the GPU: particles as SDF circles with a white
outline (render.wgsl:42-54), beams as lines colored by stress/strain
(:77-83 — R = clamp(stress+1), G = clamp(1−stress), B = 1−|strain|), with
a trail effect from the alpha-0.4 clear (engineWorker.ts:43,672).

The JAX package evaluates the particle SDF and beam segment-distance
fields over every pixel, chunk by chunk in a ``lax.scan`` (beams in
chunks of ``chunk // 8``, particles in chunks of ``chunk``).  Its image
depends on the chunks: a pixel takes the mean colour of the hits of the
LAST beam chunk that hits it, and then, if a particle covers it, the
fill or outline of the last particle chunk that covers it (fill wins
within a chunk).  The port computes the same image from the pixels each
primitive can reach: every beam (particle) yields the pixels of its
capsule's (circle's) box, each is tested with JAX's float32 expressions,
the last chunk with a hit is found per pixel with a ``scatter_reduce``
(``amax``) and only that chunk's hits are averaged, their colours summed
in beam order on every device (``stencil.index_sum``).  The cost follows
the primitives' pixel area, not pixels × primitives, so a 1M-particle
frame renders on the device in a few passes.  Only the final image
crosses to the host.

One difference at non-finite colours: JAX's chunk ``einsum`` multiplies
a NaN colour by the 0 of every pixel it misses, so a beam with a NaN
stress blanks every pixel its chunk hits; here it blanks only its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .ops.stencil import device_scalar, index_sum

# Colors from render.wgsl:42-44 (premultiplied particle fill) and the
# outline edge fraction.
_PARTICLE_FILL = np.array([0.0, 0.35, 0.5], np.float32)  # (0,0.7,1,1)·0.5
_PARTICLE_OUTLINE = np.array([1.0, 1.0, 1.0], np.float32)
_OUTLINE_EDGE = 0.8
_TRAIL_ALPHA = 0.4  # engineWorker.ts:43
# candidate (primitive, pixel) pairs evaluated at once: bounds a pass's
# temporaries (~100 bytes per candidate)
_MAX_CANDIDATES = 1 << 24
# primitives per pass before the candidate bound splits it
_MAX_PRIMITIVES = 1 << 20


def _pixel_span(lo: torch.Tensor, hi: torch.Tensor, reach: float,
                scale: float, res: int):
    """Pixel indices ``[first, last]`` whose centres ``(i + 0.5) / scale``
    may lie within ``reach`` of ``[lo, hi]`` (one pixel of margin for
    rounding), clamped to the image; float64 on the host's formula."""
    def f64(x):
        return torch.nan_to_num(x.to(torch.float64), nan=0.0)

    lo = (f64(lo) - reach) * scale - 0.5
    hi = (f64(hi) + reach) * scale - 0.5
    first = torch.floor(lo).clamp(-2, res + 1).to(torch.int64) - 1
    last = torch.ceil(hi).clamp(-2, res + 1).to(torch.int64) + 1
    return first.clamp(min=0), last.clamp(max=res - 1)


class _Boxes:
    """Per-primitive pixel boxes (columns ``i0..``, world-y rows ``j0..``,
    width ``bw``) of the primitives ``[s, e)`` and their candidate
    counts (0 for primitives that cannot hit)."""

    def __init__(self, xlo, xhi, ylo, yhi, ok, reach, scale, res):
        self.i0, i1 = _pixel_span(xlo, xhi, reach, scale, res)
        self.j0, j1 = _pixel_span(ylo, yhi, reach, scale, res)
        self.bw = (i1 - self.i0 + 1).clamp(min=0)
        bh = (j1 - self.j0 + 1).clamp(min=0)
        self.counts = torch.where(ok, self.bw * bh, 0)

    def candidates(self, s: int, total: int):
        """``(primitive index, column, world-y row)`` of every candidate,
        in ascending primitive order."""
        dev = self.counts.device
        local_p = torch.repeat_interleave(
            torch.arange(self.counts.shape[0], device=dev), self.counts,
            output_size=total)
        start = torch.cumsum(self.counts, 0) - self.counts
        k = torch.arange(total, device=dev) - start[local_p]
        bw = self.bw[local_p]
        return (local_p + s, self.i0[local_p] + k % bw,
                self.j0[local_p] + k // bw)


def _passes(n: int, chunk: int, boxes_of):
    """Ranges ``[s, e)`` of primitives, aligned to whole chunks (so a
    later pass holds only later chunks), each with its boxes and
    candidate count at most ``_MAX_CANDIDATES`` (or one chunk)."""
    step = chunk * max(1, _MAX_PRIMITIVES // chunk)
    s = 0
    while s < n:
        e = min(s + step, n)
        boxes = boxes_of(s, e)
        total = int(boxes.counts.sum())
        if total > _MAX_CANDIDATES and e - s > chunk:
            step = chunk * max(1, (e - s) // (2 * chunk))
            continue
        yield s, boxes, total
        s = e


def render_frame(
    pos: torch.Tensor,
    particle_alive: torch.Tensor,
    beam_a: torch.Tensor,
    beam_b: torch.Tensor,
    beam_alive: torch.Tensor,
    beam_strain: torch.Tensor,
    beam_stress: torch.Tensor,
    *,
    resolution: int = 512,
    bounds_size: float = 1000.0,
    particle_radius: float = 10.0,
    chunk: int = 1024,
    prev_frame: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rasterize one frame on ``pos``'s device; returns ``[res, res, 3]``
    float32 in [0,1] (row 0 = the top of the world).

    ``prev_frame`` enables the reference's trail effect (alpha-blended
    clear): ``out = draw over prev·(1−0.4)``."""
    res = int(resolution)
    scale = res / bounds_size
    dev = pos.device
    f32 = torch.float32
    # pixel centres in world space; row r shows world y = centre[res-1-r]
    centre = ((torch.arange(res, dtype=f32, device=dev) + 0.5)
              / device_scalar(scale, dev))
    n = pos.shape[0]
    m = beam_a.shape[0]

    if prev_frame is None:
        img = torch.zeros((res * res, 3), dtype=f32, device=dev)
    else:
        trail = float(np.float32(1.0 - _TRAIL_ALPHA))
        img = (prev_frame.to(f32) * trail).reshape(-1, 3)

    def pixel(col, j):
        return (res - 1 - j) * res + col

    def last_per_pixel(pix, key):
        last = torch.full((res * res,), -1, dtype=torch.int64, device=dev)
        return last.scatter_reduce_(0, pix, key, "amax")

    # --- beams first (particles draw over them, like pass order
    # engineWorker.ts:675-684) ---
    if m:
        bchunk = max(1, min(chunk // 8, m))
        a = pos[beam_a]
        b = pos[beam_b]
        d = b - a
        len2 = torch.clamp(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1],
                           min=1e-12)
        bal = beam_alive & particle_alive[beam_a] & particle_alive[beam_b]
        ok = bal & torch.isfinite(a).all(1) & torch.isfinite(b).all(1)
        # stress→RGB (render.wgsl:82)
        col_rgb = torch.stack([
            torch.clamp(beam_stress + 1.0, 0.0, 1.0),
            torch.clamp(1.0 - beam_stress, 0.0, 1.0),
            torch.clamp(1.0 - torch.abs(beam_strain), min=0.0),
        ], dim=-1)
        half_px = np.float32(0.75 / scale)  # line half-thickness (world)
        hp2 = float(half_px * half_px)

        def boxes(s, e):
            xa, xb = a[s:e, 0], b[s:e, 0]
            ya, yb = a[s:e, 1], b[s:e, 1]
            return _Boxes(torch.minimum(xa, xb), torch.maximum(xa, xb),
                          torch.minimum(ya, yb), torch.maximum(ya, yb),
                          ok[s:e], float(half_px), scale, res)

        for s, bx, total in _passes(m, bchunk, boxes):
            if not total:
                continue
            k, col, j = bx.candidates(s, total)
            relx = centre[col] - a[k, 0]
            rely = centre[j] - a[k, 1]
            dx, dy = d[k, 0], d[k, 1]
            t = torch.clamp((relx * dx + rely * dy) / len2[k], 0.0, 1.0)
            distx = relx - t * dx
            disty = rely - t * dy
            hit = (distx * distx + disty * disty) < hp2
            pix, k = pixel(col, j)[hit], k[hit]
            ck = k // bchunk
            sel = ck == last_per_pixel(pix, ck)[pix]
            pix, k = pix[sel], k[sel]
            add = index_sum(pix, col_rgb[k], res * res)
            num = torch.zeros(res * res, dtype=torch.int64,
                              device=dev).index_add_(
                0, pix, torch.ones_like(pix))
            drawn = num > 0
            img = torch.where(drawn[:, None],
                              add / num.clamp(min=1).to(f32)[:, None], img)

    # --- particles: SDF circles with outline (render.wgsl:45-54) ---
    if n:
        pchunk = max(1, min(chunk, n))
        r = np.float32(particle_radius)
        r_in = np.float32(r * np.float32(_OUTLINE_EDGE))
        r_in2, r2 = float(r_in * r_in), float(r * r)
        ok = particle_alive & torch.isfinite(pos).all(1)
        fill = torch.as_tensor(_PARTICLE_FILL, device=dev)
        outline = torch.as_tensor(_PARTICLE_OUTLINE, device=dev)

        def boxes(s, e):
            x, y = pos[s:e, 0], pos[s:e, 1]
            return _Boxes(x, x, y, y, ok[s:e], float(r), scale, res)

        for s, bx, total in _passes(n, pchunk, boxes):
            if not total:
                continue
            k, col, j = bx.candidates(s, total)
            dx = centre[col] - pos[k, 0]
            dy = centre[j] - pos[k, 1]
            d2 = dx * dx + dy * dy
            outer = d2 < r2
            pix = pixel(col, j)[outer]
            # the last chunk with a hit, odd if a fill hit is in it
            key = (k[outer] // pchunk) * 2 + (d2[outer] < r_in2)
            last = last_per_pixel(pix, key)
            img = torch.where((last >= 0)[:, None],
                              torch.where((last % 2 == 1)[:, None], fill,
                                          outline), img)
    return torch.clamp(img, 0.0, 1.0).reshape(res, res, 3)


def render_state(state, cfg, resolution: int = 512,
                 prev_frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render a :class:`SimState` under a :class:`StaticConfig`, on the
    state's device."""
    return render_frame(
        state.pos,
        state.particle_alive,
        state.beam_a,
        state.beam_b,
        state.beam_alive,
        state.beam_strain,
        state.beam_stress,
        resolution=resolution,
        bounds_size=cfg.bounds_size,
        particle_radius=cfg.particle_radius,
        prev_frame=prev_frame,
    )


def render_packet(pkt, *, resolution: int = 512, bounds_size: float = 1000.0,
                  particle_radius: float = 10.0,
                  prev_frame: Optional[np.ndarray] = None,
                  device=None) -> np.ndarray:
    """Render an engine :class:`RenderPacket` (host arrays) on ``device``
    (default: the CUDA device) to a host uint8 image."""
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)

    img = render_frame(
        t(pkt.pos, torch.float32),
        t(pkt.particle_alive, torch.bool),
        t(pkt.beam_a, torch.int64),
        t(pkt.beam_b, torch.int64),
        t(pkt.beam_alive, torch.bool),
        t(pkt.beam_strain, torch.float32),
        t(pkt.beam_stress, torch.float32),
        resolution=resolution,
        bounds_size=bounds_size,
        particle_radius=particle_radius,
        prev_frame=None if prev_frame is None else t(prev_frame),
    )
    return torch.round(img * 255).to(torch.uint8).cpu().numpy()


def save_png(path: str, img) -> None:
    """Write an image (float in [0,1] or uint8; a tensor on any device or
    an array) as a PNG."""
    from .utils.png import write_png

    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255), 0, 255).astype(np.uint8)
    write_png(path, arr)


# ---------------------------------------------------------------------------
# Host-side overlay drawing (editor visual feedback layer, editor.ts:575-854):
# snap grid, velocity vectors, dashed invalid beams, selection outlines and
# HUD text. Pure NumPy on uint8 images — deliberately CPU-side, like the
# reference's Canvas2D editor (it never touches the GPU either).


def draw_line(img, a, b, color, *, width: int = 1, dash=None) -> None:
    """Draw segment a→b (pixel coords, y down) in place by sampling.
    ``dash=(on, off)`` in pixels for dashed strokes."""
    h, w, _ = img.shape
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n = max(2, int(np.ceil(np.abs(b - a).max())) + 1)
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    pts = a[None, :] + (b - a)[None, :] * t[:, None]
    if dash is not None:
        on, off = dash
        dist = t * float(np.linalg.norm(b - a))
        pts = pts[(dist % (on + off)) < on]
        if pts.size == 0:
            return
    half = (width - 1) // 2
    for ox in range(-half, width - half):
        for oy in range(-half, width - half):
            x = np.clip(pts[:, 0].astype(np.int32) + ox, 0, w - 1)
            y = np.clip(pts[:, 1].astype(np.int32) + oy, 0, h - 1)
            img[y, x] = color


def draw_circle_outline(img, center, radius, color, *, width: int = 1) -> None:
    h, w, _ = img.shape
    n = max(8, int(2 * np.pi * radius) + 1)
    t = np.linspace(0.0, 2 * np.pi, n, dtype=np.float32)
    for r in np.linspace(max(radius - width + 1, 1), radius, max(width, 1)):
        x = np.clip((center[0] + r * np.cos(t)).astype(np.int32), 0, w - 1)
        y = np.clip((center[1] + r * np.sin(t)).astype(np.int32), 0, h - 1)
        img[y, x] = color


# 3×5 bitmap font (rows top→bottom); enough glyphs for the reference HUD
# strings (editor.ts:792-851)
_FONT = {
    "A": ("010", "101", "111", "101", "101"),
    "B": ("110", "101", "110", "101", "110"),
    "C": ("011", "100", "100", "100", "011"),
    "D": ("110", "101", "101", "101", "110"),
    "E": ("111", "100", "110", "100", "111"),
    "F": ("111", "100", "110", "100", "100"),
    "G": ("011", "100", "101", "101", "011"),
    "H": ("101", "101", "111", "101", "101"),
    "I": ("111", "010", "010", "010", "111"),
    "J": ("001", "001", "001", "101", "010"),
    "K": ("101", "110", "100", "110", "101"),
    "L": ("100", "100", "100", "100", "111"),
    "M": ("101", "111", "101", "101", "101"),
    "N": ("110", "101", "101", "101", "101"),
    "O": ("010", "101", "101", "101", "010"),
    "P": ("110", "101", "110", "100", "100"),
    "Q": ("010", "101", "101", "110", "011"),
    "R": ("110", "101", "110", "110", "101"),
    "S": ("011", "100", "010", "001", "110"),
    "T": ("111", "010", "010", "010", "010"),
    "U": ("101", "101", "101", "101", "111"),
    "V": ("101", "101", "101", "101", "010"),
    "W": ("101", "101", "101", "111", "101"),
    "X": ("101", "101", "010", "101", "101"),
    "Y": ("101", "101", "010", "010", "010"),
    "Z": ("111", "001", "010", "100", "111"),
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "001", "010", "010"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    ":": ("000", "010", "000", "010", "000"),
    ".": ("000", "000", "000", "000", "010"),
    ",": ("000", "000", "000", "010", "100"),
    "<": ("001", "010", "100", "010", "001"),
    ">": ("100", "010", "001", "010", "100"),
    "=": ("000", "111", "000", "111", "000"),
    "-": ("000", "000", "111", "000", "000"),
    "(": ("010", "100", "100", "100", "010"),
    ")": ("010", "001", "001", "001", "010"),
    "/": ("001", "001", "010", "100", "100"),
    " ": ("000", "000", "000", "000", "000"),
}


def draw_text(img, xy, text, color, *, scale: int = 2,
              align: str = "left") -> None:
    """Burn HUD text at pixel ``xy`` (top-left or top-right anchored)."""
    h, w, _ = img.shape
    cw = 4 * scale  # glyph + 1px spacing
    text = str(text).upper()
    x0, y0 = int(xy[0]), int(xy[1])
    if align == "right":
        x0 -= len(text) * cw
    for ci, ch in enumerate(text):
        glyph = _FONT.get(ch)
        if glyph is None:
            continue
        for ry, row in enumerate(glyph):
            for rx, bit in enumerate(row):
                if bit != "1":
                    continue
                xs = x0 + ci * cw + rx * scale
                ys = y0 + ry * scale
                img[max(0, ys) : min(h, ys + scale),
                    max(0, xs) : min(w, xs + scale)] = color
