"""Interactive terminal viewer (a copy of ``softbody_tpu/tui.py``; it
drives the port's ``Engine`` and ``LatticeEngine``) — the app surface of
the reference
(canvas blit + live mouse/keyboard, engine.ts:207-223, input capture
engine.ts:76-125, controls panel index.html:113-181) reimagined for a
terminal: ANSI half-block rendering at up to ~30 Hz over the engine's
decoupled ``render_packet()`` readback, with WASD forces, a virtual
cursor for mouse grab, pause, reset and fault injection.

Rendering: each terminal cell shows two vertical pixels via the upper
half block ``▀`` with 24-bit foreground (top pixel) + background
(bottom pixel) colors.  Beams are colored by the reference's
stress→RGB law (render.wgsl:82); particles draw as filled points.

Keys (≙ the reference's bindings where they exist):
  w a s d   directional force while held (key-repeat sustains it)
  arrows    move the virtual cursor ("mouse")
  space     toggle grab at the cursor (mouse down/up)
  r         reset to the initial-state slot (main.ts:347)
  x         corruptBuffers fault injection (hidden button, index.html:243)
  p         pause/resume (visibility change)
  q / Ctrl-C  quit
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import numpy as np

# reference defaults: world is a 1000×1000 square (engineWorker.ts:39)
WORLD = 1000.0


def stress_rgb(stress: np.ndarray, strain: np.ndarray) -> np.ndarray:
    """Beam color law (render.wgsl:82): R=clamp(stress+1), G=clamp(1−stress),
    B=1−|strain| — returns uint8 [n, 3]."""
    r = np.clip(stress + 1.0, 0.0, 1.0)
    g = np.clip(1.0 - stress, 0.0, 1.0)
    b = np.clip(1.0 - np.abs(strain), 0.0, 1.0)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def rasterize(
    pos: np.ndarray,
    particle_alive: np.ndarray,
    beam_a: np.ndarray,
    beam_b: np.ndarray,
    beam_alive: np.ndarray,
    beam_strain: np.ndarray,
    beam_stress: np.ndarray,
    width: int,
    height: int,
    *,
    world: float = WORLD,
    cursor: Optional[Tuple[float, float]] = None,
    grabbing: bool = False,
) -> np.ndarray:
    """Render a packet to an RGB uint8 [height, width, 3] image (origin
    top-left; world y-up is flipped).  Pure NumPy — testable headless."""
    img = np.zeros((height, width, 3), np.uint8)
    sx = width / world
    sy = height / world

    def to_px(p):
        x = np.clip((p[..., 0] * sx).astype(np.int32), 0, width - 1)
        y = np.clip(height - 1 - (p[..., 1] * sy).astype(np.int32), 0,
                    height - 1)
        return x, y

    # beams: vectorized segment sampling, stress-colored
    ba = beam_alive.astype(bool)
    if ba.any():
        a = pos[beam_a[ba]]
        b = pos[beam_b[ba]]
        col = stress_rgb(beam_stress[ba], beam_strain[ba])
        nseg = max(2, int(2 * max(sx, sy) * world / max(width, height) * 8))
        t = np.linspace(0.0, 1.0, nseg, dtype=np.float32)
        pts = a[:, None, :] + (b - a)[:, None, :] * t[None, :, None]
        x, y = to_px(pts)
        img[y.reshape(-1), x.reshape(-1)] = np.repeat(col, nseg, axis=0)

    # particles on top (white-ish)
    pa = particle_alive.astype(bool)
    if pa.any():
        x, y = to_px(pos[pa])
        img[y, x] = (230, 230, 230)

    if cursor is not None:
        cx = int(np.clip(cursor[0] * sx, 1, width - 2))
        cy = int(np.clip(height - 1 - cursor[1] * sy, 1, height - 2))
        c = (255, 64, 64) if grabbing else (255, 255, 0)
        img[cy, cx - 1 : cx + 2] = c
        img[cy - 1 : cy + 2, cx] = c
    return img


def frame_to_ansi(img: np.ndarray) -> str:
    """RGB [2R, C, 3] image → ANSI string of R rows using half blocks."""
    h, w, _ = img.shape
    top = img[0 : h - 1 : 2].astype(np.int32)
    bot = img[1:h:2].astype(np.int32)
    rows = []
    for r in range(top.shape[0]):
        parts = []
        last = None
        for c in range(w):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            key = (tr, tg, tb, br, bg, bb)
            if key != last:
                parts.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m"
                )
                last = key
            parts.append("▀")
        parts.append("\x1b[0m")
        rows.append("".join(parts))
    return "\n".join(rows)


class _RawTerminal:
    """Raw-mode stdin with nonblocking reads (POSIX)."""

    def __init__(self) -> None:
        import termios
        import tty

        self._termios = termios
        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)

    def read_keys(self) -> list:
        import select

        keys = []
        while select.select([self._fd], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                # arrow keys: ESC [ A/B/C/D
                if select.select([self._fd], [], [], 0.002)[0]:
                    ch2 = sys.stdin.read(1)
                    if ch2 == "[" and select.select([self._fd], [], [], 0.002)[0]:
                        ch3 = sys.stdin.read(1)
                        keys.append({"A": "up", "B": "down",
                                     "C": "right", "D": "left"}.get(ch3, ""))
                        continue
                keys.append("esc")
            else:
                keys.append(ch)
        return keys

    def restore(self) -> None:
        self._termios.tcsetattr(
            self._fd, self._termios.TCSADRAIN, self._saved
        )


def play(engine, *, fps: float = 30.0, duration: Optional[float] = None,
         out=None) -> None:
    """Drive ``engine`` interactively until 'q' (or ``duration`` s)."""
    import shutil

    out = out or sys.stdout
    interactive = sys.stdin.isatty()
    term = _RawTerminal() if interactive else None
    cursor = np.array([WORLD / 2, WORLD / 2], np.float32)
    grabbing = False
    paused = False
    key_hold: dict = {}   # key → expiry time (terminals have no key-up)
    hold_s = 0.18
    engine.set_initial_state()
    out.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
    try:
        t_end = time.monotonic() + duration if duration else None
        while True:
            t0 = time.monotonic()
            if t_end and t0 >= t_end:
                break
            cols, lines = shutil.get_terminal_size((100, 40))
            w, h = max(20, cols - 2), max(10, (lines - 2) * 2)

            now = time.monotonic()
            if term:
                for k in term.read_keys():
                    if k == "q" or k == "\x03":
                        return
                    if k == "p":
                        paused = not paused
                        engine.set_hidden(paused)
                    elif k == "r":
                        engine.reset()
                    elif k == "x":
                        engine.corrupt_buffers()
                    elif k in ("w", "a", "s", "d"):
                        if k not in key_hold:
                            engine.key_down(k)
                        key_hold[k] = now + hold_s
                    elif k in ("up", "down", "left", "right"):
                        step_ = WORLD / 40
                        cursor += {
                            "up": (0, step_), "down": (0, -step_),
                            "left": (-step_, 0), "right": (step_, 0),
                        }[k]
                        cursor[:] = np.clip(cursor, 0, WORLD)
                        if grabbing:
                            engine.mouse(cursor, True)
                    elif k == " ":
                        grabbing = not grabbing
                        engine.mouse(cursor, grabbing)
                for k, expiry in list(key_hold.items()):
                    if now >= expiry:
                        engine.key_up(k)
                        del key_hold[k]

            pkt = engine.render_packet()
            if pkt is not None:
                img = rasterize(
                    pkt.pos, pkt.particle_alive, pkt.beam_a, pkt.beam_b,
                    pkt.beam_alive, pkt.beam_strain, pkt.beam_stress,
                    w, h, cursor=tuple(cursor), grabbing=grabbing,
                )
                st = engine.stats()
                hud = (
                    f" {st.fps:5.1f} fps | {st.substeps_per_sec:7.0f} substeps/s"
                    f" | {st.particle_count} particles | {st.beam_count} beams"
                    f" | {'GRAB' if grabbing else 'grab:space'}"
                    f" | wasd=force arrows=cursor r=reset x=corrupt "
                    f"p={'resume' if paused else 'pause'} q=quit"
                )
                out.write("\x1b[H" + frame_to_ansi(img) + "\n"
                          + hud[: cols - 1] + "\x1b[K")
                out.flush()
            dt_ = 1.0 / fps - (time.monotonic() - t0)
            if dt_ > 0:
                time.sleep(dt_)
    finally:
        out.write("\x1b[0m\x1b[?25h\n")
        out.flush()
        if term:
            term.restore()
