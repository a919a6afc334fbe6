"""Hostile inputs for the lattice kernels and the comparison that holds
them, shared by the CPU emulation of the kernels' sources
(``tests/test_torch_kernel_emulation.py``) and the card
(``tests/test_torch_cuda.py``).  Each case takes a lattice state and
returns one with the case built in; the kernel is then held against its
plain version bit for bit (``same_bits``)."""

import dataclasses

import numpy as np
import torch


def band_scenarios(state, spacing: float, base: float):
    """A clean ``w × h`` lattice at ``spacing`` with every velocity
    0, so every deviation is 0 and the pre-test's bound is the base reach
    ``base`` exactly; cells (row, column) at column c = h // 2:

    - a pair exactly on the bound (1 → 4: |ddx| = base, no hit; 4 → 9 as
      well);
    - a pair an ulp inside it (9 → 12, a hit);
    - where H allows, a pair apart along H (5 → 6 at column c + 3, a hit
      tested on the y axis, its group all alive);
    - a hit at the band's last dx (15 → 22, dx 7), its group's only one,
      from the one cell of the group whose partner rows reach that far;
    - a group of four rows whose only hit is in its last row (16-19 → 23);
    - an alive cell with a dead partner that would hit it (25 → 28);
    - a dead cell with an alive partner at its position (30 → 33);
    - where W is not a multiple of 4, hits into the ragged last group
      (W-4 → W-1, and W-1 → its column c + 3 where H allows).

    Returns ``(state, want)``: ``want[(row, column)]`` is True where the
    cell's band flag must be set, False where it must be clear."""
    w, h = state.alive.shape
    dev = state.pos.device
    c = h // 2
    gx, gy = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    pos = np.stack([10.0 + spacing * gx, 10.0 + spacing * gy],
                   -1).astype(np.float32)
    alive = np.ones((w, h), bool)
    b = np.float32(base)
    want = {}
    # cells at x = 0, partners at x = base and one ulp below it: the
    # differences are exact
    pos[1, c, 0] = 0.0
    pos[4, c, 0] = b
    pos[9, c, 0] = 0.0
    pos[12, c, 0] = np.nextafter(b, np.float32(0.0))
    want.update({(1, c): False, (4, c): False, (9, c): True})
    if c + 3 < h:
        pos[6, c + 3] = pos[5, c] + np.float32([0.0, 0.9 * b])
        want[(5, c)] = True
    pos[22, c] = pos[15, c] - np.float32([0.5 * b, 0.0])
    want.update({(12, c): False, (13, c): False, (14, c): False,
                 (15, c): True})
    pos[23, c] = pos[19, c] + np.float32([0.0, 0.9 * b])
    want.update({(16, c): False, (17, c): False, (18, c): False,
                 (19, c): True})
    pos[28, c] = pos[25, c] + np.float32([0.2 * b, 0.0])
    alive[28, c] = False
    want[(25, c)] = False
    pos[33, c] = pos[30, c]
    alive[30, c] = False
    want[(30, c)] = False
    if w % 4:
        pos[w - 1, c] = pos[w - 4, c] + np.float32([0.0, 0.9 * b])
        want[(w - 4, c)] = True
        if c + 3 < h:
            pos[w - 1, c + 3] = pos[w - 1, c] + np.float32([0.0, 0.8 * b])
            want[(w - 1, c)] = True
    pos_t = torch.from_numpy(pos).to(dev)
    return dataclasses.replace(
        state, pos=pos_t, vel=torch.zeros_like(pos_t),
        alive=torch.from_numpy(alive).to(dev)), want


def same_bits(got, ref) -> bool:
    """Bit for bit, NaN where ``ref`` has NaN (the payloads aside)."""
    nan = torch.isnan(ref)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            ref[~nan].view(torch.int32)))


def hostile(state, g):
    """The state with what K3's skip must not hide: infinite and NaN
    velocities in two tiles (the rest stay finite, so both paths run),
    a fifth of the dead particles holding garbage positions (NaN, ±inf,
    1e30, −0.0, a live neighbour's position; NaN spreads from them to
    the deltas of their stencil) and an alive particle far out, whose
    squared distances overflow."""
    w, h = state.alive.shape
    pos, vel, alive = state.pos.clone(), state.vel.clone(), state.alive.clone()
    vel[1, min(h - 1, 1), 0] = float("inf")
    vel[min(w - 1, 20), h // 2, 1] = float("nan")
    vel[min(w - 1, 21), h // 2, 0] = float("-inf")
    dead = ~alive
    dead[3, :] = True
    garbage = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e30,
                            -0.0], dtype=torch.float32)
    pick = torch.randint(0, len(garbage) + 1, (w, h, 2), generator=g)
    junk = torch.where(pick < len(garbage),
                       garbage[pick.clamp(max=len(garbage) - 1)],
                       torch.roll(pos, 1, dims=1))
    messy = dead & (torch.rand((w, h), generator=g) < 0.2)
    pos = torch.where(messy[..., None], junk, pos)
    far = (w // 2, min(h - 1, 3))
    pos[far[0], far[1]] = torch.tensor([1e20, -1e20])
    alive = torch.where(dead, False, alive)
    alive[far] = True
    return dataclasses.replace(state, pos=pos, vel=vel, alive=alive)


def halo_nonfinite(state, seed: int):
    """``hostile``'s state (a CPU generator seeded with ``seed``) with NaN,
    +inf and −inf velocities also in the first tile's staged halo (rows
    8-14, lanes 32-38), on the state's device."""
    dev = state.pos.device
    cpu = dataclasses.replace(state, pos=state.pos.cpu(), vel=state.vel.cpu(),
                              alive=state.alive.cpu())
    cpu = hostile(cpu, torch.Generator().manual_seed(seed))
    w, h = cpu.alive.shape
    vel = cpu.vel.clone()
    vel[9, min(h - 1, 33), 0] = float("inf")
    vel[10, min(h - 1, 5), 1] = float("nan")
    vel[12, min(h - 1, 40), 0] = float("-inf")
    return dataclasses.replace(state, pos=cpu.pos.to(dev), vel=vel.to(dev),
                               alive=cpu.alive.to(dev))


def far_collapse(w: int, h: int, k: int, n_valid: int, seed: int,
                 spacing: float = 10.0, device="cpu"):
    """An overlap-rich far-apply case: a ``w × h`` sheet (``w % 4 == 0``,
    ``h`` a multiple of 16) collapsed into a pile a few spacings wide, so
    most listed cell pairs touch; 10% of the particles dead, a few
    coincident with a partner (the nudge), and a list of ``k`` slots, the
    first ``n_valid`` valid, that names self pairs, neighbouring chunks
    (pairs within the stencil, masked) and one chunk many times, its
    empty slots the grid's last chunk as the rebuild leaves them.
    Returns ``(planes, ca, cb, valid)``: the five ``[w, h]`` planes px py
    vx vy alive (0/1) and the list."""
    g = np.random.default_rng(seed)
    px = (500.0 + g.normal(0, 2.0 * spacing, (w, h))).astype(np.float32)
    py = (500.0 + g.normal(0, 2.0 * spacing, (w, h))).astype(np.float32)
    vx = g.normal(0, 3.0, (w, h)).astype(np.float32)
    vy = g.normal(0, 3.0, (w, h)).astype(np.float32)
    alive = (g.random((w, h)) > 0.1).astype(np.float32)
    for _ in range(8):
        a, b = g.integers(0, w, 2), g.integers(0, h, 2)
        px[a[1], b[1]], py[a[1], b[1]] = px[a[0], b[0]], py[a[0], b[0]]
    cwy = h // 4
    chunks = (w // 4) * cwy
    ca = g.integers(0, chunks, k)
    cb = g.integers(0, chunks, k)
    cb[: k // 8] = ca[: k // 8]                      # self pairs
    cb[k // 8: k // 4] = np.minimum(ca[k // 8: k // 4] + 1, chunks - 1)
    ca[k // 4: k // 3] = ca[0]                       # one chunk, many times
    ca, cb = np.minimum(ca, cb), np.maximum(ca, cb)
    valid = np.arange(k) < n_valid
    ca[~valid] = chunks - 1
    cb[~valid] = chunks - 1
    planes = tuple(torch.from_numpy(p).to(device)
                   for p in (px, py, vx, vy, alive))
    return (planes, torch.from_numpy(ca).to(device),
            torch.from_numpy(cb).to(device),
            torch.from_numpy(valid).to(device))


def far_list(ca, cb, valid):
    """A ``FarList`` of the slots ``(ca, cb, valid)`` (its references
    unused by the apply)."""
    from softbody_tpu_torch.ops.farfield import FarList

    dev = ca.device
    ref = torch.zeros((1, 1), device=dev)
    return FarList(ca=ca, cb=cb, valid=valid,
                   n_pairs=valid.sum().to(torch.int32),
                   overflow=torch.zeros((), dtype=torch.int32, device=dev),
                   px_ref=ref, py_ref=ref, com_ref=torch.zeros(2, device=dev),
                   vx_ref=ref, vy_ref=ref)


def far_fold(w: int, h: int, k: int, seed: int, spacing: float = 10.0,
             radius: float = 2.4, device="cpu"):
    """A collapsing sheet for the far apply: a ``w × h`` sheet at
    ``spacing`` (``w % 8 == 0``, ``h`` a multiple of 16) folded along x,
    column ``i`` of the right half over column ``w − 1 − i`` of the left,
    each upper particle ``2·radius`` minus up to 0.002 above its partner
    (a shallow contact, as a fold makes first; ``radius`` under a
    quarter of ``spacing``, so the row above stays clear), the halves
    approaching;
    5% of the particles dead, a few exactly on their partner (the
    nudge).  The list pairs each left chunk with the chunk above it,
    ``k`` slots, the first ``(w/8)·(h/4)`` valid.  Returns ``(planes,
    ca, cb, valid)`` as :func:`far_collapse`."""
    g = np.random.default_rng(seed)
    i = np.arange(w)
    right = i >= w // 2
    xi = np.where(right, w - 1 - i, i)[:, None]
    x = np.broadcast_to(100.0 + xi * spacing, (w, h))
    y = 100.0 + np.arange(h)[None, :] * spacing
    lift = 2.0 * radius - g.uniform(0.0, 0.002, (w, h))
    y = np.where(right[:, None], y + lift, y)
    px = (x + g.uniform(-1e-3, 1e-3, (w, h))).astype(np.float32)
    py = y.astype(np.float32)
    sign = np.where(right, -1.0, 1.0)[:, None]
    vx = g.normal(0, 0.5, (w, h)).astype(np.float32)
    vy = (sign * 1.5 + g.normal(0, 0.1, (w, h))).astype(np.float32)
    alive = (g.random((w, h)) > 0.05).astype(np.float32)
    for _ in range(16):
        a, b = g.integers(0, w // 2), g.integers(0, h)
        px[w - 1 - a, b], py[w - 1 - a, b] = px[a, b], py[a, b]
    cwy = h // 4
    left = np.arange((w // 8) * cwy)
    cx, cy = left // cwy, left % cwy
    top = (w // 4 - 1 - cx) * cwy + cy
    n = left.shape[0]
    ca = np.full(k, (w // 4) * cwy - 1)
    cb = ca.copy()
    ca[:n], cb[:n] = left, top
    valid = np.arange(k) < n
    planes = tuple(torch.from_numpy(p).to(device)
                   for p in (px, py, vx, vy, alive))
    return (planes, torch.from_numpy(ca).to(device),
            torch.from_numpy(cb).to(device),
            torch.from_numpy(valid).to(device))
