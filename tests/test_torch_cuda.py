"""The hand-written CUDA kernels against their plain torch versions, on
the card (marker ``cuda``; skipped where there is no CUDA device).  Run
there with ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (``conftest.py`` imports JAX, which that machine lacks);
``chip_smoke.py`` makes the same checks at the main path's full size."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.models import make_lattice, tearing_cloth_lattice
from softbody_tpu_torch.ops import farfield, farfield4
from softbody_tpu_torch.ops.cuda import (
    band_detect,
    collide_stencil,
    far_apply,
    fused_substep,
    fused_substep2,
    recmirror,
)
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from torch_threads import two_torch_threads  # noqa: F401

import kernel_cases
from kernel_cases import same_bits

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stirred_cloth(dev, seed=0, side=40):
    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=side * side, fall_speed=2.5, slits=2, strain_limit=0.22,
        yield_strain=0.18, device=dev)
    spacing = 980.0 / (side - 1)
    g = torch.Generator(device=dev).manual_seed(seed)

    def noise(scale):
        return torch.randn(state.pos.shape, generator=g, device=dev) * scale

    state = dataclasses.replace(state, pos=state.pos + noise(0.3 * spacing),
                                vel=state.vel + noise(6.0 * spacing))
    return state, spec, cfg, consts, spacing, g


# K1 and K4 are held at the bench lattice and at shapes whose sides are
# multiples of neither tile side (16 rows x 32 lanes), one a single lane
# wide, at stencil radii 0-3, quantized and float forces
K14_SHAPES = [(1000, 1000), (97, 61), (33, 1000), (64, 1)]
K14_IDS = [f"{w}x{h}" for w, h in K14_SHAPES]


def _stirred_lattice(dev, w, h, seed):
    """A ``w × h`` lattice at the tearing cloth's parameters, stirred so
    that springs yield and break and particles collide, 5% of the
    particles and 10% of the edges dead."""
    spacing = 980.0 / max(max(w, h) - 1, 1)
    state = make_lattice(w, h, spacing, spring=200.0, damp=10.0,
                         yield_strain=0.18, strain_limit=0.22, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)

    def noise(scale):
        return torch.randn(state.pos.shape, generator=g, device=dev) * scale

    edges = tuple(dataclasses.replace(
        e, alive=e.alive & (torch.rand((w, h), generator=g, device=dev)
                            > 0.1)) for e in state.edges)
    state = dataclasses.replace(
        state, pos=state.pos + noise(0.3 * spacing),
        vel=state.vel + noise(6.0 * spacing), edges=edges,
        alive=torch.rand((w, h), generator=g, device=dev) > 0.05)
    cfg = tb.StaticConfig(subticks=64, collision_mode="allpairs",
                          particle_radius=spacing * 0.35)
    consts = tb.PhysicsConstants(gravity=(0.0, -0.05 * spacing))
    return state, cfg, consts, g


def _assert_particles_close(got, ref):
    for planes, tol in ((slice(0, 2), 1e-4), (slice(2, 4), 1e-3),
                        (slice(4, 6), 1e-2)):
        torch.testing.assert_close(got[planes], ref[planes], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("shape", K14_SHAPES, ids=K14_IDS)
@pytest.mark.parametrize("stencil", [0, 1, 2, 3])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("with_far", [False, True])
@pytest.mark.parametrize("observe", [False, True])
def test_k1_matches_plain(dev, observe, with_far, quantized, stencil,
                          shape):
    w, h = shape
    state, cfg, consts, g = _stirred_lattice(dev, w, h, seed=w + h)
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    kw = dict(stencil=stencil, quantized=quantized,
              far=far if with_far else None,
              obs_in=obs if observe else None)
    before = fused_substep2.K1_LAUNCHES
    got = fused_substep2.fused_substep2_call(hot, immut, cvec, **kw)
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
    torch.cuda.synchronize()
    assert fused_substep2.K1_LAUNCHES == before + 1
    got_hot, ref_hot = (got[0], ref[0]) if observe else (got, ref)
    assert torch.equal(got_hot[6:], ref_hot[6:])
    _assert_particles_close(got_hot, ref_hot)
    if observe:
        live = torch.repeat_interleave(ref_hot[8::3] > 0, 2, dim=0)
        torch.testing.assert_close(got[1] * live, ref[1] * live, rtol=0,
                                   atol=1e-5)


K1_INSTANCES = [(False, False), (True, False), (False, True), (True, True)]
K1_INSTANCE_IDS = ["strict", "rsqrt", "rollgroup", "rsqrt+rollgroup"]


@pytest.mark.parametrize("shape", [(1000, 1000), (97, 61)],
                         ids=["1000x1000", "97x61"])
@pytest.mark.parametrize("stencil", [0, 1, 2, 3])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("instance", K1_INSTANCES, ids=K1_INSTANCE_IDS)
def test_k1_instances_match_plain(dev, instance, quantized, stencil, shape):
    """Each of K1's four instances (strict and the JAX kernel's
    arithmetic variants rsqrt, rollgroup, both) against the plain version
    with the same flags, far stack on, observing, the mouse grabbing:
    bit for bit (the plain version's ``torch.rsqrt`` runs the card's
    ``rsqrtf`` as the kernel does), counted under its instance."""
    rsqrt, rollgroup = instance
    w, h = shape
    state, cfg, consts, g = _stirred_lattice(dev, w, h, seed=3 * w + h)
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    uin = tb.UserInput(mouse_active=True, mouse_pos=(490.0, 510.0),
                       mouse_vel=(3.0, -1.0))
    cvec = torch.cat([tb.consts_vector(consts, uin, cfg, h), ec])
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    kw = dict(stencil=stencil, quantized=quantized, far=far, obs_in=obs,
              rsqrt=rsqrt, rollgroup=rollgroup)
    name = fused_substep2.k1_instance(rsqrt, rollgroup)
    before = dict(fused_substep2.K1_INSTANCE_LAUNCHES)
    got = fused_substep2.fused_substep2_call(hot, immut, cvec, **kw)
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
    torch.cuda.synchronize()
    after = fused_substep2.K1_INSTANCE_LAUNCHES
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


K1_MODES = [
    dict(refs=True), dict(refs=True, detect=True), dict(detect=True),
    dict(detect=True, rsqrt=True, rollgroup=True), dict(nospring=True),
    dict(noint=True, rollgroup=True), dict(nospring=True, noint=True),
    # detect's edge cases and non-finite velocities in the staged halo
    # (tests/kernel_cases.py), as the CPU emulation of K1's source takes
    dict(detect=True, kind="bound"), dict(refs=True, detect=True,
                                          kind="bound"),
    dict(detect=True, rsqrt=True, rollgroup=True, kind="nonfinite"),
    dict(refs=True, detect=True, kind="nonfinite"),
]
K1_MODE_IDS = ["trig", "trig+detect", "detect", "detect-rsqrt+rollgroup",
               "nospring", "noint-rollgroup", "nospring+noint",
               "detect-bound", "trig+detect-bound",
               "detect-rsqrt+rollgroup-nonfinite", "trig+detect-nonfinite"]


@pytest.mark.parametrize("shape", [(1000, 1000), (97, 61)],
                         ids=["1000x1000", "97x61"])
@pytest.mark.parametrize("stencil", [1, 2])
@pytest.mark.parametrize("mode", K1_MODES, ids=K1_MODE_IDS)
def test_k1_modes_match_plain(dev, mode, stencil, shape):
    """K1's far-field modes (trig: the trigger statistics of the output
    state; detect: the side planes of the input state) and the knobs
    against the plain version with the same flags, far stack on: every
    plane bit for bit (NaN where the plain version has NaN), the trig
    maxima too, the trig sums within 1e-5 of the sums of |v| (their order
    differs; non-finite sums equal), counted under the instance.  Kinds
    ``bound`` (each edge case's cells flagged as it expects) and
    ``nonfinite``: ``tests/kernel_cases.py``."""
    mode = dict(mode)
    kind = mode.pop("kind", "stirred")
    w, h = shape
    state, cfg, consts, g = _stirred_lattice(dev, w, h, seed=5 * w + h)
    spacing = 980.0 / (max(w, h) - 1)
    base = 2 * cfg.particle_radius + 0.75 * spacing
    want = {}
    if kind == "bound":
        state, want = kernel_cases.band_scenarios(
            state, spacing, float(np.float32(base)))
    hot, obs, immut, ec = fused_substep2.pack_lattice2(state)
    alive = immut[0] > 0
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, h), ec])
    trig, detect = mode.get("refs", False), mode.get("detect", False)
    if trig or detect:
        n = alive.sum().to(torch.float32)
        vbar = [float((torch.where(alive, hot[k], 0.0).sum() / n).item())
                for k in (2, 3)]
        cvec = torch.cat([cvec, torch.tensor(
            [cfg.dt, 1.0, vbar[0], vbar[1], 9 * cfg.dt, base, 2 * cfg.dt,
             0.0])])
    if kind == "nonfinite":
        # (the band's mean velocity is the stirred state's)
        hot, obs, immut, ec = fused_substep2.pack_lattice2(
            kernel_cases.halo_nonfinite(state, seed=w + h))
        alive = immut[0] > 0
    kw = dict(mode, stencil=stencil, quantized=True,
              far=torch.randn((5, w, h), generator=g, device=dev) * 0.5,
              refs=(hot[:4] + torch.randn((4, w, h), generator=g,
                                          device=dev)).contiguous()
              if trig else None)
    name = fused_substep2.k1_instance(
        kw.get("rsqrt", False), kw.get("rollgroup", False), trig, detect,
        kw.get("nospring", False) or kw.get("noint", False))
    before = dict(fused_substep2.K1_INSTANCE_LAUNCHES)
    got = fused_substep2.fused_substep2_call(hot, immut, cvec, **kw)
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
    torch.cuda.synchronize()
    after = fused_substep2.K1_INSTANCE_LAUNCHES
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    got = list(got) if isinstance(got, tuple) else [got]
    ref = list(ref) if isinstance(ref, tuple) else [ref]
    if trig:
        gs, rs = got.pop(1), ref.pop(1)
        assert same_bits(gs[:2], rs[:2]), name
        scale = torch.stack([torch.where(alive, got[0][k].abs(), 0.0).sum()
                             for k in (2, 3)])
        fin = torch.isfinite(rs[2:])
        assert same_bits(gs[2:][~fin], rs[2:][~fin]), name
        assert bool(((gs[2:] - rs[2:]).abs()[fin]
                     <= 1e-5 * scale[fin]).all()), name
    for a, b in zip(got, ref):
        assert same_bits(a, b), name
    if want:
        side = got[-1]
        flags = band_detect.band_flags_plain(
            hot[0], hot[1], torch.zeros_like(hot[0]),
            torch.full_like(hot[0], float(cvec[45])), alive,
            FarFieldSpec().band_half_offsets(stencil))
        for (x, y), hit in want.items():
            assert bool(flags[x, y]) == hit, (name, x, y)
            x4 = x - x % 4
            assert bool(side[8, x // 4, y]) == bool(
                flags[x4:x4 + 4, y].any()), (name, x, y)


def _hairpin_lattice(dev):
    """A 96 x 4 strip folded back on itself (tests/test_farfield.py::
    hairpin, without JAX): index-distant layers in contact."""
    w, h, spacing = 96, 4, 10.0
    ls = make_lattice(w, h, spacing, spring=0.0, damp=0.0, yield_strain=10.0,
                      strain_limit=100.0, device=dev)
    pos = np.zeros((w, h, 2), np.float32)
    vel = np.zeros((w, h, 2), np.float32)
    for i in range(w):
        lower = i < w // 2
        pos[i, :, 0] = 100.0 + (i if lower else w - 1 - i) * spacing + (
            0.0 if lower else 5.0)
        pos[i, :, 1] = (300.0 if lower else 306.0) + np.arange(h) * 30.0
        vel[i, :, 1] = 1.5 if lower else -1.5
    return dataclasses.replace(ls, pos=torch.from_numpy(pos).to(dev),
                               vel=torch.from_numpy(vel).to(dev))


def test_far_modes_match_cpu(dev):
    """Two frames of the folded strip in the triggered mode and with
    kernel detection (strict) on the card against the CPU: the same far
    stats, state within 5e-3 / 5e-2 (the band's mean velocity and the
    far apply sum in another order)."""
    from softbody_tpu_torch.engine import FusedLatticeBackend
    from softbody_tpu_torch.ops.stencil import LatticeSpec

    ff = FarFieldSpec(max_pairs=64, max_tile_pairs=32, skin=4.0, horizon=8)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    for kw in (dict(far_mode="v3"), dict(far_detect="kernel")):
        outs = []
        for d in ("cpu", dev):
            be = FusedLatticeBackend(LatticeSpec(96, 4), cfg, farfield=ff,
                                     device=d, kernel_variants=(), **kw)
            st = be.pack_state(_hairpin_lattice(d))
            for _ in range(2):
                st = be.step(st, tb.PhysicsConstants(), tb.UserInput())
            outs.append((be.far_stats(), st[0][:4].cpu()))
        assert outs[0][0] == outs[1][0] and outs[0][0]["far_pairs"] > 0, kw
        torch.testing.assert_close(outs[1][1][:2], outs[0][1][:2], rtol=0,
                                   atol=5e-3)
        torch.testing.assert_close(outs[1][1][2:], outs[0][1][2:], rtol=0,
                                   atol=5e-2)


def test_k2_matches_plain(dev):
    state, spec, cfg, _c, spacing, g = _stirred_cloth(dev, seed=1)
    ff = FarFieldSpec(skin=0.75 * spacing, horizon=8)
    px = state.pos[..., 0].contiguous()
    py = state.pos[..., 1].contiguous()
    dev_ = torch.rand(px.shape, generator=g, device=dev) * spacing
    dev_ = torch.where(state.alive, dev_, 0.0)
    bdev = (2.0 * cfg.particle_radius + ff.skin) + dev_
    offsets = ff.band_half_offsets(2)
    before = band_detect.K2_LAUNCHES
    got = band_detect.band_flag_call(px, py, dev_, bdev, state.alive,
                                     offsets=offsets)
    ref = band_detect.band_flags_plain(px, py, dev_, bdev, state.alive,
                                       offsets)
    torch.cuda.synchronize()
    assert band_detect.K2_LAUNCHES == before + 1
    assert int(ref.sum()) > 0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("stencil", [1, 2])
def test_k3_matches_plain(dev, stencil):
    state, _spec, cfg, consts, _sp, _g = _stirred_cloth(dev, seed=2)
    planes = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
              state.vel[..., 1], state.alive)
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=stencil)
    before = collide_stencil.K3_LAUNCHES
    got = collide_stencil.collide_stencil_call(*planes, **kw)
    ref = collide_stencil.collide_stencil_plain(*planes, **kw)
    torch.cuda.synchronize()
    assert collide_stencil.K3_LAUNCHES == before + 1
    assert float(ref[1].abs().max()) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stencil", [1, 2, 3])
def test_k3_reads_strided_planes(dev, stencil):
    """The wrapper on the state's interleaved views (staged as pairs) and
    on H-major planes, without copies, bit-exact."""
    state, _spec, cfg, consts, _sp, _g = _stirred_cloth(dev, seed=3)
    views = (state.pos[..., 0], state.pos[..., 1], state.vel[..., 0],
             state.vel[..., 1])
    kw = dict(radius=cfg.particle_radius, dt=cfg.dt, ecoeff=consts.ecoeff,
              friction=consts.friction, stencil=stencil)
    ref = collide_stencil.collide_stencil_plain(
        *(v.contiguous() for v in views), state.alive, **kw)
    h_major = [v.t().contiguous().t() for v in views]
    for planes in (views, h_major):
        got = collide_stencil.collide_stencil_call(*planes, state.alive, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k2_offset_sets(dev):
    """The bands of stencils 0-3 and a scattered set, bit-exact."""
    state, spec, cfg, _c, spacing, g = _stirred_cloth(dev, seed=4)
    ff = FarFieldSpec(skin=0.75 * spacing, horizon=8)
    px = state.pos[..., 0].contiguous()
    py = state.pos[..., 1].contiguous()
    dev_ = torch.where(state.alive, torch.rand(px.shape, generator=g,
                                               device=dev) * spacing, 0.0)
    bdev = (2.0 * cfg.particle_radius + ff.skin) + dev_
    for offsets in [ff.band_half_offsets(s) for s in range(4)] + [
            [(0, 0), (7, -7), (3, 5), (1, 0)]]:
        got = band_detect.band_flag_call(px, py, dev_, bdev, state.alive,
                                         offsets=offsets)
        ref = band_detect.band_flags_plain(px, py, dev_, bdev, state.alive,
                                           offsets)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("chunk", [1, 2, 8, 16, 32])
def test_k2_other_chunks(dev, chunk):
    """The bands of chunks other than 4: none at chunk 1, the compile-time
    box at 2, the box set at launch at 8-32; bit-exact."""
    state, spec, cfg, _c, spacing, g = _stirred_cloth(dev, seed=5)
    ff = FarFieldSpec(chunk=chunk, skin=0.75 * spacing, horizon=8)
    px = state.pos[..., 0].contiguous()
    py = state.pos[..., 1].contiguous()
    dev_ = torch.where(state.alive, torch.rand(px.shape, generator=g,
                                               device=dev) * spacing, 0.0)
    bdev = (2.0 * cfg.particle_radius + ff.skin) + dev_
    offsets = ff.band_half_offsets(2)
    before = band_detect.K2_LAUNCHES
    got = band_detect.band_flag_call(px, py, dev_, bdev, state.alive,
                                     offsets=offsets)
    ref = band_detect.band_flags_plain(px, py, dev_, bdev, state.alive,
                                       offsets)
    torch.cuda.synchronize()
    assert band_detect.K2_LAUNCHES == before + 1
    assert torch.equal(got, ref)
    assert (int(ref.sum()) > 0) == (chunk > 1)


def same_bits(got, ref) -> bool:
    """Bit for bit, NaN where ``ref`` has NaN (the payloads aside)."""
    nan = torch.isnan(ref)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            ref[~nan].view(torch.int32)))


@pytest.mark.parametrize("stencil", [1, 2])
def test_k1_k4_constants_that_overflow_clip(dev, stencil):
    """dt = 1e-19: clip overflows for every pair apart, whose plain terms
    are NaN; K1 and K4 must keep every pair on the full path."""
    state, cfg, consts, _g = _stirred_lattice(dev, 97, 61, seed=7)
    hot, _obs, immut, ec = fused_substep2.pack_lattice2(state)
    cvec = torch.cat([tb.consts_vector(consts, tb.UserInput(), cfg, 61), ec])
    cvec[1] = 1e-19
    kw = dict(stencil=stencil, quantized=True)
    got = fused_substep2.fused_substep2_call(hot, immut, cvec, **kw)
    ref = fused_substep2.fused_substep2_plain(hot, immut, cvec, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[:6]).any()) and same_bits(got, ref)
    mut, immut4 = fused_substep.pack_lattice(state)
    cvec4 = cvec[:20].clone()
    got = fused_substep.fused_substep_call(mut, immut4, cvec4, **kw)
    ref = fused_substep.fused_substep_plain(mut, immut4, cvec4, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[:6]).any()) and same_bits(got, ref)


@pytest.mark.parametrize("shape", K14_SHAPES, ids=K14_IDS)
@pytest.mark.parametrize("stencil", [0, 1, 2, 3])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("with_far", [False, True])
def test_k4_matches_plain(dev, with_far, quantized, stencil, shape):
    """Per-edge varied edge parameters, with and without a far delta
    stack."""
    w, h = shape
    state, cfg, consts, g = _stirred_lattice(dev, w, h, seed=3 + w + h)
    mut, immut = fused_substep.pack_lattice(state)
    immut[2:] *= 0.5 + torch.rand(immut[2:].shape, generator=g, device=dev)
    cvec = tb.consts_vector(consts, tb.UserInput(), cfg, h)
    far = torch.randn((5, w, h), generator=g, device=dev) * 0.5
    kw = dict(stencil=stencil, quantized=quantized,
              far=far if with_far else None)
    before = fused_substep.K4_LAUNCHES
    got = fused_substep.fused_substep_call(mut, immut, cvec, **kw)
    ref = fused_substep.fused_substep_plain(mut, immut, cvec, **kw)
    torch.cuda.synchronize()
    assert fused_substep.K4_LAUNCHES == before + 1
    assert torch.equal(got[6:], ref[6:])
    _assert_particles_close(got, ref)


@pytest.mark.parametrize("rows", [64, 40320])
def test_k5_k6_match_plain(dev, rows):
    """The casts are copies: bit-exact, new tensors."""
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 128), generator=g, device=dev)
    before = (recmirror.K5_LAUNCHES, recmirror.K6_LAUNCHES)
    y = recmirror.cast_rows_call(x)
    back = recmirror.uncast_rows_call(y)
    torch.cuda.synchronize()
    assert (recmirror.K5_LAUNCHES, recmirror.K6_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y, recmirror.cast_rows_plain(x))
    assert torch.equal(back, recmirror.uncast_rows_plain(y))
    assert torch.equal(back, x) and back.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("w,h,w_out,h_out", [
    (256, 256, 256, 256), (96, 40, 96, 64), (1000, 1000, 1008, 1024)])
def test_k7_matches_plain(dev, w, h, w_out, h_out):
    """The record table bit-exact, the zero pad included."""
    g = torch.Generator(device=dev).manual_seed(w + h)
    planes = [torch.randn((w, h), generator=g, device=dev) for _ in range(5)]
    before = recmirror.K7_LAUNCHES
    got = recmirror.mirror_records_call(planes, w_out=w_out, h_out=h_out)
    torch.cuda.synchronize()
    assert recmirror.K7_LAUNCHES == before + 1
    ref = recmirror.mirror_records_plain(planes, w_out=w_out, h_out=h_out)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mb", [64, 128])
@pytest.mark.parametrize("w,h,w_out", [(96, 40, 96), (1000, 1000, 1008)])
def test_k7_lane_block_matches_plain(dev, w, h, w_out, mb):
    """K7 at a lane block wider than 32 (JAX's ``far_mb``): the table
    bit-exact, H padded to the block."""
    g = torch.Generator(device=dev).manual_seed(w + mb)
    planes = [torch.randn((w, h), generator=g, device=dev) for _ in range(5)]
    h_out = -(-h // mb) * mb
    before = recmirror.K7_LAUNCHES
    got = recmirror.mirror_records_call(planes, w_out=w_out, h_out=h_out,
                                        mb=mb)
    torch.cuda.synchronize()
    assert recmirror.K7_LAUNCHES == before + 1
    assert tuple(got.shape) == (h_out // mb * (w_out // 4), 20 * mb)
    ref = recmirror.mirror_records_plain(planes, w_out=w_out, h_out=h_out,
                                         mb=mb)
    assert torch.equal(got, ref)


def test_fused_engine_on_the_card(dev):
    """``LatticeEngine(fused=True)`` with far field on a 40 × 40 tearing
    cloth: frames step on the worker thread through K1 and K2; once the
    engine is hidden (no more frames), a packet equals a synchronous
    readback of the copies it was made from, and the L1 round trip is
    byte-equal."""
    from softbody_tpu_torch.engine import EngineOptions, LatticeEngine

    state, spec, cfg, consts, spacing, _g = _stirred_cloth(dev, seed=6)
    opts = EngineOptions(subticks=cfg.subticks,
                         particle_radius=cfg.particle_radius, target_fps=30.0)
    ff = FarFieldSpec(max_pairs=1024, max_tile_pairs=64,
                      skin=0.75 * spacing, horizon=8)
    before = fused_substep2.K1_LAUNCHES
    with LatticeEngine(state, spec, consts, opts, farfield=ff, fused=True,
                       device=dev) as eng:
        t_end = time.monotonic() + 60.0
        while eng.stats().frame_index < 3:
            assert time.monotonic() < t_end
            time.sleep(0.01)
        eng.set_hidden(True)
        buf = eng.save_snapshot()  # after the pause: no frame steps now
        pkt = eng.render_packet()
        src = eng._worker._render_src
        assert pkt.frame_index == eng.stats().frame_index
        assert (pkt.pos == src.tensors[0].cpu().numpy()).all()
        assert eng.load_snapshot(buf) and eng.save_snapshot() == buf
        assert eng.error is None
    assert fused_substep2.K1_LAUNCHES - before >= 3 * cfg.subticks


def test_planified_substeps_with_k3_match_cpu(dev):
    """Two planified substeps of ``multi_blob(4)`` with ``use_pallas``
    (K3, the exception pass on the card) against the same substeps on
    the CPU (K3's plain version): the embedding identical, edge and
    exception state bit-exact, particles within K1's tolerances (the
    integration's float ops on two devices)."""
    from softbody_tpu_torch.models import scenes
    from softbody_tpu_torch.ops import planify

    out = {}
    for d in ("cpu", dev):
        state, _cfg = scenes.multi_blob(4, blob_radius=30.0, device=d)
        ps, spec, aux = planify.planify(state, collision_stencil=3,
                                        chunk_multiple=16)
        cfg = tb.StaticConfig(subticks=8, particle_radius=10.5,
                              use_pallas=True)
        before = collide_stencil.K3_LAUNCHES
        for _ in range(2):
            ps = planify.planified_substep(ps, tb.PhysicsConstants(),
                                           tb.UserInput(), spec, cfg)
        out[str(d)] = (ps, aux, collide_stencil.K3_LAUNCHES - before)
    (ref, aux_c, k3_c), (got, aux_g, k3_g) = out["cpu"], out[str(dev)]
    assert (k3_c, k3_g) == (0, 2) and aux_g.n_exceptions > 0
    assert (aux_c.cell_of == aux_g.cell_of).all()
    for e_g, e_c in zip(got.lat.edges, ref.lat.edges):
        for k in ("target_length", "last_length", "alive"):
            assert torch.equal(getattr(e_g, k).cpu(), getattr(e_c, k)), k
    for k in ("target_length", "last_length", "alive"):
        assert torch.equal(getattr(got.x, k).cpu(), getattr(ref.x, k)), k
    for k, tol in (("pos", 1e-4), ("vel", 1e-3), ("acc", 1e-2)):
        torch.testing.assert_close(getattr(got.lat, k).cpu(),
                                   getattr(ref.lat, k), rtol=0, atol=tol)


def _hairpin(dev):
    """A 96 × 4 strip folded back on itself (tests/test_farfield.py::
    hairpin): index-distant layers in contact, approaching slowly."""
    w, h, spacing = 96, 4, 10.0
    ls = make_lattice(w, h, spacing, spring=0.0, damp=0.0,
                      yield_strain=10.0, strain_limit=100.0, device=dev)
    half = w // 2
    pos = torch.zeros((w, h, 2))
    vel = torch.zeros((w, h, 2))
    for i in range(w):
        xi = i if i < half else w - 1 - i
        pos[i, :, 0] = 100.0 + xi * spacing + (0.0 if i < half else 5.0)
        pos[i, :, 1] = ((300.0 if i < half else 306.0)
                        + torch.arange(h) * 30.0)
        vel[i, :, 1] = 1.5 if i < half else -1.5
    return dataclasses.replace(ls, pos=pos.to(dev), vel=vel.to(dev))


@pytest.mark.parametrize("far_mb", [32, 64])
def test_fused_frame4_activation_matches_plain(dev, far_mb):
    """``fused_frame4(activation=True)`` on the hairpin through K1, K2
    and the far apply (a 512-pair list, bucket 512) against the same two
    frames on the CPU (the plain versions): the same stats, the state
    within the far apply's tolerances (tests/test_torch_frame.py; a
    stirred cloth is too chaotic for any tolerance over a frame: a 1e-6
    change of its velocities moves positions by 0.1 in 8 substeps).  The
    default record layout takes K8 on the card (K8a and K8b once a
    substep, K7 never); an explicit lane block (``far_mb=64``) keeps the
    record table, K7 once a substep."""
    from softbody_tpu_torch.ops.stencil import LatticeSpec

    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    out = {}
    for d in ("cpu", dev):
        hot, obs, immut, ec = fused_substep2.pack_lattice2(_hairpin(d))
        before = (recmirror.K7_LAUNCHES, far_apply.K8A_LAUNCHES,
                  far_apply.K8B_LAUNCHES)
        for _ in range(2):
            hot, obs, st = fused_substep2.fused_frame4(
                hot, obs, immut, ec, tb.PhysicsConstants(), tb.UserInput(),
                spec, cfg, ff, activation=True, far_mb=far_mb)
        after = (recmirror.K7_LAUNCHES, far_apply.K8A_LAUNCHES,
                 far_apply.K8B_LAUNCHES)
        out[str(d)] = (hot.cpu(), st.tolist(),
                       tuple(a - b for a, b in zip(after, before)))
    (ref, st_c, n_c), (got, st_g, n_g) = out["cpu"], out[str(dev)]
    assert st_g == st_c and st_c[1] > 0 and st_c[3] <= st_c[1]
    every = 2 * cfg.subticks
    assert n_c == (0, 0, 0)
    assert n_g == ((0, every, every) if far_mb == 32 else (every, 0, 0))
    torch.testing.assert_close(got[0:2], ref[0:2], rtol=0, atol=5e-3)
    torch.testing.assert_close(got[2:4], ref[2:4], rtol=0, atol=5e-2)


def test_stirred_cloth_activation_matches_cpu(dev, monkeypatch):
    """The stirred 40 × 40 cloth (one state, copied to both devices): the
    activation schedule of its first rebuild is bit-exact card vs CPU
    (K2 on the card); then one frame of ``fused_frame4`` with the
    schedule off and on, twice on the card, without torch's deterministic
    algorithms: the far apply (K8 on the card) sums each destination in
    list order, so the two card runs are bit-identical and equal the
    CPU's frame bit for bit, far stats included.  The CPU's frame takes
    K8's plain versions here (the route forced for this test: the CPU
    keeps the record-table routes, which add each side's 16 terms in
    torch's order).

    This scene magnifies one rounding difference to tens of units in a
    frame (on the CPU the schedule alone, which changes only the order
    of the far sums, parts the frame by that much: printed)."""
    from softbody_tpu_torch.convert import (
        lattice_state_from_numpy,
        lattice_state_to_numpy,
    )
    from softbody_tpu_torch.ops.farfield import rebuild_far_list_planes_active


    assert not torch.are_deterministic_algorithms_enabled()
    card_route = farfield4.kernel_route
    monkeypatch.setattr(farfield4, "kernel_route",
                        lambda device, mb=32, mb_out=None: card_route(
                            "cuda", mb, mb_out))
    state, spec, cfg, consts, spacing, _g = _stirred_cloth("cpu", seed=6)
    fields = lattice_state_to_numpy(state)
    ff = FarFieldSpec(max_pairs=1024, max_tile_pairs=64,
                      skin=0.75 * spacing, horizon=8)
    sched, out = {}, {}

    def frame(st, act):
        hot, obs, immut, ec = fused_substep2.pack_lattice2(st)
        hot, obs, s = fused_substep2.fused_frame4(
            hot, obs, immut, ec, consts, tb.UserInput(), spec, cfg, ff,
            activation=act)
        return hot[0:6].cpu(), s.tolist()

    for d in ("cpu", dev):
        st = lattice_state_from_numpy(**fields, device=d)
        fl, n_act = rebuild_far_list_planes_active(
            st.pos[..., 0], st.pos[..., 1], st.alive, s=spec.collision_stencil,
            ff=ff, radius=cfg.particle_radius, vx=st.vel[..., 0],
            vy=st.vel[..., 1], dt=cfg.dt, R=ff.horizon)
        sched[str(d)] = [t.cpu() for t in (fl.ca, fl.cb, fl.valid,
                                           fl.n_pairs, fl.overflow, n_act)]
        for act in (False, True):
            for run in ((1, 2) if d == dev else (1,)):
                out[str(d), act, run] = frame(st, act)
    for a, b in zip(sched["cpu"], sched[str(dev)]):
        assert torch.equal(a, b)
    assert int(sched["cpu"][3]) > 0
    dpos = out["cpu", True, 1][0][0:2] - out["cpu", False, 1][0][0:2]
    print("stirred cloth, one frame, CPU schedule on vs off: max |dpos| "
          f"{dpos.abs().max():.4g}")
    for act in (False, True):
        cpu, g1, g2 = (out["cpu", act, 1], out[str(dev), act, 1],
                       out[str(dev), act, 2])
        assert cpu[1][1] > 0
        assert torch.equal(g1[0], g2[0]) and g1[1] == g2[1]
        assert torch.equal(g1[0], cpu[0]) and g1[1] == cpu[1]


@pytest.mark.parametrize("width", [2, 3, 5, 32, 640])
def test_index_sum_card_matches_cpu(dev, width):
    """The fixed-order scatter on the card equals the CPU's ``index_add_``
    bit for bit, with up to ~4000 rows on one index (more than a warp)."""
    from softbody_tpu_torch.ops.stencil import index_sum

    g = torch.Generator().manual_seed(width)
    n_src = 400_000 // width
    idx = torch.randint(0, 97, (n_src,), generator=g)
    idx[: n_src // 4] = 5
    src = torch.randn(n_src, width, generator=g) * torch.exp(
        torch.randn(n_src, width, generator=g) * 5)
    ref = torch.zeros(97, width).index_add_(0, idx, src)
    got = index_sum(idx.to(dev), src.to(dev), 97)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(index_sum(idx.to(dev), src.to(dev), 97), got)
    # the far apply's empty slots: zero rows left out through ``keep``
    keep = torch.rand(n_src, generator=g) > 0.3
    src[~keep] = -0.0
    ref = torch.zeros(97, width).index_add_(0, idx, src)
    got = index_sum(idx.to(dev), src.to(dev), 97, keep=keep.to(dev))
    assert torch.equal(got.cpu(), ref)
    with pytest.raises(ValueError, match="rows of >= 2 values"):
        index_sum(idx.to(dev), src[:, 0].to(dev), 97)


def _list_on(fl, device):
    """The far list ``fl`` with every tensor on ``device``."""
    return dataclasses.replace(fl, **{
        f.name: getattr(fl, f.name).to(device)
        for f in dataclasses.fields(fl)
        if isinstance(getattr(fl, f.name), torch.Tensor)})


_K8_CASES = {}


def _k8_case(dev, case):
    """``(hot [4, W, H], alive_f, fl, apply keywords)`` on the card:

    - ``tear12``: the 1M tearing sheet (the benchmark's ``cloth1m-tear``
      scene) after 12 frames of ``FusedLatticeBackend``, its list rebuilt
      there (thousands of pairs, the 4096 bucket);
    - ``fold100k``: the 100k cloth's 632 × 160 plane folded onto itself
      (``kernel_cases.far_fold``): 3160 listed pairs of 16384 slots, ~90k
      cells in shallow contact;
    - ``at_rest``: the 100k cloth at rest, 6408 listed neighbouring
      chunk pairs that do not touch (the fold's at-rest list);
    - ``no_valid``: the fold with every slot empty;
    - ``pile``: the 100k plane collapsed into a pile a few spacings wide
      (``kernel_cases.far_collapse``), 6408 valid slots, deep overlaps:
      deltas up to ~1e4, where two sum orders part by more than 1e-5."""
    if case in _K8_CASES:
        return _K8_CASES[case]
    from softbody_tpu_torch.engine import FusedLatticeBackend
    from softbody_tpu_torch.ops.farfield import rebuild_far_list_planes

    kw = dict(s=2, ecoeff=0.75, friction=0.1, dt=1.0 / 64)
    if case == "tear12":
        state, spec, cfg, consts = tearing_cloth_lattice(
            n_particles=1_000_000, spring=200.0, damp=10.0,
            strain_limit=0.22, yield_strain=0.18, collision_stencil=2,
            fall_speed=2.5, slits=7, device=dev)
        spacing = 980.0 / (state.shape[0] - 1)
        ff = FarFieldSpec(max_pairs=16384, max_tile_pairs=256,
                          skin=0.75 * spacing, horizon=8)
        be = FusedLatticeBackend(spec, cfg, farfield=ff, device=dev)
        st = be.pack_state(state)
        for _ in range(12):
            st = be.step(st, consts, tb.UserInput())
        hot, _obs, immut, _ec = fused_substep2.pack_lattice2(
            be.unpack_state(st))
        hot, alive_f = hot[:4].contiguous(), immut[0].contiguous()
        fl = rebuild_far_list_planes(hot[0], hot[1], alive_f > 0, s=2, ff=ff,
                                     radius=cfg.particle_radius, vx=hot[2],
                                     vy=hot[3], dt=cfg.dt)
        kw = dict(kw, radius=cfg.particle_radius, dt=cfg.dt,
                  ecoeff=consts.ecoeff, friction=consts.friction)
    else:
        w, h, k, n = 632, 160, 16384, 6408
        radius = 2.4
        planes, ca, cb, valid = kernel_cases.far_fold(w, h, k, seed=7)
        if case == "pile":
            radius = 4.5
            planes, ca, cb, valid = kernel_cases.far_collapse(w, h, k, n,
                                                              seed=7)
        if case == "at_rest":
            ls = make_lattice(w, h, 10.0, device="cpu")
            planes = (ls.pos[..., 0].contiguous(), ls.pos[..., 1].contiguous(),
                      torch.zeros((w, h)), torch.zeros((w, h)),
                      torch.ones((w, h)))
            cwy = h // 4
            ca = torch.arange(k) % ((w // 4) * cwy - cwy - 2)
            cb = ca + cwy + torch.arange(k) % 3
            ca[n:] = cb[n:] = (w // 4) * cwy - 1
            valid = torch.arange(k) < n
        if case == "no_valid":
            valid = torch.zeros_like(valid)
        fl = kernel_cases.far_list(ca, cb, valid)
        ff = FarFieldSpec(max_pairs=k, max_tile_pairs=256, skin=3.0,
                          horizon=8)
        hot = torch.stack(planes[:4]).to(dev)
        alive_f = planes[4].to(dev)
        fl = _list_on(fl, dev)
        kw = dict(kw, radius=radius)
    _K8_CASES[case] = hot, alive_f, fl, dict(kw, ff=ff)
    return _K8_CASES[case]


@pytest.mark.parametrize("case", ["tear12", "fold100k", "at_rest",
                                  "no_valid"])
def test_k8_matches_plain_route(dev, case):
    """K8 (the card's default layout) against the plain route on the CPU
    (narrow or mirror: the same inputs copied there) within 1e-5, and
    against K8's plain versions on the CPU bit for bit; zeros where the
    plain route gives zeros (the at-rest list, no valid slot).  On the
    card: bit-identical run to run, the host-count route equal to the
    device switch, one K8a and one K8b launch an apply and no K7."""
    from softbody_tpu_torch.ops.farfield import _chunk_dims

    hot, alive_f, fl, kw = _k8_case(dev, case)
    n = max(fl.counts()[0], 1)
    routes = dict(farfield4.APPLY_ROUTES)
    counts = (recmirror.K7_LAUNCHES, far_apply.K8A_LAUNCHES,
              far_apply.K8B_LAUNCHES)
    got = farfield4.bucketed_far_delta_planes(hot, alive_f, fl, n, **kw)
    again = farfield4.bucketed_far_delta_planes(hot, alive_f, fl, n, **kw)
    switch = farfield4.bucketed_far_delta_planes(hot, alive_f, fl, None,
                                                 **kw)
    torch.cuda.synchronize()
    assert farfield4.APPLY_ROUTES["kernel"] - routes["kernel"] == (
        2 + (int(fl.n_pairs) > 0))
    assert (recmirror.K7_LAUNCHES - counts[0], far_apply.K8A_LAUNCHES
            - counts[1], far_apply.K8B_LAUNCHES - counts[2]) == (
        0, 2 + (int(fl.n_pairs) > 0), 2 + (int(fl.n_pairs) > 0))
    assert torch.equal(got, again) and torch.equal(got, switch)
    cpu = (hot.cpu(), alive_f.cpu(), _list_on(fl, "cpu"))
    ref = farfield4.bucketed_far_delta_planes(*cpu, n, **kw)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)
    w, h = alive_f.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, kw["ff"])
    k = farfield4.bucket_capacity(n, kw["ff"], (1024, 4096))
    flk = farfield.crop_far_list(cpu[2], k)
    order = far_apply.dest_order(cpu[2].ca, cpu[2].cb, cpu[2].valid,
                                 (wp // 4) * (hp // 4))
    plain = farfield4.far_delta_planes_kernel(
        (cpu[0][0], cpu[0][1], cpu[0][2], cpu[0][3], cpu[1]), flk, order,
        w=wp, h=hp, **kw)[:, :w, :h]
    assert same_bits(got.cpu(), plain)
    touching = float(ref.abs().max())
    if case in ("at_rest", "no_valid"):
        assert touching == 0.0 and float(got.abs().max()) == 0.0
    else:
        assert touching > 0.0


def test_k8_kernels_match_plain_on_a_pile(dev):
    """K8a's rows of the valid slots and K8b's planes on the deep pile
    (self pairs, neighbouring chunks, coincident and dead particles)
    against their plain versions on the CPU bit for bit; the empty
    slots' rows unwritten; the host-count apply equal to the two."""

    hot, alive_f, fl, kw = _k8_case(dev, "pile")
    w, h = alive_f.shape
    planes = (hot[0], hot[1], hot[2], hot[3], alive_f)
    cpu_planes = tuple(p.cpu() for p in planes)
    k = fl.capacity
    akw = dict(s=kw["s"], ff=kw["ff"], radius=kw["radius"], dt=kw["dt"],
               ecoeff=kw["ecoeff"], friction=kw["friction"], h=h,
               world_h=-(-h // 32) * 32)
    rows = far_apply.far_pairs_call(planes, fl, **akw)
    ref_rows = far_apply.far_pairs_plain(cpu_planes, _list_on(fl, "cpu"),
                                         **akw)
    sides = torch.cat([fl.valid, fl.valid]).cpu()
    assert same_bits(rows.cpu()[sides], ref_rows[sides])
    assert float(ref_rows[sides].abs().max()) > 1e3
    order = far_apply.dest_order(fl.ca, fl.cb, fl.valid, (w // 4) * (h // 4))
    cpu_order = far_apply.dest_order(*(t.cpu() for t in (
        fl.ca, fl.cb, fl.valid)), (w // 4) * (h // 4))
    assert torch.equal(order.sides.cpu(), cpu_order.sides)
    assert torch.equal(order.offsets.cpu(), cpu_order.offsets)
    out = far_apply.far_accumulate_call(rows, order, fl.valid,
                                        torch.empty((5, w, h), device=dev),
                                        h=h)
    ref = far_apply.far_accumulate_plain(
        ref_rows, cpu_order, fl.valid.cpu(), torch.empty((5, w, h)), h=h)
    assert same_bits(out.cpu(), ref)
    got = farfield4.bucketed_far_delta_planes(hot, alive_f, fl, k, **kw)
    assert same_bits(got.cpu(), ref)


def test_render_frame_card_matches_cpu(dev):
    """The rasterizer on the card gives the CPU's image as uint8, on a
    stirred 48 × 48 cloth with some beams dead (several beam and
    particle chunks)."""
    from softbody_tpu_torch import viz
    from softbody_tpu_torch.models import lattice_to_simstate

    state, _spec, cfg, _consts, _spacing, g = _stirred_cloth("cpu", seed=3,
                                                             side=48)
    sim = lattice_to_simstate(state, build_incidence=False, device="cpu")
    sim.beam_alive &= torch.rand(sim.beam_alive.shape, generator=g) > 0.2
    sim.beam_stress = torch.randn(sim.beam_stress.shape, generator=g)
    imgs = []
    for d in ("cpu", dev):
        on_d = dataclasses.replace(
            sim, **{f.name: getattr(sim, f.name).to(d)
                    for f in dataclasses.fields(sim)
                    if getattr(sim, f.name) is not None})
        img = viz.render_state(on_d, cfg, resolution=512)
        imgs.append(torch.round(img * 255).to(torch.uint8).cpu())
    assert torch.equal(imgs[0], imgs[1])
    assert int((imgs[0].sum(-1) > 0).sum()) > 10_000


def _slab_mesh(dev, n=4):
    from softbody_tpu_torch.parallel import make_mesh

    return make_mesh(n, dp=1, devices=[dev] * n)


def test_sharded_fused_frames_match_unsharded(dev):
    """The stirred 40 × 40 cloth in 4 slabs on one card: K4
    (``fused_spatial``) and K1 (``fused_spatial2``, near field) equal the
    single-device frames bit for bit, each kernel launched once a slab a
    substep."""
    from softbody_tpu_torch.parallel import fused_spatial as pfs
    from softbody_tpu_torch.parallel import fused_spatial2 as pfs2

    state, spec, cfg, consts, _spacing, _g = _stirred_cloth(dev)
    cfg = dataclasses.replace(cfg, subticks=8)
    uin = tb.UserInput()
    mesh = _slab_mesh(dev)
    ring = pfs.ghost_width(spec)

    mut, immut = fused_substep.pack_lattice(state)
    ref4 = fused_substep.fused_frame(mut, immut, consts, uin, spec, cfg)
    m, im, w_loc = pfs.pack_lattice_sharded(state, 4, ghost=ring)
    m, im = pfs.shard_stacks(m, im, mesh)
    k4 = fused_substep.K4_LAUNCHES
    out = pfs.fused_spatial_frame_fn(spec, cfg, mesh)(m, im, consts, uin)
    assert fused_substep.K4_LAUNCHES - k4 == 4 * cfg.subticks
    assert torch.equal(pfs.interiors(out, w_loc, dev), ref4)

    hot, obs, imm, ec = fused_substep2.pack_lattice2(state)
    ref_h, ref_o = fused_substep2.fused_frame2(hot, obs, imm, ec, consts,
                                               uin, spec, cfg)
    h, o, i2, ec2, w_loc = pfs2.pack_lattice2_sharded(state, 4, ghost=ring)
    h, o, i2 = pfs2.shard_stacks2(h, o, i2, mesh)
    k1 = fused_substep2.K1_LAUNCHES
    h, o = pfs2.fused_spatial2_frame_fn(spec, cfg, mesh)(h, o, i2, ec2,
                                                         consts, uin)
    assert fused_substep2.K1_LAUNCHES - k1 == 4 * cfg.subticks
    assert torch.equal(pfs.interiors(h, w_loc, dev), ref_h)
    assert torch.equal(pfs.interiors(o, w_loc, dev), ref_o)


def test_sharded_lattice_with_k3_matches_unsharded(dev):
    """``lattice_spatial`` with ``use_pallas`` in 4 slabs on one card: K3
    on each slab every substep, the frame equal to the single-device
    ``lattice_frame`` bit for bit."""
    from softbody_tpu_torch.ops.stencil import lattice_frame
    from softbody_tpu_torch.parallel.lattice_spatial import (
        lattice_spatial_frame_fn,
        shard_lattice,
        unshard_lattice,
    )

    state, spec, cfg, consts, _spacing, _g = _stirred_cloth(dev)
    cfg = dataclasses.replace(cfg, subticks=8, use_pallas=True)
    uin = tb.UserInput()
    mesh = _slab_mesh(dev)
    ref = lattice_frame(state, consts, uin, spec, cfg)
    k3 = collide_stencil.K3_LAUNCHES
    got = unshard_lattice(lattice_spatial_frame_fn(spec, cfg, mesh)(
        shard_lattice(state, mesh), consts, uin))
    assert collide_stencil.K3_LAUNCHES - k3 == 4 * cfg.subticks
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for eg, er in zip(got.edges, ref.edges):
        for f in dataclasses.fields(eg):
            assert torch.equal(getattr(eg, f.name), getattr(er, f.name))


def _sharded_case(case, dev):
    """A sharded step on a 2-shard mesh of this card, its first frame's
    arguments and the next frame's from a frame's output."""
    from softbody_tpu_torch.models import scenes
    from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
    from softbody_tpu_torch.ops.stencil import LatticeSpec
    from softbody_tpu_torch.parallel import (
        batched_frame_fn,
        device_put_batched,
        make_mesh,
        pad_state_for_mesh,
        shard_state,
        spatial_frame_fn,
        stack_states,
    )
    from softbody_tpu_torch.parallel import fused_spatial as pfs
    from softbody_tpu_torch.parallel import fused_spatial2 as pfs2
    from softbody_tpu_torch.parallel.lattice_spatial import (
        lattice_spatial_frame_fn,
        shard_lattice,
    )

    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    mesh = _slab_mesh(dev, 2)
    nxt = (lambda a, o: (o,) + a[1:])
    if case in ("spatial", "batched"):
        st, cfg = scenes.cloth(8, 8, device=dev)
        cfg = dataclasses.replace(cfg, subticks=8)
        if case == "spatial":
            return (spatial_frame_fn(cfg, mesh),
                    (shard_state(pad_state_for_mesh(st, 2), mesh), consts,
                     uin), nxt)
        dmesh = make_mesh(2, dp=2, devices=[dev] * 2)
        return (batched_frame_fn(cfg, dmesh),
                (device_put_batched(stack_states([st] * 4), dmesh), consts,
                 uin), nxt)
    state, spec, cfg, consts, _spacing, _g = _stirred_cloth(dev)
    cfg = dataclasses.replace(cfg, subticks=8)
    if case == "lattice K3":
        cfg = dataclasses.replace(cfg, use_pallas=True)
        return (lattice_spatial_frame_fn(spec, cfg, mesh),
                (shard_lattice(state, mesh), consts, uin), nxt)
    if case == "K4":
        m, im, _w = pfs.pack_lattice_sharded(state, 2,
                                             ghost=pfs.ghost_width(spec))
        m, im = pfs.shard_stacks(m, im, mesh)
        return (pfs.fused_spatial_frame_fn(spec, cfg, mesh),
                (m, im, consts, uin), nxt)
    ff = FarFieldSpec(skin=8.0, horizon=4, max_pairs=128, max_tile_pairs=32)
    spec = LatticeSpec(16, 8, collision_stencil=2)
    cfg = tb.StaticConfig(subticks=4, particle_radius=5.0)
    ls = folded_strip_lattice(16, 8, device=dev)
    h, o, im, ec, _w = pfs2.pack_lattice2_sharded(
        ls, 2, ghost=pfs.ghost_width(spec, ff))
    h, o, im = pfs2.shard_stacks2(h, o, im, mesh)
    return (pfs2.fused_spatial2_frame_fn(spec, cfg, mesh, ffspec=ff,
                                         rebuild_every=2),
            (h, o, im, ec, consts, uin),
            lambda a, out: tuple(out) + a[2:])


@pytest.mark.parametrize("case", ["spatial", "batched", "lattice K3", "K4",
                                  "K1 far"])
def test_captured_sharded_steps_match_eager(dev, case):
    """Each sharded step with every shard on this card: one capture, then
    replays, over three frames, each equal bit for bit to its eager twin
    with equal launches, no host read in a captured frame, the input
    left as it was."""
    from softbody_tpu_torch.ops import compiled

    step, args, nxt = _sharded_case(case, dev)
    assert step.captured
    before = [t.clone() for t in compiled.tensors(args)]
    cap = eag = args
    for _ in range(3):
        counts = compiled.read_counts()
        reads = compiled.HOST_READS
        out_c = step(*cap)
        torch.cuda.synchronize()
        assert compiled.HOST_READS == reads
        launched = compiled._count_delta(compiled.read_counts(), counts)
        counts = compiled.read_counts()
        out_e = step.eager(*eag)
        torch.cuda.synchronize()
        assert compiled._count_delta(compiled.read_counts(), counts) == \
            launched
        assert all(same_bits(x, y) if x.dtype == torch.float32
                   else torch.equal(x, y) for x, y in zip(
                       compiled.tensors(out_c), compiled.tensors(out_e)))
        cap, eag = nxt(cap, out_c), nxt(eag, out_e)
    calls = 2 if case == "batched" else 1
    assert step.stats() == {"misses": 1, "captures": 1,
                            "replays": 3 * calls, "graphs": 1}
    assert all(torch.equal(x, y)
               for x, y in zip(before, compiled.tensors(args)))


def test_psum_int32_card_matches_cpu(dev):
    """``psum`` of int32 shards on one card equals the CPU's (int32 sums
    are exact in any order, wrapping included)."""
    from softbody_tpu_torch.parallel.mesh import psum

    g = torch.Generator().manual_seed(0)
    xs = [torch.randint(-2**31, 2**31 - 1, (1000, 2), generator=g,
                        dtype=torch.int32) for _ in range(4)]
    ref = psum(xs)[0]
    got = psum([x.to(dev) for x in xs])
    assert all(torch.equal(t.cpu(), ref) for t in got)


def test_sharded_frames_across_cards(dev):
    """Four shards spread over the cards present (round robin; needs two
    or more): every sharded frame equals the same frame with all four
    shards on one card bit for bit (the collectives copy and sum in shard
    order wherever the shards live), the far-armed one with far pairs
    across the slabs, and the near-field frames equal the unsharded
    ones."""
    from softbody_tpu_torch.models import scenes
    from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
    from softbody_tpu_torch.ops.stencil import LatticeSpec, lattice_frame
    from softbody_tpu_torch.parallel import (
        make_mesh,
        pad_state_for_mesh,
        shard_state,
        spatial_frame_fn,
        unshard_state,
    )
    from softbody_tpu_torch.parallel import fused_spatial as pfs
    from softbody_tpu_torch.parallel import fused_spatial2 as pfs2
    from softbody_tpu_torch.parallel.lattice_spatial import (
        lattice_spatial_frame_fn,
        shard_lattice,
        unshard_lattice,
    )

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    spread = make_mesh(4, dp=1, devices=[torch.device("cuda", i % cards)
                                         for i in range(4)])
    one = _slab_mesh(dev)
    state, spec, cfg, consts, _spacing, _g = _stirred_cloth(dev, side=64)
    cfg = dataclasses.replace(cfg, subticks=8, use_pallas=True)
    uin = tb.UserInput()

    ref = lattice_frame(state, consts, uin, spec, cfg)
    got = unshard_lattice(lattice_spatial_frame_fn(spec, cfg, spread)(
        shard_lattice(state, spread), consts, uin), device=dev)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)

    mut, immut = fused_substep.pack_lattice(state)
    m, im, w_loc = pfs.pack_lattice_sharded(state, 4,
                                            ghost=pfs.ghost_width(spec))
    m, im = pfs.shard_stacks(m, im, spread)
    out = pfs.fused_spatial_frame_fn(spec, cfg, spread)(m, im, consts, uin)
    assert torch.equal(pfs.interiors(out, w_loc, dev),
                       fused_substep.fused_frame(mut, immut, consts, uin,
                                                 spec, cfg))

    # the far field on a strip folded across every slab boundary (the
    # settings of tests/test_fused_spatial2.py's fold): far pairs join
    # slabs on different cards
    fold = folded_strip_lattice(64, 8, device=dev)
    fspec = LatticeSpec(64, 8, collision_stencil=2)
    fcfg = tb.StaticConfig(subticks=8, collision_mode="allpairs",
                           particle_radius=4.0, force_mode="quantized")
    ff = FarFieldSpec(max_pairs=1024, max_tile_pairs=64, skin=4.0,
                      horizon=8)
    hots = {}
    for name, mesh in (("spread", spread), ("one card", one)):
        h, o, i2, ec, w_loc = pfs2.pack_lattice2_sharded(
            fold, 4, ghost=pfs.ghost_width(fspec, ff))
        h, o, i2 = pfs2.shard_stacks2(h, o, i2, mesh)
        pfs2.far_stats()
        h, o = pfs2.fused_spatial2_frame_fn(fspec, fcfg, mesh, ffspec=ff)(
            h, o, i2, ec, consts, uin)
        hots[name] = pfs.interiors(h, w_loc, dev)
        stats = pfs2.far_stats()
        print(f"far record, {name}: {stats}")
        assert stats["max_overflow"] == 0 and stats["max_pairs"] > 0, stats
    assert torch.equal(hots["spread"], hots["one card"])

    flat, gcfg = scenes.cloth(32, 32, device=dev)
    flat = pad_state_for_mesh(flat, 4)
    outs = [unshard_state(spatial_frame_fn(gcfg, mesh)(
        shard_state(flat, mesh), consts, uin), device=dev)
        for mesh in (spread, one)]
    assert torch.equal(outs[0].pos, outs[1].pos)
    assert torch.equal(outs[0].beam_alive, outs[1].beam_alive)


def _same_tensors(a, b) -> bool:
    from softbody_tpu_torch.ops.compiled import tensors

    ta, tb_ = list(tensors(a)), list(tensors(b))
    return len(ta) == len(tb_) and all(torch.equal(x, y)
                                       for x, y in zip(ta, tb_))


@pytest.mark.parametrize("scene", ["general", "lattice K3", "fold backend",
                                   "directed"])
def test_compiled_frames_match_eager(dev, scene):
    """The captured frames (``ops/compiled.py``) against the same frames
    run op by op on the card, bit for bit, two calls each (capture, then
    a replay): the general frame on a jittered ``cloth(8, 8)``, the
    lattice frame with K3 (one launch a substep on each replay) on the
    stirred 40 × 40 cloth, ``LatticeBackend`` with K3 on the far-armed
    fold (its chunks through ``lattice_frame_far_jit``), the directed
    frame on 8 blobs."""
    from softbody_tpu_torch.engine import LatticeBackend
    from softbody_tpu_torch.models import scenes
    from softbody_tpu_torch.ops import step as gstep
    from softbody_tpu_torch.ops.directed import build_directed, directed_frame
    from softbody_tpu_torch.ops.stencil import (
        LatticeSpec,
        lattice_frame,
        lattice_frame_far,
        lattice_frame_jit,
    )

    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    k3_per_call = 0
    if scene == "general":
        st, cfg = scenes.cloth(8, 8, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        st = dataclasses.replace(st, vel=torch.randn(
            st.vel.shape, generator=g, device=dev) * 3.0)

        def captured(s):
            return gstep.frame_jit(s, consts, uin, cfg)

        def eager(s):
            return gstep.frame(s, consts, uin, cfg)
    elif scene == "lattice K3":
        st, spec, cfg, consts, _spacing, _g = _stirred_cloth(dev)
        cfg = dataclasses.replace(cfg, subticks=8, use_pallas=True)
        k3_per_call = cfg.subticks

        def captured(s):
            return lattice_frame_jit(s, consts, uin, spec, cfg)

        def eager(s):
            return lattice_frame(s, consts, uin, spec, cfg)
    elif scene == "fold backend":
        st = _hairpin(dev)
        spec = LatticeSpec(96, 4)
        cfg = tb.StaticConfig(subticks=8, particle_radius=4.0,
                              use_pallas=True)
        ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0,
                          horizon=8)
        k3_per_call = cfg.subticks
        be_c = LatticeBackend(spec, cfg, farfield=ff, device=dev)
        be_e = LatticeBackend(spec, cfg, farfield=ff, device=dev)
        be_e._frame, be_e._frame_far = lattice_frame, lattice_frame_far

        def captured(s):
            return be_c.step(s, consts, uin)

        def eager(s):
            return be_e.step(s, consts, uin)
    else:
        st, cfg = scenes.multi_blob(8, device=dev)
        st = build_directed(st)[0]

        def captured(s):
            return directed_frame(s, consts, uin, cfg)

        def eager(s):
            return directed_frame.__wrapped__(s, consts, uin, cfg)

    c = e = st
    for call in range(2):
        k3 = collide_stencil.K3_LAUNCHES
        c = captured(c)
        assert collide_stencil.K3_LAUNCHES - k3 == k3_per_call, call
        e = eager(e)
        assert _same_tensors(c, e), f"{scene}, call {call}"
    if scene == "fold backend":
        assert be_c.far_stats() == be_e.far_stats()
        assert be_c.far_stats()["far_pairs"] > 0


def test_compiled_frame_with_host_read_raises(dev):
    """A frame that reads a device value on the host (``.item()``) cannot
    be captured: the call raises and returns nothing; a frame captured
    after it runs."""
    from softbody_tpu_torch.models import scenes
    from softbody_tpu_torch.ops import step as gstep
    from softbody_tpu_torch.ops.compiled import Compiled

    def reads(state, consts, uin, cfg):
        if state.pos.sum().item() > 0.0:
            state = gstep.substep(state, consts, uin, cfg)
        return state

    st, cfg = scenes.cloth(8, 8, device=dev)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    compiled = Compiled(reads, static_argnames=("cfg",))
    with pytest.raises(RuntimeError):
        compiled(st, consts, uin, cfg)
    assert compiled.stats()["captures"] == 0
    got = gstep.frame_jit(st, consts, uin, cfg)
    assert _same_tensors(got, gstep.frame(st, consts, uin, cfg))


# the fused frames' cases on the fold: (frame, options); FF_FOLD's
# ladder with buckets (16,) is (16, 512): the narrow rung and the mirror
# rung; the activation schedule starts from an empty list
FUSED_CASES = {
    "frame4 default": ("frame4", dict(kvar=fused_substep2.DEFAULT_KVAR)),
    "frame4 strict": ("frame4", dict(buckets=(16,))),
    "frame4 activation": ("frame4", dict(buckets=(16,), activation=True)),
    "frame4 kernel detect": ("frame4", dict(detect_mode="kernel",
                                            buckets=(16,))),
    "frame2_auto": ("frame2_auto", {}),
    "frame3_auto": ("frame3_auto", dict(buckets=(16,))),
    "frame2": ("frame2", {}),
    "frame2_far": ("frame2_far", {}),
}


def _fused_case(dev, case):
    """The fold packed, and ``step(fn, carry) -> carry`` of the case's
    frame through ``fn`` (the frame or its compiled counterpart); the
    carry is the frame's state: ``(hot, obs)`` and the list, side planes
    and trigger vector where the frame carries them, plus its stats."""
    from softbody_tpu_torch.ops.farfield import (
        empty_far_list,
        rebuild_far_list_planes,
    )
    from softbody_tpu_torch.ops.stencil import LatticeSpec

    P = fused_substep2
    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    hot, obs, immut, ec = P.pack_lattice2(_hairpin(dev))
    kind, kw = FUSED_CASES[case]
    fns = {"frame4": (P.fused_frame4, P.fused_frame4_jit),
           "frame2_auto": (P.fused_frame2_auto, P.fused_frame2_auto_jit),
           "frame3_auto": (P.fused_frame3_auto, P.fused_frame3_auto_jit),
           "frame2": (P.fused_frame2, P.fused_frame2_jit),
           "frame2_far": (P.fused_frame2_far, P.fused_frame2_far_jit)}[kind]
    fl = (rebuild_far_list_planes(hot[0], hot[1], immut[0] > 0, s=2, ff=ff,
                                  radius=4.0) if kind == "frame2_far"
          else empty_far_list(96, 4, ff, device=dev))
    carry = (hot, obs)
    if kind == "frame2_auto":
        carry = (hot, obs, fl)
    if kind == "frame3_auto":
        carry = (hot, obs, fl) + P.far3_carry_init(hot, immut, cfg, spec, ff)

    def step(fn, c):
        if kind == "frame4":
            return fn(*c[:2], immut, ec, consts, uin, spec, cfg, ff, **kw)
        if kind == "frame2":
            return fn(*c[:2], immut, ec, consts, uin, spec, cfg, **kw)
        if kind == "frame2_far":
            return fn(*c[:2], immut, ec, fl, consts, uin, spec, cfg, ff)
        if kind == "frame2_auto":
            return fn(c[0], c[1], immut, ec, c[2], consts, uin, spec, cfg,
                      ff)
        return fn(c[0], c[1], immut, ec, c[2], c[3], c[4], consts, uin, spec,
                  cfg, ff, **kw)

    return fns, carry, step


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_captured_fused_frames_match_eager(dev, case):
    """Each fused frame captured (``*_jit``: one CUDA graph, its bucket
    and trigger decided by IF nodes) against the same frame run op by op
    on the card: three calls each (warm-up + capture + replay, then two
    replays), the carried state and the stats bit for bit, every launch
    counter and far-apply route equal to eager's (the bodies' launches
    folded in from the device by ``sync_counts``), and no host read in
    a captured call; eager makes its reads."""
    from softbody_tpu_torch.ops import compiled

    (eager_fn, jit_fn), carry, step = _fused_case(dev, case)
    jit_fn.clear()
    captures = jit_fn.stats()["captures"]
    c = e = carry
    for call in range(3):
        compiled.sync_counts()
        before, reads = compiled.read_counts(), compiled.HOST_READS
        c = step(jit_fn, c)
        torch.cuda.synchronize()
        compiled.sync_counts()
        got = compiled._count_delta(compiled.read_counts(), before)
        assert compiled.HOST_READS == reads, f"{case}, call {call}"
        before = compiled.read_counts()
        e = step(eager_fn, e)
        want = compiled._count_delta(compiled.read_counts(), before)
        assert _same_tensors(c, e), f"{case}, call {call}"
        assert got == want, f"{case}, call {call}: {got} != {want}"
    assert jit_fn.stats()["captures"] - captures == 1
    if case.startswith("frame4"):
        assert c[2].tolist()[1] > 0, "the fold must yield far pairs"


def test_captured_fused_frame_alternates_two_states(dev):
    """Two states through one captured ``fused_frame4``: one capture, each
    trajectory equal to its eager one bit for bit."""
    (eager_fn, jit_fn), carry, step = _fused_case(dev, "frame4 strict")
    jit_fn.clear()
    captures = jit_fn.stats()["captures"]
    other = (carry[0].clone(), carry[1].clone())
    other[0][2:4] *= -1.0
    runs = {"a": [carry, carry], "b": [other, other]}
    for _ in range(2):
        for k in ("a", "b"):
            c, e = runs[k]
            runs[k] = [step(jit_fn, c)[:2], step(eager_fn, e)[:2]]
            assert _same_tensors(*runs[k]), k
    assert jit_fn.stats()["captures"] - captures == 1
    assert not torch.equal(runs["a"][0][0], runs["b"][0][0])


def test_device_if_records_a_conditional_body(dev):
    """``device_if`` in a captured frame: the body runs on the replays
    whose predicate holds, with its temporaries, and its launches are
    counted on the device."""
    from softbody_tpu_torch.ops import compiled

    def fn(x, flag):
        out = torch.zeros_like(x)

        def body():
            recmirror.K7_LAUNCHES += 1
            out.copy_(x * 2.0 + 1.0)

        compiled.device_if(flag, body)
        return out

    c = compiled.Compiled(fn)
    x = torch.arange(8.0, device=dev)
    compiled.sync_counts()
    k7 = recmirror.K7_LAUNCHES
    for on in (True, False, True, True):
        got = c(x, torch.tensor(on, device=dev))
        assert torch.equal(got, x * 2.0 + 1.0 if on else torch.zeros_like(x))
    compiled.sync_counts()
    assert recmirror.K7_LAUNCHES - k7 == 3
    assert c.stats()["captures"] == 1


def test_captured_carry_init_and_motion_match_eager(dev):
    """``far3_carry_init_jit`` and ``packed_far_motion2_jit`` captured
    against their functions on the card, twice each, bit for bit."""
    from softbody_tpu_torch.ops.farfield import rebuild_far_list_planes
    from softbody_tpu_torch.ops.stencil import LatticeSpec

    P = fused_substep2
    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    hot, _obs, immut, _ec = P.pack_lattice2(_hairpin(dev))
    fl = rebuild_far_list_planes(hot[0], hot[1], immut[0] > 0, s=2, ff=ff,
                                 radius=4.0)
    moved = hot.clone()
    moved[0:2] += 1.5
    for h in (hot, moved):
        assert _same_tensors(P.far3_carry_init_jit(h, immut, cfg, spec, ff),
                             P.far3_carry_init(h, immut, cfg, spec, ff))
        assert _same_tensors(P.packed_far_motion2_jit(h, immut, fl),
                             P.packed_far_motion2(h, immut, fl))
