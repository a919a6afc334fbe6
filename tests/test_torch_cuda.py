"""The hand-written CUDA kernels against their plain torch versions, on
the card (marker ``cuda``; skipped where there is no CUDA device).  Run
there with ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (``conftest.py`` imports JAX, which that machine lacks);
``chip_smoke.py`` makes the same checks at the main path's full size."""

import dataclasses
import time

import pytest
import torch

import softbody_tpu_torch as tb
from softbody_tpu_torch.models import make_lattice, tearing_cloth_lattice
from softbody_tpu_torch.ops.cuda import (
    band_detect,
    collide_stencil,
    fused_substep,
    fused_substep2,
    recmirror,
)
from softbody_tpu_torch.ops.farfield import FarFieldSpec

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


def _same_bits(got, ref) -> bool:
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
    assert bool(torch.isnan(ref[:6]).any()) and _same_bits(got, ref)
    mut, immut4 = fused_substep.pack_lattice(state)
    cvec4 = cvec[:20].clone()
    got = fused_substep.fused_substep_call(mut, immut4, cvec4, **kw)
    ref = fused_substep.fused_substep_plain(mut, immut4, cvec4, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[:6]).any()) and _same_bits(got, ref)


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


def test_fused_frame4_activation_matches_plain(dev):
    """``fused_frame4(activation=True)`` on the hairpin through K1, K2
    and K7 (a 512-pair list: bucket 512, the mirror route) against the
    same two frames on the CPU (the plain versions): the same stats, the
    state within the far apply's tolerances (tests/test_torch_frame.py;
    a stirred cloth is too chaotic for any tolerance over a frame: a
    1e-6 change of its velocities moves positions by 0.1 in 8
    substeps)."""
    from softbody_tpu_torch.ops.stencil import LatticeSpec

    spec = LatticeSpec(96, 4)
    cfg = tb.StaticConfig(subticks=8, particle_radius=4.0)
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0, horizon=8)
    out = {}
    for d in ("cpu", dev):
        hot, obs, immut, ec = fused_substep2.pack_lattice2(_hairpin(d))
        before = recmirror.K7_LAUNCHES
        for _ in range(2):
            hot, obs, st = fused_substep2.fused_frame4(
                hot, obs, immut, ec, tb.PhysicsConstants(), tb.UserInput(),
                spec, cfg, ff, activation=True)
        out[str(d)] = (hot.cpu(), st.tolist(), recmirror.K7_LAUNCHES - before)
    (ref, st_c, k7_c), (got, st_g, k7_g) = out["cpu"], out[str(dev)]
    assert st_g == st_c and st_c[1] > 0 and st_c[3] <= st_c[1]
    assert k7_c == 0 and k7_g == 2 * cfg.subticks
    torch.testing.assert_close(got[0:2], ref[0:2], rtol=0, atol=5e-3)
    torch.testing.assert_close(got[2:4], ref[2:4], rtol=0, atol=5e-2)


def test_stirred_cloth_activation_matches_cpu(dev):
    """The stirred 40 × 40 cloth (one state, copied to both devices): the
    activation schedule of its first rebuild is bit-exact card vs CPU
    (K2 on the card); then one frame of ``fused_frame4`` with the
    schedule off and on, twice on the card, without torch's deterministic
    algorithms: the far apply's scatters sum in list order on every
    device (``stencil.index_sum``), so the two card runs are bit-identical
    and equal the CPU's frame bit for bit, far stats included.

    This scene magnifies one rounding difference to tens of units in a
    frame (on the CPU the schedule alone, which changes only the order
    of the far sums, parts the frame by that much: printed)."""
    from softbody_tpu_torch.convert import (
        lattice_state_from_numpy,
        lattice_state_to_numpy,
    )
    from softbody_tpu_torch.ops.farfield import rebuild_far_list_planes_active

    assert not torch.are_deterministic_algorithms_enabled()
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
