"""K1's trig and detect modes and the far-field frames built on them, in
the port: single K1 calls and single helpers against the JAX package,
whole frames against the port's own frames (as JAX's own tests hold its
v3 frame against its v2 frame: tests/test_fused3.py,
tests/test_fused4.py).

Against JAX: one interpret-mode K1 call with ``refs`` and ``detect`` on
the folded strip (compiled as written, without XLA's fusion and
algebraic simplifier), run once for the module: the side planes equal
JAX's interior bit for bit, the trig maxima too, the trig sums within
1e-5 relative (the port sums per block, then the blocks, in another
order); the strict output state bit for bit.  The rebuild helpers
(``chunk_any_alive``, ``raw_planes_from_side``,
``kernel_side_from_planes``, ``list_invalid``) exactly, on the strip and
on an 18 × 12 lattice whose width ends in a partial group of four rows.
``fused_frame2_far`` against JAX's at one substep within 5e-3 / 5e-2
(tests/test_fused_spatial2.py:140-160's use).

Port-internal, mirroring JAX's frame tests: v3 against v2-auto (two
frames of the strip, 5e-3 / 5e-2), v3 on a free-falling flat cloth (no
far pairs, at most 3 rebuilds), kernel detection against xla detection
(three frames of the 32 × 32 tearing cloth: equal rebuilds, no overflow,
positions within 1e-4).  Candidate lists may differ where a pair sits at
the band's reach to the ulp (the band's mean velocity comes from sums in
another order), so trajectories are compared, not pair ids."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.ops import farfield as JF
from softbody_tpu.ops.pallas import fused_substep2 as J
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.engine import FusedLatticeBackend
from softbody_tpu_torch.models import make_lattice, tearing_cloth_lattice
from softbody_tpu_torch.ops import farfield as F
from softbody_tpu_torch.ops.cuda import fused_substep2 as P
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_farfield import hairpin
from test_torch_frame import HAIRPIN_CFG, HAIRPIN_FF
from torch_parity import consts_to_port, random_state, to_port
from torch_threads import two_torch_threads  # noqa: F401

RADIUS = HAIRPIN_CFG["particle_radius"]
JCFG = StaticConfig(**HAIRPIN_CFG)
CFG = tb.StaticConfig(**HAIRPIN_CFG)
JFF = JF.FarFieldSpec(**HAIRPIN_FF)
FF = F.FarFieldSpec(**HAIRPIN_FF)


def _extras(vbar, *, det=1.0):
    """The far-field scalars of one K1 call (tau = dt, as JAX's test)."""
    dt = JCFG.dt
    return np.asarray([dt, det, vbar[0], vbar[1], (FF.horizon + 1) * dt,
                       2 * RADIUS + FF.skin, FF.speed_safety * dt, 0.0],
                      np.float32)


def _vbar(arrays):
    alive = arrays["alive"]
    n = np.float32(max(alive.sum(), 1))
    return [np.float32(arrays["vel"][..., k][alive].sum(dtype=np.float32)
                       / n) for k in (0, 1)]


@pytest.fixture(scope="module")
def k1_far():
    """One K1 substep with trig and detect on the folded strip, JAX
    (interpret mode, tile 8) and the port's plain version, on the same
    inputs: refs = the input state, tau = dt."""
    ls = hairpin()
    arrays = lattice_state_to_numpy(to_port(ls))
    w, h = ls.shape
    consts, uin = PhysicsConstants.default(), UserInput.none()
    extras = _extras(_vbar(arrays))

    hot, obs, immut, ec = J.pack_lattice2(ls, tile_w=8)
    wr, hr = J.padded_dims(w, h, 8)
    cvec = jnp.concatenate([J._consts_vector(consts, uin, JCFG, h), ec,
                            jnp.asarray(extras)])
    refs = jnp.stack([hot[J.PX], hot[J.PY], hot[J.VX], hot[J.VY]])
    fn = jax.jit(functools.partial(
        J.fused_substep2_call, w=wr, h=hr, stencil=2, quantized=True,
        tile_w=8, interpret=True, detect=True))
    m2, stats, side = fn.lower(hot, immut, cvec, refs=refs).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion,algsimp"})(
        hot, immut, cvec, refs=refs)
    jstate = lattice_state_to_numpy(to_port(J.unpack_lattice2(m2, obs, ls)))
    jstats = np.asarray(stats)

    state = to_port(ls)
    thot, _tobs, timmut, tec = P.pack_lattice2(state)
    tcvec = torch.cat([tb.consts_vector(consts_to_port(consts),
                                        tb.UserInput(), CFG, h), tec,
                       torch.from_numpy(extras)])
    out, tstats, tside = P.fused_substep2_call(
        thot, timmut, tcvec, stencil=2, quantized=True,
        refs=thot[:4].clone(), detect=True)
    return dict(
        jax_state=jstate, jax_side=np.asarray(side)[:, :w // 4, :h],
        jax_max=jstats[:, :2].max(0), jax_sum=jstats[:, 2:4].sum(0),
        state=lattice_state_to_numpy(P.unpack_lattice2(out, _tobs, state)),
        side=tside.numpy(), stats=tstats.numpy())


def test_k1_detect_side_matches_jax(k1_far):
    """The side planes: min/max exact, band flags equal, some set."""
    np.testing.assert_array_equal(k1_far["side"], k1_far["jax_side"])
    assert 0 < k1_far["side"][P.S_BAND].sum() < k1_far["side"][0].size


def test_k1_trig_maxima_match_jax(k1_far):
    np.testing.assert_array_equal(k1_far["stats"][:2], k1_far["jax_max"])
    assert k1_far["stats"][0] > 0


def test_k1_trig_sums_match_jax(k1_far):
    np.testing.assert_allclose(k1_far["stats"][2:], k1_far["jax_sum"],
                               rtol=1e-5, atol=0)


def test_k1_trig_detect_state_matches_jax(k1_far):
    got, ref = k1_far["state"], k1_far["jax_state"]
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      ref[k].view(np.uint32), err_msg=k)
    for eg, er in zip(got["edges"], ref["edges"]):
        for k in ("target_length", "last_length", "alive"):
            np.testing.assert_array_equal(eg[k], er[k], err_msg=k)


# ---- the rebuild helpers ----------------------------------------------------

def _hairpin_planes():
    return lattice_state_to_numpy(to_port(hairpin()))


def _odd_planes():
    """18 × 12: the width ends in a partial group of four rows."""
    return random_state(18, 12, seed=5)


HELPER_SCENES = {"hairpin": _hairpin_planes, "odd": _odd_planes}


def _planes(arrays):
    """(px, py, vx, vy, alive) as numpy."""
    return (arrays["pos"][..., 0], arrays["pos"][..., 1],
            arrays["vel"][..., 0], arrays["vel"][..., 1], arrays["alive"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _side_kw(arrays):
    vbar = _vbar(arrays)
    return dict(s=2, radius=RADIUS, T_band=(FF.horizon + 1) * JCFG.dt,
                vbar=(float(vbar[0]), float(vbar[1])))


@pytest.mark.parametrize("scene", HELPER_SCENES)
def test_chunk_any_alive_matches_jax(scene):
    alive = HELPER_SCENES[scene]()["alive"]
    ref = np.asarray(JF.chunk_any_alive(jnp.asarray(alive), JFF))
    np.testing.assert_array_equal(F.chunk_any_alive(_t(alive), FF).numpy(),
                                  ref)


@pytest.mark.parametrize("scene", HELPER_SCENES)
def test_kernel_side_from_planes_matches_jax(scene):
    """Through ``raw_planes_from_side``: JAX's ``raw_chunk_planes`` (its
    band pass the XLA loop) on every chunk, bit for bit; on the strip
    (whole chunks) also JAX's ``kernel_side_from_planes`` itself."""
    arrays = HELPER_SCENES[scene]()
    px, py, vx, vy, alive = _planes(arrays)
    w, h = alive.shape
    kw = _side_kw(arrays)
    side = F.kernel_side_from_planes(*map(_t, (px, py, alive, vx, vy)),
                                     ff=FF, **kw)
    raw = F.raw_planes_from_side(side, w, h, (0, 0), FF)
    jraw, _cany, _com = JF.raw_chunk_planes(
        *map(jnp.asarray, (px, py, alive)), ff=JFF, vxu=jnp.asarray(vx),
        vyu=jnp.asarray(vy), **kw)
    for name in raw._fields:
        np.testing.assert_array_equal(getattr(raw, name).numpy(),
                                      np.asarray(getattr(jraw, name)),
                                      err_msg=name)
    if w % 4 == 0 and h % 4 == 0:
        jside = JF.kernel_side_from_planes(
            *map(jnp.asarray, (px, py, alive, vx, vy)), ff=JFF,
            interior_off=(0, 0), interior_shape=(w, h), **kw)
        np.testing.assert_array_equal(side.numpy(), np.asarray(jside))


@pytest.mark.parametrize("scene", HELPER_SCENES)
def test_raw_planes_from_side_matches_jax(scene):
    """The same side planes (K1's on the scene, a few groups garbled with
    the ±3e38 fills) through both packages' finishing reduce."""
    arrays = HELPER_SCENES[scene]()
    px, py, vx, vy, alive = _planes(arrays)
    w, h = alive.shape
    side = P.detect_side_plain(*map(_t, (px, py, vx, vy, alive)),
                               _extras(_vbar(arrays)).tolist(), stencil=2)
    side[0, 1, :2] = P.SIDE_BIG
    side[1, 1, :2] = -P.SIDE_BIG
    raw = F.raw_planes_from_side(side, w, h, (0, 0), FF)
    jraw = JF.raw_planes_from_side(jnp.asarray(side.numpy()), w, h, (0, 0),
                                   JFF)
    for name in raw._fields:
        np.testing.assert_array_equal(getattr(raw, name).numpy(),
                                      np.asarray(getattr(jraw, name)),
                                      err_msg=name)


@pytest.mark.parametrize("scene", HELPER_SCENES)
def test_k1_side_reduces_to_raw_chunk_planes(scene):
    """K1's side planes of a state, finished by ``raw_planes_from_side``,
    are the rebuild's own detection of that state (``raw_chunk_planes``)
    on every chunk: the side planes can seed a rebuild."""
    arrays = HELPER_SCENES[scene]()
    px, py, vx, vy, alive = map(_t, _planes(arrays))
    w, h = alive.shape
    extras = _extras(_vbar(arrays))
    side = P.detect_side_plain(px, py, vx, vy, alive, extras.tolist(),
                               stencil=2)
    raw = F.raw_planes_from_side(side, w, h, (0, 0), FF)
    ref, _cany, _com = F.raw_chunk_planes(
        px, py, alive, s=2, ff=FF, radius=RADIUS, vxu=vx, vyu=vy,
        T_band=float(extras[P.X_TBAND]),
        vbar=(float(extras[P.X_VBX]), float(extras[P.X_VBY])))
    for name in raw._fields:
        assert torch.equal(getattr(raw, name), getattr(ref, name)), name
    assert bool(raw.band.any())


@pytest.mark.parametrize("scene", HELPER_SCENES)
def test_list_invalid_matches_jax(scene):
    """The deviation trigger on moved states at several list ages: the
    same decisions, both outcomes met."""
    arrays = HELPER_SCENES[scene]()
    px, py, vx, vy, alive = _planes(arrays)
    w, h = alive.shape
    # lists referenced to the scene's state (the trigger reads only that)
    jfl = dataclasses.replace(
        JF.empty_far_list(w, h, JFF), px_ref=jnp.asarray(px),
        py_ref=jnp.asarray(py), vx_ref=jnp.asarray(vx),
        vy_ref=jnp.asarray(vy))
    tfl = dataclasses.replace(
        F.empty_far_list(w, h, FF, device="cpu"), px_ref=_t(px),
        py_ref=_t(py), vx_ref=_t(vx), vy_ref=_t(vy))
    rng = np.random.default_rng(7)
    seen = set()
    for scale in (0.05, 0.3, 1.0):
        for age in (0, 3, FF.horizon - 1, FF.horizon):
            mx = (px + rng.normal(0, scale * FF.skin, px.shape)).astype(
                np.float32)
            mvx = (vx + rng.normal(0, scale * 8.0, vx.shape)).astype(
                np.float32)
            ref = bool(JF.list_invalid(
                jnp.asarray(mx), jnp.asarray(py), jnp.asarray(mvx),
                jnp.asarray(vy), jnp.asarray(alive),
                dataclasses.replace(jfl, age=jnp.int32(age)), JCFG.dt, JFF))
            got = F.list_invalid(_t(mx), _t(py), _t(mvx), _t(vy), _t(alive),
                                 dataclasses.replace(tfl, age=age), CFG.dt,
                                 FF)
            assert bool(got) == ref, (scale, age)
            seen.add(ref)
    assert seen == {True, False}


# ---- the frames -------------------------------------------------------------

def test_frame2_far_matches_jax():
    """One substep of ``fused_frame2_far`` with the list of the folded
    strip's state, against JAX's (interpret mode)."""
    ls = hairpin()
    w, h = ls.shape
    consts, uin = PhysicsConstants.default(), UserInput.none()
    jspec = JLatticeSpec(w, h, collision_stencil=2)
    hot, obs, immut, ec = J.pack_lattice2(ls, tile_w=8)
    jfl = J.rebuild_far_list_packed2(hot, immut, s=2, ff=JFF, radius=RADIUS)
    hot, obs = J.fused_frame2_far(hot, obs, immut, ec, jfl, consts, uin,
                                  jspec, JCFG, JFF, tile_w=8, interpret=True,
                                  n_sub=1)
    ref = lattice_state_to_numpy(to_port(J.unpack_lattice2(hot, obs, ls)))

    state = to_port(ls)
    thot, tobs, timmut, tec = P.pack_lattice2(state)
    tfl = P.rebuild_far_list_packed2(thot, timmut, s=2, ff=FF, radius=RADIUS)
    assert tfl.counts()[0] == int(jfl.n_pairs) > 0
    thot, tobs = P.fused_frame2_far(
        thot, tobs, timmut, tec, tfl, consts_to_port(consts), tb.UserInput(),
        LatticeSpec(w, h, collision_stencil=2), CFG, FF, n_sub=1)
    got = lattice_state_to_numpy(P.unpack_lattice2(thot, tobs, state))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)


def test_packed_far_motion2_matches_jax():
    """The displacement since a rebuild and the relative speed, from the
    packed stacks, after the strip moves: JAX's values (the alive means
    are sums in another order: 1e-5 relative)."""
    ls = hairpin()
    w, h = ls.shape
    hot, _obs, immut, _ec = J.pack_lattice2(ls, tile_w=8)
    thot, _tobs, timmut, _tec = P.pack_lattice2(to_port(ls))
    # lists referenced to the strip's state (what the check reads)
    com = np.asarray(ls.pos).reshape(-1, 2).mean(0).astype(np.float32)
    jfl = dataclasses.replace(
        JF.empty_far_list(*hot.shape[1:], JFF), px_ref=hot[J.PX],
        py_ref=hot[J.PY], com_ref=jnp.asarray(com))
    tfl = dataclasses.replace(
        F.empty_far_list(w, h, FF, device="cpu"), px_ref=thot[P.PX].clone(),
        py_ref=thot[P.PY].clone(), com_ref=torch.from_numpy(com))
    rng = np.random.default_rng(3)
    move = rng.normal(0.0, 2.0, (4, w, h)).astype(np.float32)
    hot = hot.at[:4, J.PAD_W:J.PAD_W + w, J.PAD_H:J.PAD_H + h].add(
        jnp.asarray(move))
    thot = thot.clone()
    thot[:4] += torch.from_numpy(move)
    ref = [float(x) for x in J.packed_far_motion2(hot, immut, jfl)]
    got = [float(x) for x in P.packed_far_motion2(thot, timmut, tfl)]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert min(got) > 0


def _packed(ls):
    hot, obs, immut, ec = P.pack_lattice2(ls)
    return hot, obs, immut, ec


def _run_auto(ls, spec, cfg, ff, frames, mode, n_sub=None):
    hot, obs, immut, ec = _packed(ls)
    fl = F.empty_far_list(*ls.shape, ff, device="cpu")
    consts, uin = tb.PhysicsConstants(), tb.UserInput()
    st = []
    if mode == "v3":
        side, trig = P.far3_carry_init(hot, immut, cfg, spec, ff)
    for _ in range(frames):
        if mode == "v2":
            hot, obs, fl, s = P.fused_frame2_auto(
                hot, obs, immut, ec, fl, consts, uin, spec, cfg, ff,
                n_sub=n_sub)
        else:
            hot, obs, fl, side, trig, s = P.fused_frame3_auto(
                hot, obs, immut, ec, fl, side, trig, consts, uin, spec, cfg,
                ff, n_sub=n_sub)
        st.append(s.tolist())
    return lattice_state_to_numpy(P.unpack_lattice2(hot, obs, ls)), st


def test_v3_frame_matches_v2_auto():
    """Two frames of the folded strip: the triggered frame (K1's trigger
    statistics and side planes) reproduces the v2 auto frame's physics:
    both lists cover every pair that touches (mirrors
    tests/test_fused3.py:95)."""
    ls = to_port(hairpin())
    spec = LatticeSpec(*ls.shape, collision_stencil=2)
    v2, _ = _run_auto(ls, spec, CFG, FF, 2, "v2")
    v3, st = _run_auto(ls, spec, CFG, FF, 2, "v3")
    assert np.isfinite(v3["pos"]).all()
    assert max(s[1] for s in st) > 0, "v3 found no far pairs on the fold"
    np.testing.assert_allclose(v3["pos"], v2["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(v3["vel"], v2["vel"], rtol=0, atol=5e-2)


def test_v3_flat_lattice_no_rebuild_storm():
    """A free-falling flat cloth at subticks 64, 8 substeps: the first
    substep anchors the list, the swept detection keeps it valid: no far
    pairs, at most the anchor plus a horizon rebuild (mirrors
    tests/test_fused3.py:138)."""
    ls = make_lattice(32, 16, 10.0, device="cpu")
    ls = dataclasses.replace(ls, vel=torch.full_like(ls.vel, -2.0))
    spec = LatticeSpec(32, 16, collision_stencil=2)
    cfg = dataclasses.replace(CFG, subticks=64)
    ff = dataclasses.replace(FF, skin=3.0, horizon=8)
    _out, st = _run_auto(ls, spec, cfg, ff, 1, "v3", n_sub=8)
    assert st[0][1] == 0, f"flat cloth produced far pairs: {st}"
    assert 1 <= st[0][0] <= 3, f"rebuild storm on flat cloth: {st}"


def test_kernel_detect_matches_xla_detect():
    """Three frames of the 32 × 32 tearing cloth through the backend with
    each detection: the same rebuilds, no overflow, positions within 1e-4
    (mirrors tests/test_fused4.py:380)."""
    ls, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=32 * 32, spring=2.0, damp=0.2, fall_speed=10.0,
        slits=2, strain_limit=0.22, yield_strain=0.18, device="cpu")
    spacing = 980.0 / (ls.shape[0] - 1)
    ff = F.FarFieldSpec(max_pairs=512, max_tile_pairs=128,
                        skin=0.75 * spacing, horizon=8)
    outs, stats = [], []
    for mode in ("xla", "kernel"):
        be = FusedLatticeBackend(spec, cfg, farfield=ff, far_detect=mode,
                                 device="cpu")
        state = be.pack_state(ls)
        for _ in range(3):
            state = be.step(state, consts, tb.UserInput())
        stats.append(be.far_stats())
        outs.append(be.unpack_state(state).pos.numpy())
    assert stats[1]["far_rebuilds"] == stats[0]["far_rebuilds"], stats
    assert stats[1]["far_overflow"] == 0, stats
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-4)


def test_backend_v3_carries_far_state():
    """``far_mode="v3"`` through the backend's entry points: two frames
    equal two direct ``fused_frame3_auto`` frames bit for bit, the list,
    side planes and trigger vector ride across frames and ``pack_state``
    drops them; three stats keys."""
    ls = to_port(hairpin())
    spec = LatticeSpec(*ls.shape, collision_stencil=2)
    be = FusedLatticeBackend(spec, CFG, farfield=FF, far_mode="v3",
                             device="cpu")
    state = be.pack_state(ls)
    for _ in range(2):
        state = be.step(state, tb.PhysicsConstants(), tb.UserInput())
    ref, st = _run_auto(ls, spec, CFG, FF, 2, "v3")
    got = lattice_state_to_numpy(be.unpack_state(state))
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert be._far_side is not None and be._far_trig is not None
    stats = be.far_stats()
    assert stats == {"far_rebuilds": st[0][0] + st[1][0],
                     "far_pairs": max(s[1] for s in st),
                     "far_overflow": max(s[2] for s in st)}
    be.pack_state(ls)
    assert be._far_list is None and be._far_side is None \
        and be._far_trig is None


def test_frame2_observe_false_passes_obs_through():
    """``observe=False`` runs every substep unobserved: the obs planes
    come back untouched, the state equals the observed frame's."""
    ls = to_port(hairpin())
    spec = LatticeSpec(*ls.shape, collision_stencil=2)
    hot, obs, immut, ec = _packed(ls)
    args = (immut, ec, tb.PhysicsConstants(), tb.UserInput(), spec, CFG)
    h1, o1 = P.fused_frame2(hot, obs, *args, kvar=())
    h2, o2 = P.fused_frame2(hot, obs, *args, observe=False, kvar=())
    assert torch.equal(h1, h2) and o2 is obs and not torch.equal(o1, obs)
