"""The JAX kernel's variants (``kvar``) in the port: K1's plain version
under ``rollgroup`` and ``dexp2`` against the JAX kernel bit for bit, the
default ``FusedLatticeBackend`` against the JAX package's default within
its own variant tolerance, and the backend's variant flags, drop rules
and far-apply route against the JAX backend's.

The JAX kernel runs in interpret mode.  For the bit-exact cases it is
compiled without XLA's fusion and algebraic simplifier, so that its
float32 expressions round as written (a fused CPU program contracts
``a·b + c·d`` into multiply-adds); the port's strict K1 then equals it
bit for bit on these scenes.  ``rsqrt`` is held to a tolerance only: XLA's
CPU ``rsqrt`` is an approximation of its own (on the CPU, torch's equals
``1/sqrt``; on the card both run the card's ``rsqrtf``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.engine import backends as jbackends
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.pallas import fused_substep2 as J
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.engine import FusedLatticeBackend
from softbody_tpu_torch.ops import farfield4 as t4
from softbody_tpu_torch.ops.cuda import fused_substep2 as P
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_farfield import hairpin
from test_torch_frame import HAIRPIN_CFG, HAIRPIN_FF
from torch_parity import (
    consts_to_port,
    random_state,
    to_jax,
    to_port,
    uin_to_port,
)
from torch_threads import two_torch_threads  # noqa: F401

W, H = 16, 24
# tests/test_fused2.py:217, the JAX kernel's own tolerance for "rsqrt"
VARIANT_ATOL = {"pos": 5e-2, "vel": 2e-1}


def _scene(quantized: bool, stencil: int):
    """A jittered 16 × 24 lattice whose particles overlap their neighbours
    out to the stencil's reach (radius 6 or 8 at spacing 10), so that
    several reactions of one Δy meet in a sum; the mouse grabs, and the
    drag exponent is 2."""
    arrays = random_state(W, H, seed=31 + stencil)
    cfg = StaticConfig(subticks=4, collision_mode="allpairs",
                       particle_radius=6.0 if stencil == 1 else 8.0,
                       force_mode="quantized" if quantized else "segment")
    uin = UserInput(
        user_strength=jnp.float32(1.5), mouse_active=jnp.asarray(True),
        mouse_pos=jnp.asarray(arrays["pos"][5, 7], jnp.float32),
        mouse_vel=jnp.asarray([3.0, -1.0], jnp.float32),
        applied_force=jnp.asarray([0.25, 0.5], jnp.float32))
    return arrays, cfg, PhysicsConstants.default(), uin


def _jax_k1(arrays, cfg, consts, uin, stencil, kvar):
    """One substep of the JAX kernel (interpret mode, compiled as
    written), unpacked to numpy fields."""
    js = to_jax(arrays)
    hot, obs, immut, ec = J.pack_lattice2(js, tile_w=8)
    cvec = jnp.concatenate([J._consts_vector(consts, uin, cfg, H), ec])
    out = _jax_k1_compiled(stencil, cfg.force_mode == "quantized",
                           tuple(kvar))(hot, immut, cvec)
    return lattice_state_to_numpy(to_port(J.unpack_lattice2(out, obs, js)))


@functools.lru_cache(maxsize=None)
def _jax_k1_compiled(stencil, quantized, kvar):
    """The JAX kernel on this file's W × H (interpret mode, compiled as
    written), once per flag set: the constants are its operands."""
    wp, hp = J.padded_dims(W, H, 8)
    fn = jax.jit(functools.partial(
        J.fused_substep2_call, w=wp, h=hp, stencil=stencil,
        quantized=quantized, tile_w=8, interpret=True, kvar=kvar))
    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (J.N_HOT, wp + 2 * J.PAD_W, hp + J.PAD_H + J.lane_pad_hr(H, hp)),
        (J.N_IMM, wp + 2 * J.PAD_W, hp + J.PAD_H + J.lane_pad_hr(H, hp)),
        (40,))]
    return fn.lower(*shapes).compile(compiler_options={
        "xla_disable_hlo_passes": "fusion,algsimp"})


def _port_k1(arrays, cfg, consts, uin, stencil, **flags):
    state = to_port(to_jax(arrays))
    hot, obs, immut, ec = P.pack_lattice2(state)
    pcfg = tb.StaticConfig(bounds_size=cfg.bounds_size,
                           particle_radius=cfg.particle_radius,
                           subticks=cfg.subticks,
                           collision_mode=cfg.collision_mode,
                           force_mode=cfg.force_mode)
    cvec = torch.cat([tb.consts_vector(consts_to_port(consts),
                                       uin_to_port(uin), pcfg, H), ec])
    out = P.fused_substep2_call(hot, immut, cvec, stencil=stencil,
                                quantized=cfg.force_mode == "quantized",
                                **flags)
    return lattice_state_to_numpy(P.unpack_lattice2(out, obs, state))


def _bits_equal(got, ref):
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      ref[k].view(np.uint32), err_msg=k)
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        for k in ("target_length", "last_length", "alive"):
            np.testing.assert_array_equal(eg[k], er[k],
                                          err_msg=f"class {c} {k}")


@pytest.mark.parametrize("stencil,quantized", [(1, True), (3, False)],
                         ids=["s1-quantized", "s3-float"])
def test_k1_rollgroup_matches_jax(stencil, quantized):
    """``rollgroup``: the grouped order of the reactions.  The port's
    strict order gives other bits on the same scene (the collision sums,
    and with float springs the spring sums), so the scene tells the two
    orders apart."""
    scene = _scene(quantized, stencil)
    ref = _jax_k1(*scene, stencil, ("rollgroup",))
    got = _port_k1(*scene, stencil, rollgroup=True)
    _bits_equal(got, ref)
    strict = _port_k1(*scene, stencil)
    assert not np.array_equal(strict["vel"], got["vel"])


def test_k1_dexp2_matches_jax():
    """``dexp2`` (the drag's ``|v|**2`` as ``v·v``): the port's strict K1
    already evaluates ``|v|**2`` as ``|v|·|v|``, the same float."""
    scene = _scene(True, 1)
    _bits_equal(_port_k1(*scene, 1), _jax_k1(*scene, 1, ("dexp2",)))


@pytest.mark.parametrize("subticks", [4, 6, 48, 64])
def test_k1_strict_matches_jax_at_subticks(subticks):
    """The penetration clip multiplies by ``1/(dt·dt)`` as the JAX kernel
    does (``fused_substep2.py:394``): strict K1 equals JAX's bit for bit
    at every substep count, not only where ``dt²`` is a power of two.  At
    6 and 48 the stencil path's division by ``dt²`` gives other bits on
    the same scene, so the scene tells the two apart."""
    arrays, cfg, consts, uin = _scene(True, 1)
    cfg = StaticConfig(subticks=subticks, collision_mode="allpairs",
                       particle_radius=cfg.particle_radius,
                       force_mode="quantized")
    ref = _jax_k1(arrays, cfg, consts, uin, 1, ())
    _bits_equal(_port_k1(arrays, cfg, consts, uin, 1), ref)
    divided = _port_k1_dividing(arrays, cfg, consts, uin, 1)
    assert np.array_equal(divided["vel"], ref["vel"]) == (subticks
                                                          in (4, 64))


def _port_k1_dividing(arrays, cfg, consts, uin, stencil):
    """K1's plain version with the stencil path's clip (a division by
    ``dt²``): what the port ran before it multiplied."""
    from softbody_tpu_torch.ops import stencil as S

    orig = S._stencil_collisions

    def dividing(*args, **kw):
        kw["inv_dt2"] = False
        return orig(*args, **kw)

    S._stencil_collisions = dividing
    try:
        return _port_k1(arrays, cfg, consts, uin, stencil)
    finally:
        S._stencil_collisions = orig


@pytest.mark.parametrize("kvar", [("nospring",), ("noint",)],
                         ids=["nospring", "noint"])
def test_k1_knobs_match_jax(kvar):
    """The attribution knobs against the JAX kernel with the same
    ``kvar``, bit for bit: ``nospring`` (the edge planes pass through and
    the springs add nothing), ``noint`` (the particle planes pass
    through)."""
    scene = _scene(True, 1)
    ref = _jax_k1(*scene, 1, kvar)
    got = _port_k1(*scene, 1, nospring="nospring" in kvar,
                   noint="noint" in kvar)
    _bits_equal(got, ref)
    arrays = scene[0]
    if "noint" in kvar:
        np.testing.assert_array_equal(got["vel"], arrays["vel"])
    else:
        assert not np.array_equal(got["vel"], arrays["vel"])


def test_k1_rsqrt_within_variant_tolerance_of_strict():
    """The ``rsqrt`` instance's plain version moves no particle by more
    than the JAX kernel's variant tolerance from strict in one substep;
    the edge states agree."""
    scene = _scene(True, 3)
    strict = _port_k1(*scene, 3)
    got = _port_k1(*scene, 3, rsqrt=True, rollgroup=True)
    assert not np.array_equal(strict["pos"], got["pos"])
    for k in ("pos", "vel"):
        np.testing.assert_allclose(got[k], strict[k], rtol=0,
                                   atol=VARIANT_ATOL[k], err_msg=k)
    for eg, er in zip(got["edges"], strict["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def _hairpin_port_cfg():
    ls = hairpin()
    spec = LatticeSpec(*ls.shape, collision_stencil=2)
    return ls, spec, tb.StaticConfig(**HAIRPIN_CFG)


@functools.lru_cache(maxsize=None)
def _jax_default_hairpin():
    """Three frames of the folded strip through the JAX package's default
    ``FusedLatticeBackend`` (``max_pairs`` 64: its ``krec`` applies the
    terminal bucket through the record table), run once per process."""
    ls = hairpin()
    be = jbackends.FusedLatticeBackend(
        JLatticeSpec(*ls.shape, collision_stencil=2),
        StaticConfig(**HAIRPIN_CFG), farfield=JFarFieldSpec(**HAIRPIN_FF),
        tile_w=8)
    assert be.kvar == P.DEFAULT_KVAR
    st = be.pack_state(ls)
    for _ in range(3):
        st = be.step(st, PhysicsConstants.default(), UserInput.none())
    return lattice_state_to_numpy(to_port(be.unpack_state(st))), \
        be.far_stats()


def test_default_backend_matches_jax_default():
    """The same call ``FusedLatticeBackend(spec, cfg, farfield=ff)`` in
    both packages, far-armed for three frames: the same flags, far stats,
    edge liveness and route (every apply through the record table: K7 on
    the card), the state within the JAX kernel's variant tolerance."""
    ref, ref_stats = _jax_default_hairpin()
    ls, spec, cfg = _hairpin_port_cfg()
    be = FusedLatticeBackend(spec, cfg, farfield=FarFieldSpec(**HAIRPIN_FF),
                             device="cpu")
    assert be.kvar == P.DEFAULT_KVAR
    before = dict(t4.APPLY_ROUTES)
    state = be.pack_state(to_port(ls))
    for _ in range(3):
        state = be.step(state, tb.PhysicsConstants(), tb.UserInput())
    ran = {k: v - before[k] for k, v in t4.APPLY_ROUTES.items()}
    assert ran == {"narrow": 0, "mirror": 3 * cfg.subticks, "kernel": 0}
    assert be.far_stats() == ref_stats and ref_stats["far_pairs"] > 0
    got = lattice_state_to_numpy(be.unpack_state(state))
    assert np.isfinite(got["pos"]).all()
    for k in ("pos", "vel"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=VARIANT_ATOL[k], err_msg=k)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def test_layout_flags_change_nothing():
    """The default equals the three arithmetic flags alone bit for bit,
    and so does every layout flag added to them, on a 512-pair list (the
    default ladder applies it through the record table with or without
    ``krec``).  Without ``krec``, a 64-pair list goes the narrow way."""
    ls, spec, cfg = _hairpin_port_cfg()
    ff = FarFieldSpec(**dict(HAIRPIN_FF, max_pairs=512))
    arith = ("rollgroup", "rsqrt", "dexp2")
    outs = []
    for kvar in (P.DEFAULT_KVAR, arith, arith + P.LAYOUT_VARIANTS):
        be = FusedLatticeBackend(spec, cfg, farfield=ff, device="cpu",
                                 kernel_variants=kvar)
        state = be.pack_state(to_port(ls))
        for _ in range(2):
            state = be.step(state, tb.PhysicsConstants(), tb.UserInput())
        outs.append(state)
    for hot, obs in outs[1:]:
        assert torch.equal(hot, outs[0][0]) and torch.equal(obs, outs[0][1])
    be = FusedLatticeBackend(spec, cfg, farfield=FarFieldSpec(**HAIRPIN_FF),
                             device="cpu", kernel_variants=arith)
    before = dict(t4.APPLY_ROUTES)
    be.step(be.pack_state(to_port(ls)), tb.PhysicsConstants(),
            tb.UserInput())
    assert t4.APPLY_ROUTES["narrow"] - before["narrow"] == cfg.subticks


VARIANT_SETS = [None, (), ("krec",), ("rsqrt", "kmirror"),
                ("kmirror", "krec", "lanecut", "outfull", "inbuf3",
                 "ealpack", "rollgroup", "rsqrt", "dexp2")]


@pytest.mark.parametrize("buckets", [None, (256, 512), (1024, 2048), (64,),
                                     (512,)])
def test_backend_kvar_matches_jax(buckets):
    """``backend.kvar`` over a grid of flags and bucket ladders, and the
    flags a step runs with at drag exponents 2 and 1.7, against the JAX
    backend's (a ladder with a bucket ≤ 256 drops ``krec``; the terminal
    ``max_pairs`` bucket is not looked at)."""
    ls, spec, cfg = _hairpin_port_cfg()
    jspec = JLatticeSpec(*ls.shape, collision_stencil=2)
    jcfg = StaticConfig(**HAIRPIN_CFG)
    for kvar in VARIANT_SETS:
        kw = {} if kvar is None else {"kernel_variants": kvar}
        be = FusedLatticeBackend(spec, cfg, farfield=FarFieldSpec(
            **HAIRPIN_FF), far_buckets=buckets, device="cpu", **kw)
        jbe = jbackends.FusedLatticeBackend(
            jspec, jcfg, farfield=JFarFieldSpec(**HAIRPIN_FF), tile_w=8,
            far_buckets=buckets, **kw)
        assert be.kvar == jbe.kvar, kvar
        for e in (2.0, 1.7):
            jc = PhysicsConstants.default()
            jc.drag_exp = jnp.float32(e)
            assert be._checked_kvar(consts_to_port(jc)) == \
                jbe._checked_kvar(jc), (kvar, e)


@pytest.mark.parametrize("opts", [dict(far_mode="v3"),
                                  dict(far_detect="kernel")],
                         ids=["v3", "kernel-detect"])
def test_backend_kvar_drop_rules_match_jax(opts):
    """``backend.kvar`` under the other far modes against the JAX
    backend's: v3 drops the layout flags and the record carry, kernel
    detection the record carry."""
    _ls, spec, cfg = _hairpin_port_cfg()
    jspec = JLatticeSpec(spec.width, spec.height, collision_stencil=2)
    jcfg = StaticConfig(**HAIRPIN_CFG)
    for kvar in VARIANT_SETS:
        kw = {} if kvar is None else {"kernel_variants": kvar}
        be = FusedLatticeBackend(spec, cfg, farfield=FarFieldSpec(
            **HAIRPIN_FF), device="cpu", **opts, **kw)
        jbe = jbackends.FusedLatticeBackend(
            jspec, jcfg, farfield=JFarFieldSpec(**HAIRPIN_FF), tile_w=8,
            **opts, **kw)
        assert be.kvar == jbe.kvar, (kvar, opts)


@pytest.mark.parametrize("bad", [("nospring", "nospin"), ("noints",),
                                 ("rsqrt", "rolgroup")])
def test_backend_rejects_unported_variants(bad):
    """Names outside the JAX kernel's flags (typos of the attribution
    knobs and of a variant) raise, naming the flag."""
    _ls, spec, cfg = _hairpin_port_cfg()
    with pytest.raises(ValueError, match=bad[-1]):
        FusedLatticeBackend(spec, cfg, device="cpu", kernel_variants=bad)
    with pytest.raises(ValueError, match="dexp2"):
        P.fused_frame2(*_packed(spec), tb.PhysicsConstants(drag_exp=1.5),
                       tb.UserInput(), spec, cfg, kvar=("dexp2",))


def _packed(spec):
    from softbody_tpu_torch.models import make_lattice

    hot, obs, immut, ec = P.pack_lattice2(make_lattice(
        spec.width, spec.height, 10.0, device="cpu"))
    return hot, obs, immut, ec

