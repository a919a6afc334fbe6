"""The slice as a whole: the port's ``FusedLatticeBackend`` (K1 + far
field with K2, plain versions on the CPU) against the JAX package's
``fused_frame4`` (strict kernel, interpret mode).

Tolerances are those of tests/test_fused4.py:136-139 (pos atol 5e-3,
vel atol 5e-2): the two apply the far pairs with different f32 sum
orders.  Far stats and the alive-beam count must be equal."""

import functools

import numpy as np
import pytest

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.models import tearing_cloth_lattice as j_tearing
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.pallas.fused_substep2 import (
    fused_frame4,
    pack_lattice2,
    unpack_lattice2,
)
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.engine import FusedLatticeBackend
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    fused_frame4 as tb_fused_frame4,
)
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_farfield import hairpin
from torch_parity import consts_to_port, to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

HAIRPIN_FF = dict(max_pairs=64, max_tile_pairs=32, skin=4.0, horizon=8)
HAIRPIN_CFG = dict(subticks=8, collision_mode="allpairs", particle_radius=4.0,
                   force_mode="quantized")


def _hairpin_scene():
    ls = hairpin()
    return ls, JLatticeSpec(*ls.shape, collision_stencil=2), \
        StaticConfig(**HAIRPIN_CFG), PhysicsConstants.default(), HAIRPIN_FF


def _slit_cloth_scene():
    ls, spec, cfg, consts = j_tearing(
        n_particles=32 * 32, fall_speed=2.5, slits=2, strain_limit=0.22,
        yield_strain=0.18)
    spacing = 980.0 / (ls.shape[0] - 1)
    ff = dict(max_pairs=256, max_tile_pairs=64, skin=0.75 * spacing,
              horizon=8)
    return ls, spec, cfg, consts, ff


def _jax_run(ls, spec, cfg, consts, ffkw, frames, n_sub=None,
             activation=False):
    uin = UserInput.none()
    hot, obs, immut, ec = pack_lattice2(ls, tile_w=8)
    acc = None
    for _ in range(frames):
        hot, obs, st = fused_frame4(
            hot, obs, immut, ec, consts, uin, spec, cfg,
            JFarFieldSpec(**ffkw), tile_w=8, interpret=True, buckets=(16,),
            kvar=(), n_sub=n_sub, activation=activation)
        st = [int(x) for x in np.asarray(st)]
        acc = st if acc is None else [acc[0] + st[0]] + [
            max(a, b) for a, b in zip(acc[1:], st[1:])]
    stats = dict(zip(("far_rebuilds", "far_pairs", "far_overflow",
                      "far_active"), acc))
    return lattice_state_to_numpy(unpack_lattice2(hot, obs, ls)), stats


@functools.lru_cache(maxsize=None)
def hairpin_reference():
    """Two JAX frames of the folded strip (``HAIRPIN_FF``, bucket 16),
    run once per process: the reference of the hairpin cases here and in
    tests/test_torch_recmirror.py (compiling the JAX frame in interpret
    mode is most of such a case's time).  Its list holds every pair of
    the fold, so a larger capacity or another bucket ladder computes the
    same frames, their far-apply sums in another f32 order."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    return _jax_run(ls, spec, cfg, consts, ffkw, frames=2)


def _port_backend(spec, cfg, ffkw, **kw):
    """The port's backend over the JAX scene's spec and config, strict
    (``kernel_variants=()``) unless ``kw`` names variants."""
    kw.setdefault("kernel_variants", ())
    return FusedLatticeBackend(
        LatticeSpec(spec.width, spec.height,
                    collision_stencil=spec.collision_stencil),
        tb.StaticConfig(bounds_size=cfg.bounds_size,
                        particle_radius=cfg.particle_radius,
                        subticks=cfg.subticks,
                        collision_mode=cfg.collision_mode,
                        force_mode=cfg.force_mode),
        farfield=FarFieldSpec(**ffkw), device="cpu", **kw)


def test_backend_matches_jax_fused_frame4():
    """Two frames of the folded strip through the backend's entry points
    (pack_state → step → unpack_state / far_stats / counts)."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    ref, ref_stats = hairpin_reference()

    be = _port_backend(spec, cfg, ffkw, far_buckets=(16,))
    state = be.pack_state(to_port(ls))
    for _ in range(2):
        state = be.step(state, consts_to_port(consts),
                        uin_to_port(UserInput.none()))
    got = lattice_state_to_numpy(be.unpack_state(state))

    assert be.far_stats() == ref_stats
    assert ref_stats["far_pairs"] > 0, "the fold must yield far pairs"
    _assert_close(got, ref)
    n_beams_ref = sum(int(e["alive"].sum()) for e in ref["edges"])
    assert be.counts(state) == (int(ref["alive"].sum()), n_beams_ref)
    # the stats accumulator resets on read
    assert be.far_stats() == {"far_rebuilds": 0, "far_pairs": 0,
                              "far_overflow": 0}


def test_backend_far_activation_matches_jax():
    """``far_activation=True``: two frames of the folded strip against
    JAX's strict ``fused_frame4(activation=True)`` (the backend with
    ``kernel_variants=()``): the same far stats, ``far_active`` included,
    and the state within ``_assert_close``."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    be = _port_backend(spec, cfg, ffkw, far_buckets=(16,),
                       far_activation=True)
    state = be.pack_state(to_port(ls))
    ref, ref_stats = _jax_run(ls, spec, cfg, consts, ffkw, frames=2,
                              activation=True)
    for _ in range(2):
        state = be.step(state, consts_to_port(consts),
                        uin_to_port(UserInput.none()))
    assert be.far_stats() == ref_stats
    assert 0 < ref_stats["far_active"] <= ref_stats["far_pairs"]
    _assert_close(lattice_state_to_numpy(be.unpack_state(state)), ref)


def test_slit_cloth_frame_matches_jax():
    """The bench scene's shape at 32×32: one frame of 16 substeps (two
    cadence blocks) of the port's fused_frame4 against JAX's."""
    ls, spec, cfg, consts, ffkw = _slit_cloth_scene()
    ref, ref_stats = _jax_run(ls, spec, cfg, consts, ffkw, frames=1,
                              n_sub=16)
    be = _port_backend(spec, cfg, ffkw)
    hot, obs = be.pack_state(to_port(ls))
    hot, obs, st = tb_fused_frame4(
        hot, obs, be._immut, be._edge_consts, consts_to_port(consts),
        uin_to_port(UserInput.none()), be.spec, be.cfg, be.ff, n_sub=16,
        buckets=(16,))
    got = lattice_state_to_numpy(be.unpack_state((hot, obs)))
    assert dict(zip(ref_stats, st.tolist())) == ref_stats
    assert ref_stats["far_rebuilds"] == 2
    _assert_close(got, ref)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def _assert_close(got, ref):
    assert np.isfinite(got["pos"]).all()
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)


@pytest.mark.parametrize("bad", [
    dict(far_band="kernal"),
    dict(far_band="kernel"),          # the CPU's band pass is "plain"
    dict(far_mb=48),                  # lane blocks are multiples of 32
    dict(far_mb_out=16),
    dict(far_mode="v5"),
    dict(far_detect="kernal"),
])
def test_backend_rejects_unported_options(bad):
    _ls, spec, cfg, _c, ffkw = _hairpin_scene()
    with pytest.raises(ValueError):
        _port_backend(spec, cfg, ffkw, **bad)
    assert _port_backend(spec, cfg, ffkw, far_band="plain").far_band == \
        "plain"


@pytest.mark.parametrize("opts", [
    dict(far_band="xla"),
    dict(kernel_variants=("nospring",)),
    dict(far_mode="v3"),
    dict(far_detect="kernel"),
], ids=["far_band-xla", "nospring", "v3", "kernel-detect"])
def test_backend_takes_jax_options(opts):
    """The JAX backend's options that earlier slices refused: each builds
    the backend and steps the folded strip through a frame with finite
    positions and far pairs found (``nospring``: the attribution knob,
    the strip's springs then pass their state through)."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    be = _port_backend(spec, cfg, ffkw, **opts)
    state = be.pack_state(to_port(ls))
    state = be.step(state, consts_to_port(consts),
                    uin_to_port(UserInput.none()))
    got = lattice_state_to_numpy(be.unpack_state(state))
    assert np.isfinite(got["pos"]).all()
    st = be.far_stats()
    assert st["far_pairs"] > 0 and st["far_overflow"] == 0, st
    assert ("far_active" in st) == (opts.get("far_mode") != "v3")


def test_backend_takes_bench_keywords():
    """bench.py's construction of the backend (bench.py:143-150), the
    port's class in the JAX one's place, with the same keywords (far_band
    "xla": bench.py's BENCH_FAR_BAND choice that runs on the CPU)."""
    _ls, spec, cfg, _c, ffkw = _hairpin_scene()
    kvar = ("rollgroup", "rsqrt", "dexp2", "lanecut", "krec", "ealpack")
    be = FusedLatticeBackend(
        LatticeSpec(spec.width, spec.height,
                    collision_stencil=spec.collision_stencil),
        tb.StaticConfig(particle_radius=cfg.particle_radius,
                        subticks=cfg.subticks,
                        collision_mode=cfg.collision_mode,
                        force_mode=cfg.force_mode),
        farfield=FarFieldSpec(**ffkw), tile_w=64, far_mode="v4",
        far_buckets=None, far_activation=False, far_mb=32,
        far_detect="xla", far_band="xla", kernel_variants=kvar,
        device="cpu")
    assert be.tile_w == 64 and be.far_band == "xla" and be.kvar == kvar
    assert be._band_impl == "plain"


def test_fused_paths_reject_other_edge_offsets():
    """K1 and K4 evaluate the four reference edge classes only: a spec
    with other offsets (a planified plane's) is refused, not stepped."""
    from softbody_tpu_torch.models import make_lattice
    from softbody_tpu_torch.ops.cuda.fused_substep import (
        fused_frame,
        pack_lattice,
    )

    spec = LatticeSpec(8, 8, edge_offsets=((0, 1), (0, 2), (1, 0), (1, 1)))
    cfg = tb.StaticConfig(subticks=2)
    with pytest.raises(ValueError, match="edge offsets"):
        FusedLatticeBackend(spec, cfg, device="cpu")
    mut, immut = pack_lattice(make_lattice(8, 8, 10.0, device="cpu"))
    with pytest.raises(ValueError, match="edge offsets"):
        fused_frame(mut, immut, tb.PhysicsConstants(), tb.UserInput(), spec,
                    cfg)


def test_backend_without_far_field_matches_lattice_frame():
    """No far field: the backend's frame (K1 plain version, observing
    only the last substep) against the stencil path's ``lattice_frame``
    (observing every substep) — the same float32 ops, so bit-identical
    particle and edge planes; strain/stress agree on edges alive at the
    end (a mid-frame break keeps its older value in the fused frame)."""
    from softbody_tpu_torch.models import tearing_cloth_lattice
    from softbody_tpu_torch.ops.stencil import lattice_frame

    state, spec, cfg, consts = tearing_cloth_lattice(
        n_particles=24 * 24, fall_speed=40.0, slits=2, strain_limit=0.22,
        yield_strain=0.18, device="cpu")
    cfg = tb.StaticConfig(subticks=8, particle_radius=cfg.particle_radius)
    be = FusedLatticeBackend(spec, cfg, device="cpu", kernel_variants=())
    packed = be.step(be.pack_state(state), consts, tb.UserInput())
    got = lattice_state_to_numpy(be.unpack_state(packed))
    ref = lattice_state_to_numpy(lattice_frame(state, consts, tb.UserInput(),
                                               spec, cfg))
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for eg, er in zip(got["edges"], ref["edges"]):
        for k in ("target_length", "last_length", "alive"):
            np.testing.assert_array_equal(eg[k], er[k], err_msg=k)
        for k in ("strain", "stress"):
            np.testing.assert_array_equal(eg[k][er["alive"]],
                                          er[k][er["alive"]], err_msg=k)
    assert be.far_stats() == {"far_rebuilds": 0, "far_pairs": 0,
                              "far_overflow": 0}
