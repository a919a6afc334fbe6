"""The mirror-record far apply and its kernels K5–K7 (plain versions on
the CPU) against the JAX package.

K5–K7 move data only, so they are held bit-exact to numpy's reshape and
to JAX's ``farfield4.mirror_table``.  The apply functions get the JAX
list's pairs and the same zero-padded planes; on the CPU both packages
scatter-add in list order, so their delta planes are bit-exact to JAX's
functions run op by op.  JAX's bucketed apply runs jitted under
``lax.switch``, where XLA reorders the f32 sums: against it the tolerance
is rtol 1e-5, atol 1e-3 (the far deltas sum terms of up to ~4e3 that
cancel, a few ulp of which is ~1e-3).  The
fused backend's fold runs the whole frame (rebuild, bucketed apply, K1's
plain version) against JAX's ``kernel_variants=()`` frame, to the
tolerances of tests/test_fused4.py:136-139 (pos atol 5e-3, vel atol
5e-2) that tests/test_torch_frame.py uses; its far stats must be equal."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbody_tpu import UserInput
from softbody_tpu.ops import farfield4 as j4
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.farfield import rebuild_far_list_planes as j_rebuild
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.ops import farfield4 as t4
from softbody_tpu_torch.ops.cuda import recmirror
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    rebuild_far_list_planes,
)

from test_torch_farfield import DT, SCENES, _port_list
from test_torch_frame import (
    _assert_close,
    _hairpin_scene,
    _port_backend,
    hairpin_reference,
)
from torch_parity import consts_to_port, to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

KW = dict(s=2, dt=DT, ecoeff=0.75, friction=0.1)


def test_cast_kernels_plain_match_reshape():
    """K5 and K6 (plain versions, CPU tensors) are numpy's reshape, and
    new tensors."""
    x = np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32)
    xt = torch.from_numpy(x)
    y = recmirror.cast_rows_call(xt)
    np.testing.assert_array_equal(y.numpy(), x.reshape(256, 32))
    assert y.data_ptr() != xt.data_ptr()
    back = recmirror.uncast_rows_call(y)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        recmirror.cast_rows_call(xt[:, :64])
    with pytest.raises(ValueError):
        recmirror.uncast_rows_call(y[:6])


@pytest.mark.parametrize("w,h", [(256, 256), (96, 40), (12, 50)])
def test_mirror_records_match_jax(w, h):
    """K7's plain version against JAX's ``mirror_table`` (which
    scripts/probe_recmirror.py holds the TPU kernel to), with H padded to
    32 where it is not a multiple; and ``unmirror_table ∘ mirror_table``
    is the identity."""
    planes = np.random.default_rng(w + h).normal(size=(5, w, h)).astype(
        np.float32)
    planes[0, 1, 2] = -0.0
    ref = np.asarray(j4.mirror_table(jnp.asarray(planes)))
    got = t4.mirror_table(torch.from_numpy(planes))
    assert got.shape == ref.shape == (-(-h // 32) * (w // 4), 640)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(ref))
    back = t4.unmirror_table(got, w=w, h=h)
    np.testing.assert_array_equal(back.numpy(), planes)


def test_mirror_table_pads_to_the_apply_grid():
    """The 1M bench lattice (1000 × 1000) applies its pairs on the
    rebuild's tile-padded grid, 1008 × 1008: 32 lane blocks × 252 record
    columns of 640 floats; the pad reads 0 and the crop gives the planes
    back."""
    ff = FarFieldSpec(max_pairs=16384, max_tile_pairs=256, horizon=8)
    _cwx, _cwy, wp, hp = _chunk_dims(1000, 1000, ff)
    assert (wp, hp) == (1008, 1008)
    gen = torch.Generator().manual_seed(0)
    planes = [torch.rand((1000, 1000), generator=gen) + 1.0
              for _ in range(5)]
    tab = t4.mirror_table(planes, w=wp, h=hp)
    assert tuple(tab.shape) == (32 * 252, 640)
    back = t4.unmirror_table(tab, w=wp, h=hp)
    assert bool((back[:, 1000:] == 0).all()) and bool(
        (back[:, :, 1000:] == 0).all())
    torch.testing.assert_close(back[:, :1000, :1000], torch.stack(planes),
                               rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _scene_lists(scene):
    """A scene's planes, its JAX list, the same pairs as a port list, and
    the planes zero-padded to the tile grid ``[5, wp, hp]``."""
    make, ffkw, radius = SCENES[scene]
    px, py, vx, vy, alive = make()
    w, h = px.shape
    rebuild = jax.jit(j_rebuild, static_argnames=("s", "ff", "radius",
                                                  "dt", "band_impl"))
    jfl = rebuild(*(jnp.asarray(a) for a in (px, py, alive)), s=2,
                  ff=JFarFieldSpec(**ffkw), radius=radius,
                  vx=jnp.asarray(vx), vy=jnp.asarray(vy), dt=DT,
                  band_impl="xla")
    tfl = rebuild_far_list_planes(
        *(torch.from_numpy(a) for a in (px, py, alive)), s=2,
        ff=FarFieldSpec(**ffkw), radius=radius, vx=torch.from_numpy(vx),
        vy=torch.from_numpy(vy), dt=DT)
    assert tfl.counts() == (int(jfl.n_pairs), int(jfl.overflow))
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, FarFieldSpec(**ffkw))
    padded = np.zeros((5, wp, hp), np.float32)
    for i, a in enumerate((px, py, vx, vy, alive.astype(np.float32))):
        padded[i, :w, :h] = a
    return (px, py, vx, vy, alive), jfl, _port_list(jfl, tfl), padded


@pytest.mark.parametrize("scene", ["fold"])
def test_far_terms_from_mirror_match_jax(scene):
    """The mirror route's delta table, bit-exact (CPU scatter order is
    the list's in both packages).  One scene: JAX runs this function op
    by op, ~15 s."""
    _planes, jfl, tfl, padded = _scene_lists(scene)
    _make, ffkw, radius = SCENES[scene]
    _f, wp, hp = padded.shape
    kw = dict(KW, radius=radius, w=wp, h=hp)
    ref = np.asarray(j4.far_terms_from_mirror(
        j4.mirror_table(jnp.asarray(padded)), jfl, ff=JFarFieldSpec(**ffkw),
        **kw))
    got = t4.far_terms_from_mirror(
        t4.mirror_table(torch.from_numpy(padded)), tfl,
        ff=FarFieldSpec(**ffkw), **kw).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(np.signbit(got), np.signbit(ref))


@pytest.mark.parametrize("scene", ["fold", "hairpin"])
def test_far_delta_planes_narrow_match_jax(scene):
    """The narrow route's delta planes, bit-exact; the unpadded planes
    given as five tensors are padded as the JAX caller pads them."""
    (px, py, vx, vy, alive), jfl, tfl, padded = _scene_lists(scene)
    _make, ffkw, radius = SCENES[scene]
    _f, wp, hp = padded.shape
    kw = dict(KW, radius=radius, w=wp, h=hp)
    ref = np.asarray(j4.far_delta_planes_narrow(
        jnp.asarray(padded), jfl, ff=JFarFieldSpec(**ffkw), **kw))
    five = [torch.from_numpy(a) for a in (px, py, vx, vy,
                                          alive.astype(np.float32))]
    got = t4.far_delta_planes_narrow(five, tfl, ff=FarFieldSpec(**ffkw),
                                     **kw).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scene,buckets,route", [
    ("fold", (16,), "narrow"),
    ("hairpin", (256,), "narrow"),
    ("hairpin", (1024, 2048, 4096), "mirror"),
])
def test_bucketed_far_delta_planes_match_jax(scene, buckets, route):
    """The bucketed apply on the unpadded packed stack against JAX's on
    the padded one (cropped), through the route JAX picks for the bucket
    (narrow ≤ 256 < mirror); to the module's tolerance (jitted JAX)."""
    (px, py, vx, vy, alive), jfl, tfl, padded = _scene_lists(scene)
    _make, ffkw, radius = SCENES[scene]
    _f, wp, hp = padded.shape
    n_pairs = int(jfl.n_pairs)
    k = t4.bucket_capacity(n_pairs, FarFieldSpec(**ffkw), buckets)
    assert (k <= t4.NARROW_MAX) == (route == "narrow")
    ref = np.asarray(j4.bucketed_far_delta_planes(
        jnp.asarray(padded[:4]), jnp.asarray(padded[4]), jfl,
        ff=JFarFieldSpec(**ffkw), radius=radius, w=wp, h=hp,
        buckets=buckets, **KW))
    hot = torch.from_numpy(np.stack([px, py, vx, vy]))
    got = t4.bucketed_far_delta_planes(
        hot, torch.from_numpy(alive.astype(np.float32)), tfl, n_pairs,
        ff=FarFieldSpec(**ffkw), radius=radius, buckets=buckets, **KW)
    w, h = px.shape
    assert got.is_contiguous() and tuple(got.shape) == (5, w, h)
    np.testing.assert_allclose(got.numpy(), ref[:, :w, :h], rtol=1e-5,
                               atol=1e-3)


def test_mirror_route_raises_on_unported_layouts():
    """Lane blocks that are not multiples of 32 (mb = 48, mb_out = 16)
    and pre-built tables (kmirror, krec; a 128-lane one too) are refused;
    the apply also refuses a height that breaks the chunk-id decode."""
    planes = torch.zeros((5, 8, 32))
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=32)
    _planes, _jfl, fl, _padded = _scene_lists("hairpin")
    kw = dict(KW, ff=ff, radius=4.0, w=96, h=16)
    with pytest.raises(ValueError):
        t4.mirror_table(planes, mb=48)
    with pytest.raises(ValueError):
        t4.unmirror_table(torch.zeros((2, 640)), w=8, h=32, mb=16)
    with pytest.raises(ValueError):
        t4.far_terms_from_mirror(torch.zeros((3 * 24, 640)), fl, mb=48,
                                 **kw)
    with pytest.raises(ValueError):
        recmirror.mirror_records_call(list(planes), w_out=8, h_out=48,
                                      mb=48)
    fn = functools.partial(t4.bucketed_far_delta_from_fn, lambda: planes,
                           fl, 25, **kw)
    for bad in (dict(mb=48), dict(mb_out=16),
                dict(table=torch.zeros((24, 640))), dict(as_table=True),
                dict(mb=128, table=torch.zeros((6, 2560)))):
        with pytest.raises(ValueError):
            fn(**bad)
    with pytest.raises(ValueError):
        t4.bucketed_far_delta_from_fn(lambda: planes, fl, 25,
                                      **dict(kw, h=1000))
    assert fn() is not None
    assert fn(mb=128, mb_out=64) is not None


@pytest.mark.parametrize("buckets,route", [
    (None, "mirror"), ((64, 256), "narrow")])
def test_fused_backend_fold_matches_jax(buckets, route):
    """Two frames of the folded strip through ``FusedLatticeBackend``
    with a 512-pair list: the default ladder applies through the mirror
    table, a ladder of buckets ≤ 256 through the narrow rows; both
    against JAX's strict frames of the strip (``hairpin_reference``, one
    run for both cases: its list holds the same pairs, applied in another
    f32 order, which the tolerance covers)."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    ffkw = dict(ffkw, max_pairs=512)
    jb = (1024, 2048, 4096) if buckets is None else buckets
    ref, ref_stats = hairpin_reference()
    be = _port_backend(spec, cfg, ffkw, far_buckets=buckets)
    state = be.pack_state(to_port(ls))
    for _ in range(2):
        state = be.step(state, consts_to_port(consts),
                        uin_to_port(UserInput.none()))
    got = lattice_state_to_numpy(be.unpack_state(state))
    assert be.far_stats() == ref_stats
    n_pairs = ref_stats["far_pairs"]
    assert n_pairs > 0
    k = t4.bucket_capacity(n_pairs, FarFieldSpec(**ffkw), jb)
    assert (k <= t4.NARROW_MAX) == (route == "narrow")
    _assert_close(got, ref)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])


def test_fused_backend_step_uses_the_mirror_route():
    """The fused frame's far apply is ``farfield4``'s bucketed route: with
    the default ladder every substep with pairs goes through the mirror
    table (whose CPU plain version stands in for K7 here)."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    be = _port_backend(spec, cfg, dict(ffkw, max_pairs=512))
    before = dict(t4.APPLY_ROUTES)
    state = be.pack_state(to_port(ls))
    be.step(state, consts_to_port(consts), uin_to_port(UserInput.none()))
    ran = {k: v - before[k] for k, v in t4.APPLY_ROUTES.items()}
    assert be.far_stats()["far_pairs"] > 0
    assert ran == {"narrow": 0, "mirror": cfg.subticks, "kernel": 0}
