"""Far-field band detection: the K2 wrapper's plain version (CPU
tensors) against the JAX package — the chunk planes of
``raw_chunk_planes(band_impl="xla")`` and the particle flags of the
Pallas band kernel in interpret mode.  Bit-exact: both sides evaluate
``d2 = ddx·ddx + ddy·ddy < ((base + dev_i) + dev_j)²`` in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.farfield import far_candidate_count as \
    j_far_candidate_count
from softbody_tpu.ops.farfield import raw_chunk_planes as j_raw
from softbody_tpu.ops.farfield import rebuild_far_list as j_rebuild_far_list
from softbody_tpu.ops.pallas.band_detect import band_flag_call as j_band
from softbody_tpu_torch.ops.cuda.band_detect import (
    BAND_DY,
    SMEM_LIMIT,
    band_flag_call,
    band_flags_plain,
    band_radius,
    wide_smem_bytes,
)
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    far_candidate_count,
    raw_chunk_planes,
    rebuild_far_list,
)

from test_fused4 import _fold_planes
from test_torch_farfield import _decoded
from torch_threads import two_torch_threads  # noqa: F401

FF_KW = dict(max_pairs=256, max_tile_pairs=64, skin=4.0, horizon=8)


def _random_planes(w=32, h=48, seed=9):
    """A crumpled world: particles a few units apart, so the band fires
    densely; dead particles included."""
    rng = np.random.default_rng(seed)
    px = (rng.normal(0, 6.0, (w, h)) + np.arange(w)[:, None] * 0.5)
    py = (rng.normal(0, 6.0, (w, h)) + np.arange(h)[None, :] * 0.5)
    vx = rng.normal(0, 2.0, (w, h))
    vy = rng.normal(0, 2.0, (w, h))
    alive = rng.random((w, h)) > 0.15
    return tuple(a.astype(np.float32) for a in (px, py, vx, vy)) + (alive,)


SCENES = {
    "fold_32x32": lambda: tuple(np.array(a) for a in _fold_planes()),
    "random_32x48": _random_planes,
}


def _vbar(vx, vy, alive):
    """The same float32 mean velocity for both packages."""
    n = np.float32(max(alive.sum(), 1))
    return (np.float32(vx[alive].astype(np.float64).sum() / n),
            np.float32(vy[alive].astype(np.float64).sum() / n))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_raw_chunk_planes_match_jax(scene):
    px, py, vx, vy, alive = SCENES[scene]()
    vbx, vby = _vbar(vx, vy, alive)
    kw = dict(s=2, radius=4.0, T_band=8 / 64)
    jraw, jcany, jcom = j_raw(
        *(jnp.asarray(a) for a in (px, py, alive)), ff=JFarFieldSpec(**FF_KW),
        vxu=jnp.asarray(vx), vyu=jnp.asarray(vy),
        vbar=(jnp.float32(vbx), jnp.float32(vby)), band_impl="xla", **kw)
    t = [torch.from_numpy(a) for a in (px, py, vx, vy, alive)]
    traw, tcany, tcom = raw_chunk_planes(
        t[0], t[1], t[4], ff=FarFieldSpec(**FF_KW), vxu=t[2], vyu=t[3],
        vbar=(torch.tensor(vbx), torch.tensor(vby)), **kw)
    assert np.asarray(jraw.band).sum() > 0, "the scene must flag chunks"
    for name, a, b in zip(jraw._fields, traw, jraw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(tcany.numpy(), np.asarray(jcany))
    np.testing.assert_allclose(tcom.numpy(), np.asarray(jcom), rtol=1e-6)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_band_flags_match_jax_kernel(scene):
    px, py, vx, vy, alive = SCENES[scene]()
    rng = np.random.default_rng(1)
    dev = np.where(alive, rng.random(px.shape), 0.0).astype(np.float32)
    bdev = (np.float32(2.0 * 4.0 + 4.0) + dev).astype(np.float32)
    offsets = FarFieldSpec(**FF_KW).band_half_offsets(2)
    ref = np.asarray(j_band(*(jnp.asarray(a) for a in (px, py, dev, bdev,
                                                        alive)),
                            offsets=offsets, tw=16, interpret=True))
    got = band_flag_call(*(torch.from_numpy(a) for a in (px, py, dev, bdev,
                                                          alive)),
                         offsets=offsets)
    assert ref.sum() > 0
    np.testing.assert_array_equal(got.numpy(), ref)


def test_band_wrapper_validates_inputs():
    px, py, vx, vy, alive = (torch.from_numpy(a) for a in _random_planes(
        8, 8))
    offs = FarFieldSpec().band_half_offsets(2)
    with pytest.raises(ValueError):
        band_flag_call(px, py, vx, vy, alive.float(), offsets=offs)
    with pytest.raises(ValueError):
        band_flag_call(px.double(), py, vx, vy, alive, offsets=offs)
    with pytest.raises(ValueError):
        band_flag_call(px.t(), py, vx, vy, alive, offsets=offs)
    # an offset past K2's radii: the CUDA launch refuses it, the plain
    # version on the CPU takes it (no partner there)
    with pytest.raises(ValueError):
        band_radius([(0, 200)])
    assert not bool(band_flag_call(px, py, vx, vy, alive,
                                   offsets=[(0, 200)]).any())


def test_band_wrapper_takes_the_chunk4_band_box():
    """On CPU tensors the wrapper runs the plain version for any offsets:
    the chunk ≤ 4 box, offsets past it (K2's wider bands) and offsets K2
    refuses.  K2's launch box (``band_radius``): the compile-time box up
    to radius 7 (chunk 4), the box set at launch for chunks 8-32, a
    refusal naming the shared-memory limit past that, and for dx < 0."""
    px, py, vx, vy, alive = (torch.from_numpy(a) for a in _random_planes(
        16, 16))
    dev = torch.where(alive, vx.abs(), 0.0)
    planes = (px, py, dev, dev + 12.0, alive)
    for offsets in ([(-1, 0)], [(8, 0)], [(0, 8)], [(3, -8)],
                    FarFieldSpec(chunk=8).band_half_offsets(2)):
        assert band_flag_call(*planes, offsets=offsets).equal(
            band_flags_plain(*planes, offsets))
    for s in range(4):
        offsets = FarFieldSpec().band_half_offsets(s)
        assert band_flag_call(*planes, offsets=offsets + offsets[:3]).equal(
            band_flag_call(*planes, offsets=offsets))
    assert not bool(band_flag_call(*planes, offsets=[]).any())
    assert band_radius(FarFieldSpec(chunk=1).band_half_offsets(2)) == 0
    for chunk in (2, 4, 8, 16, 32):
        offsets = FarFieldSpec(chunk=chunk).band_half_offsets(2)
        r = band_radius(offsets)
        assert r == 2 * chunk - 1
        assert (r <= BAND_DY) == (chunk <= 4)
        assert wide_smem_bytes(r) <= SMEM_LIMIT
    with pytest.raises(ValueError, match="227 KB"):
        band_radius(FarFieldSpec(chunk=64).band_half_offsets(2))
    with pytest.raises(ValueError):
        band_radius([(-1, 0)])


def test_chunk8_rebuild_matches_jax():
    """``FarFieldSpec(chunk=8, tile_chunks=2)`` (band radius 15, past the
    TPU kernel's box): the dense backend's rebuild path — candidate count
    and COM, the list's pairs and counts — equals JAX's XLA band loop on
    a seeded crumpled 32 × 32 sheet."""
    px, py, _vx, _vy, alive = _random_planes(32, 32, seed=11)
    pos = np.stack([px, py], -1)
    ffkw = dict(FF_KW, chunk=8, tile_chunks=2, max_pairs=1024)
    kw = dict(s=2, radius=4.0)
    j_total, j_com = j_far_candidate_count(
        jnp.asarray(pos), jnp.asarray(alive), ff=JFarFieldSpec(**ffkw), **kw)
    t_pos, t_alive = torch.from_numpy(pos), torch.from_numpy(alive)
    t_total, t_com = far_candidate_count(t_pos, t_alive,
                                         ff=FarFieldSpec(**ffkw), **kw)
    assert int(t_total) == int(j_total) > 0
    np.testing.assert_allclose(t_com.numpy(), np.asarray(j_com), rtol=1e-6)
    jfl = j_rebuild_far_list(jnp.asarray(pos), jnp.asarray(alive),
                             ff=JFarFieldSpec(**ffkw), **kw)
    tfl = rebuild_far_list(t_pos, t_alive, ff=FarFieldSpec(**ffkw), **kw)
    assert tfl.counts() == (int(jfl.n_pairs), int(jfl.overflow))
    assert tfl.counts()[0] > 0
    cwy = _chunk_dims(32, 32, FarFieldSpec(**ffkw))[1]
    assert _decoded(tfl.ca, tfl.cb, tfl.valid, cwy) == _decoded(
        jfl.ca, jfl.cb, jfl.valid, cwy)
