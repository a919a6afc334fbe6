"""Far-field rebuild and apply: the port against the JAX package.

Rebuild: the decoded candidate pair set (chunk coordinates), ``n_pairs``
and ``overflow`` must be equal.  Apply: the five delta planes agree to
atol 1e-5 (the f32 scatter-add order differs).  Each scene's rebuilds
(JAX's and the port's) and JAX's apply on them are computed once for the
module and shared by the cases that read them."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.farfield import _chunk_dims as j_chunk_dims
from softbody_tpu.ops.farfield import far_collision_terms as j_terms
from softbody_tpu.ops.farfield import rebuild_far_list_planes as j_rebuild
from softbody_tpu.ops import farfield as jff
from softbody_tpu_torch.ops import farfield as tff
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    FarList,
    _chunk_dims,
    empty_far_list,
    far_collision_terms,
    rebuild_far_list_planes,
)
from softbody_tpu_torch.ops.farfield4 import bucketed_far_delta_planes

from test_farfield import hairpin
from test_fused4 import _fold_planes
from torch_threads import two_torch_threads  # noqa: F401

DT = 1 / 64


def _fold():
    return tuple(np.array(a) for a in _fold_planes())


def _hairpin():
    ls = hairpin()
    pos, vel = np.array(ls.pos), np.array(ls.vel)
    return (pos[..., 0], pos[..., 1], vel[..., 0], vel[..., 1],
            np.array(ls.alive))


# scene → (planes, far-field spec kwargs, radius)
SCENES = {
    "fold": (_fold, dict(max_pairs=128, max_tile_pairs=32, skin=2.0,
                         horizon=8), 1.5),
    "fold_overflow": (_fold, dict(max_pairs=12, max_tile_pairs=4, skin=2.0,
                                  horizon=8), 1.5),
    "hairpin": (_hairpin, dict(max_pairs=512, max_tile_pairs=64, skin=4.0,
                               horizon=8), 4.0),
}


def _decoded(ca, cb, valid, cwy):
    ca, cb, valid = (np.asarray(a) for a in (ca, cb, valid))
    return sorted((int(a) // cwy, int(a) % cwy, int(b) // cwy, int(b) % cwy)
                  for a, b in zip(ca[valid], cb[valid]))


@functools.lru_cache(maxsize=None)
def _both(scene, velocity):
    """The scene's planes, far-field spec kwargs, radius and both
    packages' rebuilds on them (once per module: no case writes them)."""
    make, ffkw, radius = SCENES[scene]
    px, py, vx, vy, alive = make()
    vkw_j = dict(vx=jnp.asarray(vx), vy=jnp.asarray(vy), dt=DT) \
        if velocity else {}
    vkw_t = dict(vx=torch.from_numpy(vx), vy=torch.from_numpy(vy), dt=DT) \
        if velocity else {}
    jfl = j_rebuild(jnp.asarray(px), jnp.asarray(py), jnp.asarray(alive),
                    s=2, ff=JFarFieldSpec(**ffkw), radius=radius,
                    band_impl="xla", **vkw_j)
    tfl = rebuild_far_list_planes(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(alive),
        s=2, ff=FarFieldSpec(**ffkw), radius=radius, **vkw_t)
    return (px, py, vx, vy, alive), ffkw, radius, jfl, tfl


@pytest.mark.parametrize("scene,velocity", [
    ("fold", True), ("fold_overflow", True), ("hairpin", False),
    ("hairpin", True)])
def test_rebuild_matches_jax(scene, velocity):
    planes, ffkw, _r, jfl, tfl = _both(scene, velocity)
    w, h = planes[0].shape
    jcwy = j_chunk_dims(w, h, JFarFieldSpec(**ffkw))[1]
    tcwy = _chunk_dims(w, h, FarFieldSpec(**ffkw))[1]
    assert int(tfl.n_pairs) == int(jfl.n_pairs) > 0
    assert int(tfl.overflow) == int(jfl.overflow)
    if scene == "fold_overflow":
        assert int(jfl.overflow) > 0, "the small capacity must overflow"
    assert tfl.counts() == (int(jfl.n_pairs), int(jfl.overflow))
    assert _decoded(tfl.ca, tfl.cb, tfl.valid, tcwy) == _decoded(
        jfl.ca, jfl.cb, jfl.valid, jcwy)


def _port_list(jfl, like: FarList) -> FarList:
    """The JAX list's pairs in a port FarList (same chunk grid)."""
    return FarList(
        ca=torch.from_numpy(np.array(jfl.ca, np.int64)),
        cb=torch.from_numpy(np.array(jfl.cb, np.int64)),
        valid=torch.from_numpy(np.array(jfl.valid)),
        n_pairs=torch.tensor(int(jfl.n_pairs), dtype=torch.int32),
        overflow=torch.tensor(int(jfl.overflow), dtype=torch.int32),
        px_ref=like.px_ref, py_ref=like.py_ref, com_ref=like.com_ref,
        vx_ref=like.vx_ref, vy_ref=like.vy_ref)


@functools.lru_cache(maxsize=None)
def _jax_terms(scene):
    """JAX's ``far_collision_terms`` on its own list of the scene (with
    velocities), and the keyword arguments (once per module)."""
    (px, py, vx, vy, alive), ffkw, radius, jfl, _tfl = _both(scene, True)
    kw = dict(s=2, radius=radius, dt=DT, ecoeff=0.75, friction=0.1)
    ref = j_terms(*(jnp.asarray(a) for a in (px, py, vx, vy, alive)), jfl,
                  ff=JFarFieldSpec(**ffkw), world_h=px.shape[1], **kw)
    return ref, kw


@pytest.mark.parametrize("scene", ["fold", "hairpin"])
def test_far_collision_terms_match_jax(scene):
    (px, py, vx, vy, alive), ffkw, radius, jfl, tfl = _both(scene, True)
    w, h = px.shape
    ref, kw = _jax_terms(scene)
    got = far_collision_terms(
        *(torch.from_numpy(a) for a in (px, py, vx, vy, alive)),
        _port_list(jfl, tfl), ff=FarFieldSpec(**ffkw), world_h=h, **kw)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0
    for i in range(5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("scene", ["fold", "hairpin"])
def test_bucketed_apply_matches_jax(scene):
    """The port's bucketed apply (crop to the smallest bucket ≥ n_pairs →
    narrow rows for the fold's bucket 128, the mirror table for the
    hairpin's 512) on its own list against JAX ``far_collision_terms`` on
    the JAX list."""
    (px, py, vx, vy, alive), ffkw, radius, jfl, tfl = _both(scene, True)
    ref, kw = _jax_terms(scene)
    hot = torch.from_numpy(np.stack([px, py, vx, vy]))
    got = bucketed_far_delta_planes(
        hot, torch.from_numpy(alive.astype(np.float32)), tfl,
        int(tfl.n_pairs), ff=FarFieldSpec(**ffkw), buckets=(16,), **kw)
    np.testing.assert_allclose(got.numpy(), np.stack(ref), rtol=0,
                               atol=1e-5)


def test_bucketed_apply_empty_list():
    px, py, vx, vy, alive = _fold()
    w, h = px.shape
    ff = FarFieldSpec(max_pairs=64, max_tile_pairs=32, skin=4.0, horizon=8)
    fl = empty_far_list(w, h, ff, device="cpu")
    hot = torch.from_numpy(np.stack([px, py, vx, vy]))
    assert bucketed_far_delta_planes(
        hot, torch.from_numpy(alive.astype(np.float32)), fl, 0, s=2, ff=ff,
        radius=1.5, dt=DT, ecoeff=0.75, friction=0.1) is None
    assert fl.counts() == (0, 0)


@pytest.mark.parametrize("scene", ["fold", "fold_overflow", "hairpin"])
def test_backend_rebuild_functions_match_jax(scene):
    """The dense backend's rebuild path: ``far_candidate_count`` (total
    and COM), ``rebuild_far_list`` on ``[W, H, 2]`` positions (pair set
    and counts) and ``empty_far_list_at``."""
    make, ffkw, radius = SCENES[scene]
    px, py, _vx, _vy, alive = make()
    w, h = px.shape
    pos = np.stack([px, py], -1)
    kw = dict(s=2, radius=radius)
    j_total, j_com = jff.far_candidate_count(
        jnp.asarray(pos), jnp.asarray(alive), ff=JFarFieldSpec(**ffkw), **kw)
    t_total, t_com = tff.far_candidate_count(
        torch.from_numpy(pos), torch.from_numpy(alive),
        ff=FarFieldSpec(**ffkw), **kw)
    assert int(t_total) == int(j_total) > 0
    np.testing.assert_allclose(t_com.numpy(), np.asarray(j_com), rtol=1e-6)

    jfl = jff.rebuild_far_list(jnp.asarray(pos), jnp.asarray(alive),
                               ff=JFarFieldSpec(**ffkw), **kw)
    tfl = tff.rebuild_far_list(torch.from_numpy(pos),
                               torch.from_numpy(alive),
                               ff=FarFieldSpec(**ffkw), **kw)
    assert tfl.counts() == (int(jfl.n_pairs), int(jfl.overflow))
    cwy = _chunk_dims(w, h, FarFieldSpec(**ffkw))[1]
    assert _decoded(tfl.ca, tfl.cb, tfl.valid, cwy) == _decoded(
        jfl.ca, jfl.cb, jfl.valid, cwy)

    jfe = jff.empty_far_list_at(jnp.asarray(pos), j_com,
                                JFarFieldSpec(**ffkw))
    tfe = tff.empty_far_list_at(torch.from_numpy(pos), t_com,
                                FarFieldSpec(**ffkw))
    assert tfe.counts() == (0, 0) and not bool(tfe.valid.any())
    assert tfe.capacity == jfe.ca.shape[0]
    np.testing.assert_array_equal(tfe.px_ref.numpy(), np.asarray(jfe.px_ref))
    np.testing.assert_array_equal(tfe.vy_ref.numpy(), np.asarray(jfe.vy_ref))


def test_flat_lattice_count_is_zero():
    """An unfolded lattice has no candidates (the fast path's
    invariant): the count is 0 in both packages."""
    from softbody_tpu.models import make_lattice as j_make_lattice

    ls = j_make_lattice(40, 40, 10.0)
    ffkw = dict(max_pairs=512, max_tile_pairs=64, skin=4.0)
    j_total, _ = jff.far_candidate_count(ls.pos, ls.alive, s=2, radius=4.0,
                                         ff=JFarFieldSpec(**ffkw))
    t_total, _ = tff.far_candidate_count(
        torch.from_numpy(np.array(ls.pos)), torch.from_numpy(
            np.array(ls.alive)), s=2, radius=4.0, ff=FarFieldSpec(**ffkw))
    assert int(t_total) == int(j_total) == 0


def test_motion_checks_match_jax():
    """``displacement_check`` and ``max_relative_speed`` (the rebuild
    trigger's inputs): equal to JAX's to float tolerance (sum order), a
    rigid translation reads as no displacement."""
    px, py, vx, vy, alive = _hairpin()
    pos, vel = np.stack([px, py], -1), np.stack([vx, vy], -1)
    ffkw = SCENES["hairpin"][1]
    jfl = jff.rebuild_far_list(jnp.asarray(pos), jnp.asarray(alive), s=2,
                               ff=JFarFieldSpec(**ffkw), radius=4.0)
    tfl = tff.rebuild_far_list(torch.from_numpy(pos),
                               torch.from_numpy(alive), s=2,
                               ff=FarFieldSpec(**ffkw), radius=4.0)
    rng = np.random.default_rng(3)
    moved = (pos + rng.normal(0.0, 0.5, pos.shape)).astype(np.float32)
    shifted_pos = (pos + np.float32([123.0, -77.0])).astype(np.float32)
    for p in (moved, shifted_pos):
        ref = float(jff.displacement_check(jnp.asarray(p),
                                           jnp.asarray(alive), jfl))
        got = float(tff.displacement_check(torch.from_numpy(p),
                                           torch.from_numpy(alive), tfl))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    assert got < 1e-3
    ref = float(jff.max_relative_speed(jnp.asarray(vel), jnp.asarray(alive)))
    got = float(tff.max_relative_speed(torch.from_numpy(vel),
                                       torch.from_numpy(alive)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got > 1.0


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunk_views_match_jax(chunk):
    """``chunk_view`` and ``unchunk_view`` on a padded plane bit for bit
    against the JAX package's, and back to the plane."""
    ff_kw = dict(chunk=chunk, tile_chunks=2)
    wp, hp = 4 * chunk, 6 * chunk
    x = np.random.default_rng(chunk).normal(size=(wp, hp)).astype(np.float32)
    ref = np.asarray(jff.chunk_view(jnp.asarray(x), JFarFieldSpec(**ff_kw)))
    got = tff.chunk_view(torch.from_numpy(x), FarFieldSpec(**ff_kw))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tff.unchunk_view(got, wp, hp, FarFieldSpec(**ff_kw))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jff.unchunk_view(
        jnp.asarray(ref), wp, hp, JFarFieldSpec(**ff_kw))))
