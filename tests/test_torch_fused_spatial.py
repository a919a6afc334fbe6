"""The port's sharded fused frames (``parallel/fused_spatial.py``, kernel
K4; ``parallel/fused_spatial2.py``, kernel K1, with the far field across
slabs) against the JAX package's on its virtual CPU devices (Pallas in
interpret mode, as tests/test_fused_spatial.py and
tests/test_fused_spatial2.py run them), and against the port's own
single-device frames.  On the CPU the port's wrappers run the kernels'
plain versions.  Each JAX sharded frame is compiled once per module.

- Near field, against the port's ``fused_frame`` / ``fused_frame2``:
  bit-exact in every plane (the ghost ring carries true data, the int32
  spring sums are exact and each cell's collision terms come in the same
  order).
- Against JAX's sharded frames, the JAX tests' own tolerances for its
  sharded against its single-device kernel (drag off, as there): K4 pos
  atol 5e-3 with the rtol 1e-5 of tests/test_fused_substep.py for K4
  against the XLA substep with breakage; edge targets twice that (a
  yielded target is the distance of two positions); vel atol 5e-2; K1 pos rtol 1e-4 atol 2e-2, vel rtol 1e-4 atol 5e-2, strain
  atol 1e-3; edge ``alive`` bit-exact.  The port's plain versions sum collision offsets in the
  XLA order, JAX's kernels in theirs.
- The far-armed boundary fold (tests/test_fused_spatial2.py:56-76's
  strip, 2 shards, 2 substeps, one rebuild): against JAX's sharded far
  frame within tests/test_fused_spatial2.py:114-117's tolerances (pos
  atol 5e-3, vel 5e-2).  Its candidate lists are built on another chunk
  grid (JAX's is padded by PAD_W/PAD_H) and summed in another order, so
  the far deltas agree to float32 rounding, not bit for bit."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.ops.farfield import FarFieldSpec as JFarFieldSpec
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
from softbody_tpu.parallel import make_mesh as j_make_mesh
from softbody_tpu.parallel import fused_spatial as jfs
from softbody_tpu.parallel import fused_spatial2 as jfs2
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import lattice_state_to_numpy
from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
from softbody_tpu_torch.ops.cuda.fused_substep import (
    fused_frame,
    pack_lattice,
    unpack_lattice,
)
from softbody_tpu_torch.ops.cuda.fused_substep2 import (
    fused_frame2,
    pack_lattice2,
    unpack_lattice2,
)
from softbody_tpu_torch.ops.farfield import FarFieldSpec
from softbody_tpu_torch.ops.stencil import LatticeSpec
from softbody_tpu_torch.parallel import make_mesh
from softbody_tpu_torch.parallel import fused_spatial as tfs
from softbody_tpu_torch.parallel import fused_spatial2 as tfs2

from test_fused_spatial import scene
from test_fused_spatial2 import RADIUS, boundary_fold
from torch_parity import consts_to_port, to_port, uin_to_port

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices"
)

W, H, N_DEV = 32, 12, 4
# drag off, as the JAX tests compare their sharded kernels
CONSTS = dataclasses.replace(PhysicsConstants.default(),
                             drag_coeff=jnp.float32(0.0))
UIN = UserInput.none()
FF = dict(max_pairs=128, max_tile_pairs=32, skin=4.0, horizon=8)


def _cfg(stencil, **kw):
    return StaticConfig(subticks=4, particle_radius=9.0,
                        collision_mode="allpairs" if stencil else "none",
                        **kw)


def _port_cfg(cfg):
    return tb.StaticConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(tb.StaticConfig)})


def _tearing(seed=7):
    """tests/test_fused_spatial.py:175-190's world: edges that break."""
    ls = scene(W, H, seed=seed)
    return dataclasses.replace(ls, edges=tuple(
        dataclasses.replace(e, strain_limit=jnp.full((W, H), 0.02,
                                                     jnp.float32))
        for e in ls.edges))


def _cpu_mesh(n):
    return make_mesh(n, dp=1, devices=["cpu"] * n)


def _port_k4(ps, spec, cfg, n_dev, ghost=tfs.GHOST):
    mesh = _cpu_mesh(n_dev)
    m, im, w_loc = tfs.pack_lattice_sharded(ps, n_dev, ghost=ghost)
    m, im = tfs.shard_stacks(m, im, mesh)
    fn = tfs.fused_spatial_frame_fn(spec, _port_cfg(cfg), mesh)
    out = fn(m, im, consts_to_port(CONSTS), uin_to_port(UIN))
    return lattice_state_to_numpy(tfs.unpack_lattice_sharded(
        out, ps, n_dev, w_loc))


@pytest.fixture(scope="module")
def k4_jax():
    """JAX's sharded K4 frame at stencil 2 on the smooth scene and on the
    tearing one (one compiled step)."""
    spec = JLatticeSpec(W, H, collision_stencil=2)
    mesh = j_make_mesh(N_DEV, dp=1)
    step = jfs.fused_spatial_frame_fn(spec, _cfg(2), mesh, tile_w=8,
                                      donate=False, interpret=True)
    out = {}
    for name, ls in (("smooth", scene(W, H)), ("tearing", _tearing())):
        ps = to_port(ls)
        m, im, w_loc = jfs.pack_lattice_sharded(ls, N_DEV, tile_w=8)
        m, im = jfs.shard_stacks(m, im, mesh)
        got = jfs.unpack_lattice_sharded(step(m, im, CONSTS, UIN), ls,
                                         N_DEV, w_loc)
        out[name] = (ps, lattice_state_to_numpy(got))
    return out


def _assert_equal(got, ref):
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        for k in ("target_length", "last_length", "strain", "stress",
                  "alive"):
            np.testing.assert_array_equal(eg[k], er[k], err_msg=f"{c} {k}")


@pytest.mark.parametrize("stencil,ghost", [(0, 1), (2, 2), (2, 8)])
def test_k4_sharded_bit_exact_against_single_device(stencil, ghost):
    ps = to_port(_tearing())
    spec, cfg = LatticeSpec(W, H, collision_stencil=stencil), _cfg(stencil)
    mut, immut = pack_lattice(ps)
    ref = unpack_lattice(fused_frame(mut, immut, consts_to_port(CONSTS),
                                     uin_to_port(UIN), spec,
                                     _port_cfg(cfg)), immut, ps)
    _assert_equal(_port_k4(ps, spec, cfg, N_DEV, ghost),
                  lattice_state_to_numpy(ref))


@pytest.mark.parametrize("name", ["smooth", "tearing"])
def test_k4_sharded_matches_jax(k4_jax, name):
    ps, ref = k4_jax[name]
    got = _port_k4(ps, LatticeSpec(W, H, collision_stencil=2), _cfg(2),
                   N_DEV)
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-5, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)
    broke = 0
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
        np.testing.assert_allclose(eg["target_length"], er["target_length"],
                                   rtol=2e-5, atol=1e-2)
        broke += int((~er["alive"]).sum())
    if name == "tearing":
        assert broke > 0, "edges tear across the slabs"


def _port_k1(ps, spec, cfg, n_dev, ghost=tfs.GHOST, ffspec=None,
             rebuild_every=8):
    mesh = _cpu_mesh(n_dev)
    h, o, im, ec, w_loc = tfs2.pack_lattice2_sharded(ps, n_dev, ghost=ghost)
    h, o, im = tfs2.shard_stacks2(h, o, im, mesh)
    fn = tfs2.fused_spatial2_frame_fn(spec, _port_cfg(cfg), mesh,
                                      ffspec=ffspec,
                                      rebuild_every=rebuild_every)
    h, o = fn(h, o, im, ec, consts_to_port(CONSTS), uin_to_port(UIN))
    return lattice_state_to_numpy(tfs2.unpack_lattice2_sharded(
        h, o, ps, n_dev, w_loc))


@pytest.mark.parametrize("stencil", [0, 2])
def test_k1_sharded_bit_exact_against_single_device(stencil):
    ps = to_port(scene(W, H))
    spec, cfg = LatticeSpec(W, H, collision_stencil=stencil), _cfg(stencil)
    hot, obs, immut, ec = pack_lattice2(ps)
    hot, obs = fused_frame2(hot, obs, immut, ec, consts_to_port(CONSTS),
                            uin_to_port(UIN), spec, _port_cfg(cfg))
    _assert_equal(_port_k1(ps, spec, cfg, N_DEV, ghost=max(1, stencil)),
                  lattice_state_to_numpy(unpack_lattice2(hot, obs, ps)))


def test_k1_sharded_matches_jax():
    ls = scene(W, H)
    ps = to_port(ls)
    cfg = _cfg(2)
    mesh = j_make_mesh(N_DEV, dp=1)
    h, o, im, ec, w_loc = jfs2.pack_lattice2_sharded(ls, N_DEV, tile_w=8)
    h, o, im = jfs2.shard_stacks2(h, o, im, mesh)
    step = jfs2.fused_spatial2_frame_fn(
        JLatticeSpec(W, H, collision_stencil=2), cfg, mesh, tile_w=8,
        donate=False, interpret=True)
    h, o = step(h, o, im, ec, CONSTS, UIN)
    ref = lattice_state_to_numpy(jfs2.unpack_lattice2_sharded(
        h, o, ls, N_DEV, w_loc))
    got = _port_k1(ps, LatticeSpec(W, H, collision_stencil=2), cfg, N_DEV)
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=1e-4, atol=2e-2)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=1e-4, atol=5e-2)
    for eg, er in zip(got["edges"], ref["edges"]):
        np.testing.assert_array_equal(eg["alive"], er["alive"])
        np.testing.assert_allclose(eg["strain"], er["strain"], rtol=0,
                                   atol=1e-3)


def test_far_fold_across_boundary():
    """The fold's layers lie on different slabs: the far field across
    slabs holds them apart as JAX's sharded far frame does."""
    w, h = 32, 8
    ls = boundary_fold(w, h)
    ps = to_port(ls)
    cfg = StaticConfig(subticks=2, collision_mode="allpairs",
                       particle_radius=RADIUS, force_mode="quantized")
    mesh = j_make_mesh(2, dp=1)
    hs, os_, im, ec, w_loc = jfs2.pack_lattice2_sharded(ls, 2, tile_w=8)
    hs, os_, im = jfs2.shard_stacks2(hs, os_, im, mesh)
    step = jfs2.fused_spatial2_frame_fn(
        JLatticeSpec(w, h, collision_stencil=2), cfg, mesh, tile_w=8,
        donate=False, interpret=True, ffspec=JFarFieldSpec(**FF),
        rebuild_every=2)
    hs, os_ = step(hs, os_, im, ec, CONSTS, UIN)
    ref = lattice_state_to_numpy(jfs2.unpack_lattice2_sharded(
        hs, os_, ls, 2, w_loc))

    tfs2.far_stats()
    got = _port_k1(ps, LatticeSpec(w, h, collision_stencil=2), cfg, 2,
                   ffspec=FarFieldSpec(**FF), rebuild_every=2)
    stats = tfs2.far_stats()
    assert stats["rebuilds"] == 1 and stats["max_overflow"] == 0, stats
    assert stats["n_pairs"] > 0, "the fold gives far candidates"
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)
    for g in (got, ref):
        y = g["pos"][..., 1]
        assert float(np.median(y[w // 2:] - y[: w // 2][::-1])) > 0.0


@pytest.mark.parametrize("w,h", [(32, 8), (64, 8)])
def test_folded_strip_matches_boundary_fold(w, h):
    """The port's folded strip (the far-armed sharded card checks' scene)
    is tests/test_fused_spatial2.py's ``boundary_fold``, array for
    array."""
    _assert_equal(lattice_state_to_numpy(folded_strip_lattice(
        w, h, device="cpu")), lattice_state_to_numpy(to_port(
            boundary_fold(w, h))))


def test_slab_checks():
    mesh = _cpu_mesh(4)
    tc = tb.StaticConfig(subticks=8)
    ff = FarFieldSpec(**FF)
    with pytest.raises(ValueError, match="not divisible by 4"):
        tfs.fused_spatial_frame_fn(LatticeSpec(30, 8), tc, mesh)
    with pytest.raises(ValueError, match="slab too narrow"):
        tfs2.fused_spatial2_frame_fn(LatticeSpec(12, 8, collision_stencil=2),
                                     tc, mesh)
    with pytest.raises(ValueError, match="chunk multiples"):
        tfs2.fused_spatial2_frame_fn(LatticeSpec(24, 8), tc, mesh,
                                     ffspec=ff)
    with pytest.raises(ValueError, match="multiple of rebuild_every"):
        tfs2.fused_spatial2_frame_fn(LatticeSpec(32, 8), tc, mesh,
                                     ffspec=ff, rebuild_every=3)
    with pytest.raises(ValueError, match="horizon must cover"):
        tfs2.fused_spatial2_frame_fn(
            LatticeSpec(32, 8), tc, mesh, rebuild_every=8,
            ffspec=dataclasses.replace(ff, horizon=4))
    ps = to_port(scene(W, H))
    spec = LatticeSpec(W, H, collision_stencil=2)
    m, im, _ = tfs.pack_lattice_sharded(ps, 4, ghost=1)
    fn = tfs.fused_spatial_frame_fn(spec, tc, mesh)
    with pytest.raises(ValueError, match="stencil reach 2 exceeds margin 1"):
        fn(list(m), list(im), consts_to_port(CONSTS), uin_to_port(UIN))
    h, o, im2, ec, _ = tfs2.pack_lattice2_sharded(ps, 4, ghost=4)
    fn2 = tfs2.fused_spatial2_frame_fn(spec, tc, mesh, ffspec=ff)
    with pytest.raises(ValueError, match="far band reach 8 exceeds margin"):
        fn2(list(h), list(o), list(im2), ec, consts_to_port(CONSTS),
            uin_to_port(UIN))
