"""The parallel layer's compiled steps and the far apply's lane block, on
the CPU.

- Capture: each sharded step (``spatial`` with and without ``dp_axis``,
  ``lattice_spatial`` with K3, ``fused_spatial`` with K4,
  ``fused_spatial2`` near-field and far-armed, ``batched``) on a mesh of
  CPU shards through ``torch_capture.RecordingGraph`` (a stand-in graph
  that re-runs the frame on replay): one capture, then replays over
  three frames, each frame equal bit for bit to the step's eager twin,
  the input left as it was.  A drag through the ``spatial`` step is one
  capture.
- No host read: each step under ``torch_capture.no_host_reads()`` gives
  the bits it gives without the guard; the far-armed ``fused_spatial2``
  frame hands its rebuild record out (``FAR_RECORD`` holds its copies).
- The repair: the fused frame functions take the JAX package's
  ``donate=False, interpret=True`` and leave their input stacks bit for
  bit as they were.
- The lane block: JAX's ``mirror_table`` / ``far_terms_from_mirror`` /
  ``unmirror_table`` (no Pallas) against the port's plain versions at mb
  ∈ {32, 64, 128} × mb_out ∈ {None, 128}, bit-exact, every layout's
  delta planes equal to mb = 32's; K7's plain version at mb = 128
  against JAX's table; ``FusedLatticeBackend(far_mb=128)`` over two
  frames bit-equal to ``far_mb=32`` without ``krec``; the backend's
  ``kvar`` drop rule against the JAX backend's (constructed, never
  stepped).

No JAX frame runs here: the JAX functions called are the far apply's
record layout, op by op."""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu import UserInput as JUserInput
from softbody_tpu.engine import backends as jbackends
from softbody_tpu.ops import farfield as JF
from softbody_tpu.ops import farfield4 as j4
from softbody_tpu.parallel import fused_spatial as j_fused_spatial
from softbody_tpu.parallel import fused_spatial2 as j_fused_spatial2
import softbody_tpu_torch as tb
from softbody_tpu_torch.models import scenes
from softbody_tpu_torch.models.lattice_dense import (
    cloth_lattice,
    folded_strip_lattice,
)
from softbody_tpu_torch.ops import compiled
from softbody_tpu_torch.ops import farfield4 as t4
from softbody_tpu_torch.ops.cuda import recmirror
from softbody_tpu_torch.ops.cuda.fused_substep2 import DEFAULT_KVAR
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    rebuild_far_list_planes,
)
from softbody_tpu_torch.ops.stencil import LatticeSpec
from softbody_tpu_torch.parallel import (
    batched_frame_fn,
    device_put_batched,
    make_mesh,
    pad_state_for_mesh,
    shard_state,
    spatial_frame_fn,
    stack_states,
    unshard_state,
)
from softbody_tpu_torch.parallel import fused_spatial2 as P2
from softbody_tpu_torch.parallel.captured import ShardedStep
from softbody_tpu_torch.parallel.fused_spatial import (
    fused_spatial_frame_fn,
    ghost_width,
    pack_lattice_sharded,
    shard_stacks,
)
from softbody_tpu_torch.parallel.fused_spatial2 import (
    fused_spatial2_frame_fn,
    pack_lattice2_sharded,
    shard_stacks2,
)
from softbody_tpu_torch.parallel.lattice_spatial import (
    lattice_spatial_frame_fn,
    shard_lattice,
)

from test_fused4 import _fold_planes
from test_torch_frame import _hairpin_scene, _port_backend
from torch_capture import RecordingGraph, no_host_reads
from torch_parity import consts_to_port, to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

FRAMES = 3
LAT = tb.StaticConfig(subticks=4, particle_radius=5.0)
SPEC = LatticeSpec(16, 8, collision_stencil=2)
FAR = FarFieldSpec(skin=8.0, horizon=4, max_pairs=128, max_tile_pairs=32)


def _mesh(n, dp=1):
    return make_mesh(n, dp=dp, devices=["cpu"] * n)


def _stirred(st, seed):
    g = torch.Generator().manual_seed(seed)
    return dataclasses.replace(
        st, vel=st.vel + torch.randn(st.vel.shape, generator=g) * 5.0)


def _lattice():
    ls, _, _ = cloth_lattice(w=SPEC.width, h=SPEC.height, spacing=12.0,
                             device="cpu")
    g = torch.Generator().manual_seed(3)
    return dataclasses.replace(
        ls, vel=ls.vel + torch.randn(ls.vel.shape, generator=g) * 20.0)


# each case: () -> (step, args, advance): args the first frame's
# arguments, advance(args, out) the next frame's
def _spatial():
    st, cfg = scenes.cloth(6, 6, device="cpu")
    cfg = dataclasses.replace(cfg, subticks=4)
    mesh = _mesh(2)
    args = (shard_state(pad_state_for_mesh(_stirred(st, 1), 2), mesh),
            tb.PhysicsConstants(), tb.UserInput())
    return spatial_frame_fn(cfg, mesh), args, lambda a, o: (o,) + a[1:]


def _spatial_dp():
    st, cfg = scenes.cloth(4, 4, device="cpu")
    cfg = dataclasses.replace(cfg, subticks=4)
    mesh = _mesh(4, dp=2)
    worlds = [pad_state_for_mesh(_stirred(st, s), 2) for s in (1, 2)]
    args = (shard_state(stack_states(worlds), mesh, dp_axis="dp"),
            tb.PhysicsConstants(), tb.UserInput())
    return (spatial_frame_fn(cfg, mesh, dp_axis="dp"), args,
            lambda a, o: (o,) + a[1:])


def _lattice_spatial():
    cfg = dataclasses.replace(LAT, use_pallas=True)
    mesh = _mesh(2)
    args = (shard_lattice(_lattice(), mesh), tb.PhysicsConstants(),
            tb.UserInput())
    return (lattice_spatial_frame_fn(SPEC, cfg, mesh), args,
            lambda a, o: (o,) + a[1:])


def _fused_spatial():
    mesh = _mesh(2)
    m, im, _w = pack_lattice_sharded(_lattice(), 2, ghost=ghost_width(SPEC))
    m, im = shard_stacks(m, im, mesh)
    args = (m, im, tb.PhysicsConstants(), tb.UserInput())
    return (fused_spatial_frame_fn(SPEC, LAT, mesh), args,
            lambda a, o: (o,) + a[1:])


def _fused_spatial2(far: bool):
    mesh = _mesh(2)
    ls = folded_strip_lattice(SPEC.width, SPEC.height, device="cpu") \
        if far else _lattice()
    ff = FAR if far else None
    h, o, im, ec, _w = pack_lattice2_sharded(ls, 2,
                                             ghost=ghost_width(SPEC, ff))
    h, o, im = shard_stacks2(h, o, im, mesh)
    args = (h, o, im, ec, tb.PhysicsConstants(), tb.UserInput())
    step = fused_spatial2_frame_fn(SPEC, LAT, mesh, ffspec=ff,
                                   rebuild_every=2)
    return step, args, lambda a, out: tuple(out) + a[2:]


def _batched():
    st, cfg = scenes.cloth(4, 4, device="cpu")
    cfg = dataclasses.replace(cfg, subticks=4)
    mesh = _mesh(2, dp=2)
    worlds = stack_states([_stirred(st, s) for s in range(4)])
    args = (device_put_batched(worlds, mesh), tb.PhysicsConstants(),
            tb.UserInput())
    return batched_frame_fn(cfg, mesh), args, lambda a, o: (o,) + a[1:]


CASES = {
    "spatial": _spatial,
    "spatial dp": _spatial_dp,
    "lattice_spatial": _lattice_spatial,
    "fused_spatial": _fused_spatial,
    "fused_spatial2": functools.partial(_fused_spatial2, False),
    "fused_spatial2 far": functools.partial(_fused_spatial2, True),
    "batched": _batched,
}
# calls of the Compiled a frame makes (batched: one a device's batch)
CALLS = {"batched": 2}


def _bits(obj):
    return [t.clone() for t in compiled.tensors(obj)]


def _equal(a, b) -> bool:
    ta, tb_ = list(compiled.tensors(a)), list(compiled.tensors(b))
    return len(ta) == len(tb_) and all(torch.equal(x, y)
                                       for x, y in zip(ta, tb_))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_captures_once_and_replays(case):
    """One capture, then replays, over three frames; each frame equal bit
    for bit to the eager twin's; the first frame's input unchanged."""
    step, args, advance = CASES[case]()
    assert isinstance(step, ShardedStep) and step.captured
    step.compiled.graph_cls = RecordingGraph
    before = _bits(args)
    cap, eag = args, args
    for _ in range(FRAMES):
        out_c, out_e = step(*cap), step.eager(*eag)
        assert _equal(out_c, out_e)
        cap, eag = advance(cap, out_c), advance(eag, out_e)
    n = CALLS.get(case, 1)
    assert step.stats() == {"misses": 1, "captures": 1,
                            "replays": n * FRAMES, "graphs": 1}
    assert all(torch.equal(x, y)
               for x, y in zip(before, compiled.tensors(args)))


def test_drag_through_the_spatial_step_is_one_capture():
    """A mouse drag (a new position and velocity each frame) replays one
    graph, each frame equal to the eager twin's."""
    step, args, _advance = _spatial()
    step.compiled.graph_cls = RecordingGraph
    cap = eag = args[0]
    for i in range(FRAMES):
        uin = tb.UserInput(mouse_active=True,
                           mouse_pos=(40.0 + 7.0 * i, 30.0 - 3.0 * i),
                           mouse_vel=(5.0 * i, -2.0), user_strength=3.0)
        cap = step(cap, args[1], uin)
        eag = step.eager(eag, args[1], uin)
        assert _equal(cap, eag)
    assert step.stats()["captures"] == 1 and step.stats()["replays"] == 3
    assert not torch.equal(unshard_state(cap).pos,
                           unshard_state(args[0]).pos)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_makes_no_host_read(case):
    """The step under ``no_host_reads()`` runs to its end and gives the
    bits it gives without the guard.  The far-armed frame hands its
    rebuild record out: FAR_RECORD holds it, the far pairs are found."""
    step, args, _advance = CASES[case]()
    P2.far_stats()
    with no_host_reads():
        got = step(*args)
    rec = dict(P2.FAR_RECORD)
    stats = P2.far_stats()
    assert _equal(got, step(*args))
    if case == "fused_spatial2 far":
        assert rec["rebuilds"] == LAT.subticks // 2
        assert all(isinstance(rec[k], torch.Tensor) for k in
                   ("n_pairs", "overflow", "max_pairs", "max_overflow"))
        assert stats["max_pairs"] > 0 and stats["max_overflow"] == 0
    else:
        assert rec == {"rebuilds": 0}


def test_far_record_is_a_frame_output():
    """Captured, the far-armed frame's record is copied out of the graph:
    each replay's record equals the eager twin's, the rebuilds counted
    on the host."""
    step, args, advance = _fused_spatial2(True)
    step.compiled.graph_cls = RecordingGraph
    cap = eag = args
    for _ in range(2):
        P2.far_stats()
        out = step(*cap)
        rec_c = P2.far_stats()
        out_e = step.eager(*eag)
        rec_e = P2.far_stats()
        assert rec_c == rec_e and rec_c["rebuilds"] == LAT.subticks // 2
        assert rec_c["n_pairs"] > 0
        cap, eag = advance(cap, out), advance(eag, out_e)


@pytest.mark.parametrize("name", ["fused_spatial", "fused_spatial2"])
def test_fused_frame_fns_take_jax_keywords_and_leave_inputs(name):
    """The JAX functions' signatures are the port's (``donate``,
    ``interpret``, ``tile_w`` included); ``donate=False, interpret=True``
    as JAX's own tests call them; the input stacks bit-unchanged after a
    frame, with either ``donate``."""
    jfn = {"fused_spatial": j_fused_spatial.fused_spatial_frame_fn,
           "fused_spatial2": j_fused_spatial2.fused_spatial2_frame_fn}[name]
    make = {"fused_spatial": fused_spatial_frame_fn,
            "fused_spatial2": fused_spatial2_frame_fn}[name]
    jparams = inspect.signature(jfn).parameters
    params = inspect.signature(make).parameters
    assert list(jparams) == list(params)
    assert {k: p.default for k, p in jparams.items()} == \
        {k: p.default for k, p in params.items()}
    case = _fused_spatial if name == "fused_spatial" else \
        functools.partial(_fused_spatial2, True)
    _step, args, _advance = case()
    mesh = _mesh(2)
    kw = {} if name == "fused_spatial" else dict(ffspec=FAR,
                                                 rebuild_every=2)
    outs = []
    for donate in (False, True):
        step = make(SPEC, LAT, mesh, donate=donate, interpret=True, **kw)
        before = _bits(args)
        outs.append(step(*args))
        assert all(torch.equal(x, y)
                   for x, y in zip(before, compiled.tensors(args)))
    assert _equal(outs[0], outs[1])


def test_several_devices_run_eagerly():
    """A step whose shards lie on several devices runs its frame op by op
    (the branch is the mesh's, taken before any call)."""
    def core(x):
        return x + 1

    step = ShardedStep(core, lambda run, x: run(x),
                       devices=[torch.device("cuda", 0),
                                torch.device("cuda", 1)])
    assert not step.captured
    assert ShardedStep(core, lambda run, x: run(x),
                       devices=["cpu", "cpu"]).captured
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))
    assert step.stats()["misses"] == 0


# ---------------------------------------------------------------------------
# the far apply's lane block against JAX


@functools.lru_cache(maxsize=None)
def _fold_lists():
    """test_fused4.py's fold planes zero-padded to the apply grid, the
    port's list on them and the same list as the JAX package's."""
    px, py, vx, vy, alive = (np.array(a) for a in _fold_planes())
    ffkw = dict(max_pairs=128, max_tile_pairs=32, skin=2.0, horizon=8)
    w, h = px.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, FarFieldSpec(**ffkw))
    padded = np.zeros((5, wp, hp), np.float32)
    for i, a in enumerate((px, py, vx, vy, alive.astype(np.float32))):
        padded[i, :w, :h] = a
    tfl = rebuild_far_list_planes(
        *(torch.from_numpy(a) for a in (px, py, alive)), s=2,
        ff=FarFieldSpec(**ffkw), radius=1.5, vx=torch.from_numpy(vx),
        vy=torch.from_numpy(vy), dt=1 / 64)
    z = jnp.zeros((w, h), jnp.float32)
    jfl = JF.FarList(
        ca=jnp.asarray(tfl.ca.numpy().astype(np.int32)),
        cb=jnp.asarray(tfl.cb.numpy().astype(np.int32)),
        valid=jnp.asarray(tfl.valid.numpy()),
        n_pairs=jnp.int32(int(tfl.n_pairs)),
        overflow=jnp.int32(int(tfl.overflow)), px_ref=z, py_ref=z,
        com_ref=jnp.zeros(2, jnp.float32), vx_ref=z, vy_ref=z,
        age=jnp.int32(0))
    return padded, tfl, jfl, ffkw


def _port_apply(mb, mb_out):
    padded, tfl, _jfl, ffkw = _fold_lists()
    _f, wp, hp = padded.shape
    kw = dict(s=2, radius=1.5, dt=1 / 64, ecoeff=0.75, friction=0.1, w=wp,
              h=hp)
    tab = t4.mirror_table(torch.from_numpy(padded), mb=mb)
    dtab = t4.far_terms_from_mirror(tab, tfl, ff=FarFieldSpec(**ffkw),
                                    mb=mb, mb_out=mb_out, **kw)
    return tab, dtab, kw


@pytest.mark.parametrize("mb_out", [None, 128])
@pytest.mark.parametrize("mb", [32, 64, 128])
def test_lane_block_apply_matches_jax(mb, mb_out):
    """The mirror table, the delta table and its planes at (mb, mb_out)
    bit-exact against JAX's functions run op by op (sign bits too), and
    the delta planes equal to mb = 32's."""
    padded, _tfl, jfl, ffkw = _fold_lists()
    tab, dtab, kw = _port_apply(mb, mb_out)
    jtab = j4.mirror_table(jnp.asarray(padded), mb=mb)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    ref = np.asarray(j4.far_terms_from_mirror(
        jtab, jfl, ff=JF.FarFieldSpec(**ffkw), mb=mb, mb_out=mb_out, **kw))
    got = dtab.numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(np.signbit(got), np.signbit(ref))
    mo = mb if mb_out is None else mb_out
    planes = t4.unmirror_table(dtab, w=kw["w"], h=kw["h"], mb=mo)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(
        j4.unmirror_table(jnp.asarray(ref), w=kw["w"], h=kw["h"], mb=mo)))
    _t32, d32, _kw = _port_apply(32, None)
    assert torch.equal(planes, t4.unmirror_table(d32, w=kw["w"],
                                                  h=kw["h"]))


def test_k7_plain_at_128_lanes_matches_jax():
    """K7's plain version at mb = 128 against JAX's ``mirror_table``:
    rows of 2560 floats, H padded to 128; ``unmirror_table`` inverts
    it."""
    planes = np.random.default_rng(5).normal(size=(5, 24, 200)).astype(
        np.float32)
    planes[1, 3, 7] = -0.0
    ref = np.asarray(j4.mirror_table(jnp.asarray(planes), mb=128))
    got = recmirror.mirror_records_call(
        [torch.from_numpy(p) for p in planes], w_out=24, h_out=256, mb=128)
    assert tuple(got.shape) == ref.shape == (2 * 6, 2560)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(ref))
    back = t4.unmirror_table(got, w=24, h=200, mb=128)
    np.testing.assert_array_equal(back.numpy(), planes)


def test_backend_far_mb128_equals_mb32_without_krec():
    """Two frames of the folded strip (512-pair list: the mirror route)
    through ``FusedLatticeBackend(far_mb=128)``, JAX's default variants
    (its drop rule removes krec), bit-equal to ``far_mb=32`` with krec
    left out by hand."""
    ls, spec, cfg, consts, ffkw = _hairpin_scene()
    ffkw = dict(ffkw, max_pairs=512)
    no_krec = tuple(v for v in DEFAULT_KVAR if v != "krec")
    be128 = _port_backend(spec, cfg, ffkw, far_mb=128,
                          kernel_variants=DEFAULT_KVAR)
    be32 = _port_backend(spec, cfg, ffkw, kernel_variants=no_krec)
    assert be128.kvar == be32.kvar == no_krec
    c, u = consts_to_port(consts), uin_to_port(JUserInput.none())
    before = dict(t4.APPLY_ROUTES)
    states = [be.pack_state(to_port(ls)) for be in (be128, be32)]
    for _ in range(2):
        states = [be.step(s, c, u) for be, s in zip((be128, be32), states)]
        assert _equal(states[0], states[1])
    assert t4.APPLY_ROUTES["mirror"] > before["mirror"]
    assert be128.far_stats() == be32.far_stats()


@pytest.mark.parametrize("opts", [
    dict(far_mb=128), dict(far_mb_out=128), dict(far_buckets=(256, 1024)),
    dict(far_mb=64, far_buckets=(2048,)), dict(),
], ids=["mb128", "mb_out128", "ladder-256", "mb64", "default"])
def test_backend_kvar_drop_rule_matches_jax(opts):
    """The port backend's ``kvar`` equals the JAX backend's for JAX's
    default variants under each layout and ladder (the JAX backend is
    constructed, never stepped)."""
    _ls, spec, cfg, _consts, ffkw = _hairpin_scene()
    jbe = jbackends.FusedLatticeBackend(
        spec, cfg, farfield=JF.FarFieldSpec(**ffkw), tile_w=8, **opts)
    be = _port_backend(spec, cfg, ffkw, kernel_variants=DEFAULT_KVAR,
                       **opts)
    assert be.kvar == tuple(jbe.kvar)
    assert ("krec" in be.kvar) == (opts == {})
