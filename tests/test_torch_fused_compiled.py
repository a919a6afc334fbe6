"""The fused frames with their decisions on the device, on the CPU: the
bucket, the trigger and the rebuilds of ``fused_frame4``,
``fused_frame2_auto`` and ``fused_frame3_auto`` taken through
``compiled.device_if`` / ``device_switch`` (IF nodes of a captured CUDA
graph on the card; here the predicate is read), the far list's age a
device tensor, the stats accumulated on the device.

- ``FarList.age``: a 0-d int32 tensor on the list's device, a host int
  given to the constructor put there.
- ``fused_frame2_auto`` against JAX's jitted frame (compiled without
  XLA's fusion and algebraic simplifier, so that its K1 and its trigger
  round as the port's), 3 substeps from an empty list, bit for bit in
  state, stats, the list's age and pair count: on the fold (a rebuild,
  far pairs) and on the flat strip with −0.0 velocities, whose lists
  stay empty (JAX hands K1 zero far planes there, and so does the
  port).
- ``FusedLatticeBackend(far_mode="v3")`` (``fused_frame3_auto``) against
  JAX's over three frames: ``far_stats()`` equal, its accumulator a
  device tensor between reads; the state within tests/test_torch_frame.py's
  tolerances (pos 5e-3, vel 5e-2: the far apply's sums in another f32
  order; JAX's triggered frame cannot be compiled without fusion here in
  the time of a test).
- No host read: every fused frame, in each of its modes, the backend's
  step and the planified far frame (its buckets on the device) run with ``Tensor.item`` / ``tolist`` / ``__bool__`` /
  ``__int__`` / ``__float__`` / ``__index__``, the tensor constructors
  that copy to a device and the assignment of a host number into a
  tensor patched to raise, except inside
  ``compiled.host_read`` (the eager reads of ``device_if`` /
  ``device_switch``), ``stencil.device_constant`` (a constant table's
  one copy, made by the warm-up) and the kernels' plain versions (the
  kernels on the card).  The same frames with the guard off give the
  same bits.
- ``device_if`` / ``device_switch`` on the CPU: the predicate read, the
  warm-up running every body; the compiled counterparts running their
  functions; the empty-list rung writing zeros.

The rung coverage: the fold's 25 pairs under buckets ``(16,)`` and
``max_pairs`` 64 take the narrow rung 64; the default kernel variants
(``krec``) send it through the mirror route; the activation schedule's
counts cross rungs within a block; the flat strip takes the empty
branch every substep."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.engine import backends as jbackends
from softbody_tpu.models import make_lattice as j_make_lattice
from softbody_tpu.ops import farfield as JF
from softbody_tpu.ops.pallas import fused_substep2 as J
from softbody_tpu.ops.stencil import LatticeSpec as JLatticeSpec
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    lattice_state_to_numpy,
    planified_state_from_numpy,
)
from softbody_tpu_torch.engine import FusedLatticeBackend
from softbody_tpu_torch.ops import compiled
from softbody_tpu_torch.ops import farfield as F
from softbody_tpu_torch.ops.cuda import fused_substep2 as P
from softbody_tpu_torch.ops.farfield4 import (
    bucket_index,
    bucketed_far_delta_planes,
)
from softbody_tpu_torch.ops.planify import planified_frame_far
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_farfield import SPACING, hairpin
from test_torch_frame import HAIRPIN_CFG, HAIRPIN_FF
from torch_capture import no_host_reads
from torch_parity import consts_to_port, to_port
from torch_threads import two_torch_threads  # noqa: F401

W, H = 96, 4
JCFG = StaticConfig(**HAIRPIN_CFG)
CFG = tb.StaticConfig(**HAIRPIN_CFG)
JFF = JF.FarFieldSpec(**HAIRPIN_FF)
FF = F.FarFieldSpec(**HAIRPIN_FF)
JSPEC = JLatticeSpec(W, H, collision_stencil=2)
SPEC = LatticeSpec(W, H, collision_stencil=2)
N_SUB = 3


def _flat_negzero():
    """The fold's strip laid flat (no far pairs), every third column's vx
    and every third column's vy −0.0."""
    ls = j_make_lattice(W, H, SPACING, spring=0.0, damp=0.0,
                        yield_strain=10.0, strain_limit=100.0)
    vel = np.zeros((W, H, 2), np.float32)
    vel[::3, :, 0] = -0.0
    vel[1::3, :, 1] = -0.0
    return dataclasses.replace(ls, vel=jnp.asarray(vel))


SCENES = {"fold": hairpin, "flat -0.0": _flat_negzero}


@pytest.fixture(scope="module")
def jax_auto2():
    """JAX's ``fused_frame2_auto`` (interpret-mode K1, tile 8), compiled
    once without fusion and the algebraic simplifier, run from an empty
    list on each scene: ``{scene: (state arrays, stats, age,
    n_pairs)}``."""
    def packed(ls):
        hot, obs, immut, ec = J.pack_lattice2(ls, tile_w=8)
        return (hot, obs, immut, ec,
                JF.empty_far_list(hot.shape[1], hot.shape[2], JFF))

    consts, uin = PhysicsConstants.default(), UserInput.none()
    exe = J.fused_frame2_auto.lower(
        *packed(hairpin()), consts, uin, spec=JSPEC, cfg=JCFG, ffspec=JFF,
        tile_w=8, interpret=True, n_sub=N_SUB).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion,algsimp"})
    out = {}
    for name, build in SCENES.items():
        ls = build()
        hot, obs, fl, st = exe(*packed(ls), consts, uin)
        out[name] = (lattice_state_to_numpy(to_port(J.unpack_lattice2(
            hot, obs, ls))), np.asarray(st).tolist(), int(fl.age),
            int(fl.n_pairs))
    return out


def _port_auto2(ls, fl=None):
    tl = to_port(ls)
    hot, obs, immut, ec = P.pack_lattice2(tl)
    if fl is None:
        fl = F.empty_far_list(W, H, FF, device="cpu")
    hot, obs, fl, st = P.fused_frame2_auto(
        hot, obs, immut, ec, fl, consts_to_port(PhysicsConstants.default()),
        tb.UserInput(), SPEC, CFG, FF, n_sub=N_SUB)
    return lattice_state_to_numpy(P.unpack_lattice2(hot, obs, tl)), st, fl


def _bits_equal(got, ref):
    for k in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32), err_msg=k)
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        for f in ("alive", "target_length", "strain"):
            np.testing.assert_array_equal(eg[f], er[f], err_msg=f"{c} {f}")


def test_far_list_age_is_a_device_tensor():
    """The list's age: a 0-d int32 tensor on its device from every
    constructor (a host int given is put there), kept by ``replace``."""
    fl = F.empty_far_list(W, H, FF, device="cpu")
    assert fl.age.dtype == torch.int32 and fl.age.shape == ()
    assert int(fl.age) == 0
    fl5 = dataclasses.replace(fl, age=5)
    assert isinstance(fl5.age, torch.Tensor) and int(fl5.age) == 5
    hot, _obs, immut, _ec = P.pack_lattice2(to_port(hairpin()))
    rebuilt = F.rebuild_far_list_planes(hot[0], hot[1], immut[0] > 0, s=2,
                                        ff=FF, radius=4.0)
    assert rebuilt.age.device == hot.device and int(rebuilt.age) == 0
    cropped = F.crop_active(rebuilt, torch.tensor(3, dtype=torch.int32))
    assert int(cropped.n_pairs) == 3 and int(cropped.valid.sum()) == 3


@pytest.mark.parametrize("scene", list(SCENES))
def test_frame2_auto_matches_jax_bit_for_bit(jax_auto2, scene):
    """Three substeps from an empty list: the state, the stats, the
    list's age (a device tensor, through the rebuild) and its count equal
    JAX's; on the flat strip the lists stay empty and the −0.0
    velocities meet K1 beside zero far planes, as in JAX."""
    ref, ref_st, ref_age, ref_n = jax_auto2[scene]
    got, st, fl = _port_auto2(SCENES[scene]())
    _bits_equal(got, ref)
    assert st.dtype == torch.int32 and st.tolist() == ref_st
    assert isinstance(fl.age, torch.Tensor) and fl.age.dtype == torch.int32
    assert int(fl.age) == ref_age and int(fl.n_pairs) == ref_n
    if scene == "fold":
        assert ref_st[0] >= 2 and ref_n > 0, "a rebuild with far pairs"
    else:
        assert ref_n == 0 and ref_st[1] == 0, "the lists stay empty"


def test_backend_v3_far_stats_match_jax_over_three_frames():
    """``far_mode="v3"``: three frames of the fold through the port's and
    JAX's backends (both strict); ``far_stats()`` equal after the three,
    the port's accumulator an int32 device tensor between them, the state
    within the far apply's tolerances."""
    ls = hairpin()
    jbe = jbackends.FusedLatticeBackend(JSPEC, JCFG, farfield=JFF,
                                        tile_w=8, far_mode="v3",
                                        kernel_variants=())
    be = FusedLatticeBackend(SPEC, CFG, farfield=FF, far_mode="v3",
                             kernel_variants=(), device="cpu")
    consts = PhysicsConstants.default()
    jst, st = jbe.pack_state(ls), be.pack_state(to_port(ls))
    for _ in range(3):
        jst = jbe.step(jst, consts, UserInput.none())
        st = be.step(st, consts_to_port(consts), tb.UserInput())
        assert isinstance(be._stats_acc, torch.Tensor)
        assert be._stats_acc.dtype == torch.int32
    ref_stats = jbe.far_stats()
    assert be.far_stats() == ref_stats
    assert ref_stats["far_pairs"] > 0 and ref_stats["far_overflow"] == 0
    got = lattice_state_to_numpy(be.unpack_state(st))
    ref = lattice_state_to_numpy(to_port(jbe.unpack_state(jst)))
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# no host read in a frame

# the host-read guard: tests/torch_capture.py


# (frame, options): each of fused_frame4's modes, the triggered frames
GUARD_CASES = {
    "frame4 xla strict": ("frame4", dict(buckets=(16,))),
    "frame4 xla default": ("frame4", dict(kvar=P.DEFAULT_KVAR)),
    "frame4 activation": ("frame4", dict(buckets=(16,), activation=True)),
    "frame4 kernel detect": ("frame4", dict(detect_mode="kernel",
                                            kvar=("rsqrt", "rollgroup"))),
    "frame2_auto": ("frame2_auto", {}),
    "frame3_auto": ("frame3_auto", dict(buckets=(16,))),
    "backend v4": ("backend", {}),
    "backend v3": ("backend", dict(far_mode="v3")),
    "planified far": ("planified", {}),
}


def _case(kind, kw):
    """The case's frame as a thunk, its inputs made before (packing is
    not a frame)."""
    hot, obs, immut, ec = P.pack_lattice2(to_port(hairpin()))
    consts, uin = consts_to_port(PhysicsConstants.default()), tb.UserInput()
    fl = F.empty_far_list(W, H, FF, device="cpu")
    if kind == "frame4":
        return lambda: P.fused_frame4(hot, obs, immut, ec, consts, uin, SPEC,
                                      CFG, FF, band_impl="plain", **kw)
    if kind == "frame2_auto":
        return lambda: P.fused_frame2_auto(hot, obs, immut, ec, fl, consts,
                                           uin, SPEC, CFG, FF)
    if kind == "planified":
        from test_torch_planify_far import FOLD_CFG, FOLD_FF, _fold, _port_spec

        fields, spec, _aux = _fold()
        ps = planified_state_from_numpy(**fields, device="cpu")
        return lambda: planified_frame_far(
            ps, consts, uin, _port_spec(spec), tb.StaticConfig(**FOLD_CFG),
            F.FarFieldSpec(**FOLD_FF))
    if kind == "frame3_auto":
        side, trig = P.far3_carry_init(hot, immut, CFG, SPEC, FF)
        return lambda: P.fused_frame3_auto(hot, obs, immut, ec, fl, side,
                                           trig, consts, uin, SPEC, CFG, FF,
                                           **kw)
    be = FusedLatticeBackend(SPEC, CFG, farfield=FF, device="cpu", **kw)
    state = be.pack_state(to_port(hairpin()))

    def frames():
        st = state
        for _ in range(2):
            st = be.step(st, consts, uin)
        return st, be._stats_acc

    return frames


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_fused_frames_make_no_host_read(case):
    """The frame under :func:`no_host_reads` runs to its end and gives the
    bits it gives without the guard; the fold's far pairs are found."""
    run = _case(*GUARD_CASES[case])
    with no_host_reads():
        got = run()
    ref = _case(*GUARD_CASES[case])()
    ta, tb_ = list(compiled.tensors(got)), list(compiled.tensors(ref))
    assert len(ta) == len(tb_)
    for x, y in zip(ta, tb_):
        assert torch.equal(x, y)
    stats = ta[-1]
    assert stats.dtype == torch.int32 and int(stats[1]) > 0


def test_guard_catches_a_read():
    """The guard itself: a read of a tensor's value raises inside it."""
    t = torch.ones(3)
    with no_host_reads():
        with pytest.raises(AssertionError, match="host read"):
            bool(t.sum() > 0)
        with pytest.raises(AssertionError, match="host copy"):
            torch.tensor([1.0], device="cpu")
    assert bool(t.sum() > 0)


# ---------------------------------------------------------------------------
# the conditional bodies on the CPU


def test_device_if_and_switch_on_the_cpu():
    """``device_if`` runs its body where the predicate holds;
    ``device_switch`` the indexed branch; a warm-up runs every body; no
    host read is counted for CPU tensors."""
    ran = []
    reads = compiled.HOST_READS
    compiled.device_if(torch.tensor(True), lambda: ran.append("yes"))
    compiled.device_if(torch.tensor(False), lambda: ran.append("no"))
    compiled.device_switch(torch.tensor(2), [lambda i=i: ran.append(i)
                                             for i in range(3)])
    assert ran == ["yes", 2]
    compiled._TLS.warming = True
    try:
        compiled.device_if(torch.tensor(False), lambda: ran.append("warm"))
        compiled.device_switch(torch.tensor(0), [lambda i=i: ran.append(i)
                                                 for i in range(3)])
    finally:
        compiled._TLS.warming = False
    assert ran == ["yes", 2, "warm", 0, 1, 2]
    assert compiled.HOST_READS == reads


@pytest.mark.parametrize("n,want", [(0, 0), (1, 1), (16, 1), (17, 2),
                                    (64, 2), (99, 2)])
def test_bucket_index_is_jax_switch(n, want):
    """The switch's branch: 0 for an empty list, else 1 + the rung of the
    smallest bucket that holds the pairs (``max_pairs`` caps it)."""
    got = bucket_index(torch.tensor(n, dtype=torch.int32), FF, (16,))
    assert got.dtype == torch.int64 and int(got) == want


def test_empty_list_rung_writes_zeros():
    """The device rung of an empty list writes zero planes (JAX's branch
    0), a host count of 0 gives None; with pairs both give the same
    planes."""
    hot, _obs, immut, _ec = P.pack_lattice2(to_port(hairpin()))
    kw = dict(s=2, ff=FF, radius=4.0, dt=CFG.dt, ecoeff=1.0, friction=0.3,
              buckets=(16,))
    empty = F.empty_far_list(W, H, FF, device="cpu")
    z = bucketed_far_delta_planes(hot, immut[0], empty, None, **kw)
    assert z.shape == (5, W, H) and not bool(torch.signbit(z).any())
    assert bool((z == 0).all())
    assert bucketed_far_delta_planes(hot, immut[0], empty, 0, **kw) is None
    fl = F.rebuild_far_list_planes(hot[0], hot[1], immut[0] > 0, s=2, ff=FF,
                                   radius=4.0)
    n = int(fl.n_pairs)
    assert n > 0
    assert torch.equal(bucketed_far_delta_planes(hot, immut[0], fl, None,
                                                 **kw),
                       bucketed_far_delta_planes(hot, immut[0], fl, n, **kw))


def test_compiled_counterparts_run_the_functions_on_the_cpu():
    """Every ``*_jit`` of the fused frames is a ``Compiled`` that runs its
    function on CPU tensors (no capture), with the same bits."""
    jits = (P.fused_frame2_jit, P.fused_frame2_far_jit,
            P.fused_frame2_auto_jit, P.far3_carry_init_jit,
            P.fused_frame3_auto_jit, P.packed_far_motion2_jit,
            P.fused_frame4_jit)
    assert all(isinstance(j, compiled.Compiled) for j in jits)
    hot, obs, immut, ec = P.pack_lattice2(to_port(hairpin()))
    consts, uin = consts_to_port(PhysicsConstants.default()), tb.UserInput()
    before = P.fused_frame4_jit.stats()
    got = P.fused_frame4_jit(hot, obs, immut, ec, consts, uin, SPEC, CFG, FF,
                             buckets=(16,), band_impl="plain")
    ref = P.fused_frame4(hot, obs, immut, ec, consts, uin, SPEC, CFG, FF,
                         buckets=(16,), band_impl="plain")
    assert P.fused_frame4_jit.stats() == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    side, trig = P.far3_carry_init_jit(hot, immut, CFG, SPEC, FF)
    rs, rt = P.far3_carry_init(hot, immut, CFG, SPEC, FF)
    assert torch.equal(side, rs) and torch.equal(trig, rt)
