"""The port's far-armed planified frame and its activation schedule
(``ops/planify.py::planified_frame_far``,
``ops/farfield.py::rebuild_far_list_planes_active``) against the JAX
package's, on the folded strip of tests/test_planify.py:203-260: the
strip embedded flat, its planes then moved so that its left third lies
over its right third, approaching: in contact, and index-distant in the
embedding.

- The activation-scheduled rebuild (``ca``, ``cb``, ``valid``, counts,
  ``n_active``) bit-exact.
- ``planified_frame_far`` against one JAX frame run op by op once for the
  module and shared by the narrow and the mirror apply routes: pos atol
  5e-3, vel atol 5e-2 (tests/test_torch_frame.py: the far apply sums in
  another f32 order)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softbody_tpu import StaticConfig
from softbody_tpu.ops import farfield as jfarfield
from softbody_tpu.ops import planify as jplanify
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    planified_state_from_numpy,
    planified_state_to_numpy,
)
from softbody_tpu_torch.ops import farfield4
from softbody_tpu_torch.ops import planify as tplanify
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    rebuild_far_list_planes_active,
)
from softbody_tpu_torch.ops.stencil import LatticeSpec

from test_torch_planify import CONSTS, NX, NY, SP, UIN, _flat_strip
from torch_parity import consts_to_port, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

# the fold (tests/test_planify.py:235-262)
FOLD_CFG = dict(subticks=4, collision_mode="allpairs", particle_radius=4.0,
                force_mode="quantized")
FOLD_FF = dict(max_pairs=256, max_tile_pairs=64, skin=1.5 * SP, horizon=2)


@functools.lru_cache(maxsize=None)
def _fold():
    """The strip embedded flat, then its planes moved to the folded
    state: ``(numpy fields of the JAX PlanifiedState, spec, aux)``."""
    ps, spec, aux = jplanify.planify(_flat_strip(), collision_stencil=3,
                                     chunk_multiple=16)
    pos = np.asarray(_flat_strip().pos)
    pos2, vel2 = pos.copy(), np.zeros_like(pos)
    for i in range(NX // 3):
        for j in range(NY):
            p = i * NY + j
            pos2[p, 0] = pos[(NX - 1 - i) * NY + j, 0]
            pos2[p, 1] = 500.0 + j * SP + 16.0
            vel2[p, 1] = -40.0

    def planes(flat_xy):
        out = np.zeros((aux.width * aux.height, 2), np.float32)
        out[aux.cell_of] = flat_xy
        return out.reshape(aux.width, aux.height, 2)

    fields = planified_state_to_numpy(ps)
    fields["lat"]["pos"], fields["lat"]["vel"] = planes(pos2), planes(vel2)
    return fields, spec, aux


def _jax_ps(fields):
    from softbody_tpu.ops.stencil import EdgeClass, LatticeState

    def arr(v):
        # a fresh copy: the JAX frame donates its state
        return jnp.asarray(np.array(v))

    lat = fields["lat"]
    return jplanify.PlanifiedState(
        lat=LatticeState(
            pos=arr(lat["pos"]), vel=arr(lat["vel"]), acc=arr(lat["acc"]),
            alive=arr(lat["alive"]), pinned=arr(lat["pinned"]),
            edges=tuple(EdgeClass(**{k: arr(v) for k, v in e.items()})
                        for e in lat["edges"])),
        x=jplanify.ExceptionBeams(**{k: arr(v)
                                     for k, v in fields["x"].items()}))


def _port_spec(spec):
    return LatticeSpec(spec.width, spec.height,
                       collision_stencil=spec.collision_stencil,
                       edge_offsets=spec.edge_offsets)


def test_rebuild_active_matches_jax():
    """The activation-scheduled rebuild on the folded strip: the sorted
    list and ``n_active`` bit-exact."""
    fields, _spec, _aux = _fold()
    jl = _jax_ps(fields).lat
    cfg = StaticConfig(**FOLD_CFG)
    kw = dict(s=3, radius=4.0, dt=cfg.dt, R=2)
    jfl, jna = jfarfield.rebuild_far_list_planes_active(
        jl.pos[..., 0], jl.pos[..., 1], jl.alive, vx=jl.vel[..., 0],
        vy=jl.vel[..., 1], ff=jfarfield.FarFieldSpec(**FOLD_FF), **kw)
    tl = planified_state_from_numpy(**fields, device="cpu").lat
    tfl, tna = rebuild_far_list_planes_active(
        tl.pos[..., 0], tl.pos[..., 1], tl.alive, vx=tl.vel[..., 0],
        vy=tl.vel[..., 1], ff=FarFieldSpec(**FOLD_FF), **kw)
    for k in ("ca", "cb", "valid", "n_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tfl, k).numpy(),
                                      np.asarray(getattr(jfl, k)), err_msg=k)
    np.testing.assert_array_equal(tna.numpy(), np.asarray(jna))
    n_pairs = int(tfl.n_pairs)
    assert n_pairs > 0 and 0 < int(tna[0]) <= int(tna[1]) <= n_pairs


@functools.lru_cache(maxsize=None)
def _fold_reference():
    """One JAX ``planified_frame_far`` of the fold, run once for the module
    and op by op (``jax.disable_jit``: its scans as loops, its bucket
    switch on the concrete count; compiling the frame would cost ~28 s
    here): ``(numpy fields, stats)``."""
    fields, spec, _aux = _fold()
    with jax.disable_jit():
        ps, st = jplanify.planified_frame_far(
            _jax_ps(fields), CONSTS, UIN, spec, StaticConfig(**FOLD_CFG),
            jfarfield.FarFieldSpec(**FOLD_FF))
    return planified_state_to_numpy(ps), [int(v) for v in np.asarray(st)]


@pytest.mark.parametrize("route,max_pairs", [("narrow", 256),
                                             ("mirror", 512)])
def test_planified_frame_far_matches_jax(route, max_pairs):
    """The far frame through each apply route: JAX's default ladder on a
    256-pair list is the narrow route; on a 512-pair list its bucket is
    512, the mirror route.  The list holds every pair of the fold either
    way, so both compute JAX's frame in another f32 order.  The
    stencil-only frame misses the fold (the far field's teeth)."""
    fields, spec, _aux = _fold()
    ref, ref_st = _fold_reference()
    tspec, tcfg = _port_spec(spec), tb.StaticConfig(**FOLD_CFG)
    ff = FarFieldSpec(**dict(FOLD_FF, max_pairs=max_pairs))
    before = dict(farfield4.APPLY_ROUTES)
    ps, st = tplanify.planified_frame_far(
        planified_state_from_numpy(**fields, device="cpu"),
        consts_to_port(CONSTS), uin_to_port(UIN), tspec, tcfg, ff)
    ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
    assert ran[route] == tcfg.subticks and sum(ran.values()) == ran[route]
    assert st.tolist() == ref_st
    assert ref_st[1] > 0 and ref_st[2] == 0 and ref_st[3] <= ref_st[1]
    got = planified_state_to_numpy(ps)
    np.testing.assert_allclose(got["lat"]["pos"], ref["lat"]["pos"], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got["lat"]["vel"], ref["lat"]["vel"], rtol=0,
                               atol=5e-2)
    near = tplanify.planified_frame(
        planified_state_from_numpy(**fields, device="cpu"),
        consts_to_port(CONSTS), uin_to_port(UIN), tspec, tcfg)
    miss = np.abs(near.lat.pos.numpy() - ref["lat"]["pos"]).max()
    assert miss > 1.0, f"the stencil-only frame matched (max diff {miss})"


def test_planified_frames_jit_match_jax():
    """The compiled frames, which run their functions on CPU tensors:
    ``planified_frame_far_jit`` against the same JAX frame as above (its
    stats equal, the state within the same tolerances), on the mirror
    route; ``planified_frame_jit`` equal to ``planified_frame`` bit for
    bit."""
    fields, spec, _aux = _fold()
    ref, ref_st = _fold_reference()
    tspec, tcfg = _port_spec(spec), tb.StaticConfig(**FOLD_CFG)
    ff = FarFieldSpec(**dict(FOLD_FF, max_pairs=512))
    args = (consts_to_port(CONSTS), uin_to_port(UIN), tspec, tcfg)
    ps, st = tplanify.planified_frame_far_jit(
        planified_state_from_numpy(**fields, device="cpu"), *args, ff)
    assert st.dtype == torch.int32 and st.tolist() == ref_st
    got = planified_state_to_numpy(ps)
    np.testing.assert_allclose(got["lat"]["pos"], ref["lat"]["pos"], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got["lat"]["vel"], ref["lat"]["vel"], rtol=0,
                               atol=5e-2)
    near = [f(planified_state_from_numpy(**fields, device="cpu"), *args)
            for f in (tplanify.planified_frame_jit, tplanify.planified_frame)]
    for a, b in zip(near[0].lat.pos, near[1].lat.pos):
        assert torch.equal(a, b)
