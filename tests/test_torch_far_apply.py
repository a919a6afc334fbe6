"""The far apply's pair step (K8, ``ops/cuda/far_apply.py``) on the CPU:
its destination order and the plain versions of its two kernels.

K8b sums each destination chunk's side rows in the order that
``dest_order`` builds once per rebuild from the full list.  That order
plus an ordered sum must equal ``stencil.index_sum`` with ``keep=``, the
sum the other routes make, bit for bit: with heavy duplicates, with
empty slots, with the list cropped to every rung and cut to an active
prefix.  K8 as a whole (the plain K8a and K8b) must agree with the
routes the CPU keeps within the apply's tolerance, and the CPU must keep
those routes.  The kernels' sources are held against these plain
versions bit for bit in ``test_torch_kernel_emulation.py`` and on the
card in ``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from softbody_tpu_torch.models.lattice_dense import folded_strip_lattice
from softbody_tpu_torch.ops import farfield4
from softbody_tpu_torch.ops.cuda import far_apply
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    crop_active,
    crop_far_list,
    far_scatter_contributions,
    rebuild_far_list_planes,
)
from torch_threads import two_torch_threads  # noqa: F401

from kernel_cases import far_list as kernel_list

# a 40 x 32 grid of 4 x 4 chunks (the apply's padded grid 160 x 128)
W, H = 160, 128
CWY = H // 4
CHUNKS = (W // 4) * CWY


def _list(k, n_valid, n_ids, seed, hot=0.0):
    """A list of capacity ``k`` whose first ``n_valid`` slots are valid,
    its chunk ids drawn from ``n_ids`` chunks (a share ``hot`` of the
    sides on one chunk: heavy duplicates), the empty slots naming the
    grid's last chunk, as the rebuild leaves them."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(CHUNKS, n_ids, replace=False)
    ca = ids[rng.integers(0, n_ids, k)]
    cb = ids[rng.integers(0, n_ids, k)]
    ca[rng.random(k) < hot] = ids[0]
    cb[rng.random(k) < hot] = ids[0]
    ca, cb = np.minimum(ca, cb), np.maximum(ca, cb)
    valid = np.arange(k) < n_valid
    ca[~valid] = CHUNKS - 1
    cb[~valid] = CHUNKS - 1
    return (torch.from_numpy(ca), torch.from_numpy(cb),
            torch.from_numpy(valid))


def _rows(k, seed):
    """Side rows ``[2k, 80]`` over ten orders of magnitude, so that the
    order of a sum shows in its last bits."""
    rng = np.random.default_rng(seed + 1000)
    rows = rng.normal(0, 1, (2 * k, 80)) * np.exp(rng.normal(0, 5,
                                                             (2 * k, 80)))
    return torch.from_numpy(rows.astype(np.float32))


def _index_sum_planes(rows, ca, cb, valid):
    """The other routes' sum: each row's 16 cells scatter-added in
    source order (``index_sum``), the sides of invalid slots left out."""
    ids = torch.cat([ca, cb])
    contrib = rows.reshape(-1, 5, 16)
    return far_scatter_contributions(contrib, ids // CWY, ids % CWY, c=4,
                                     wp=W, hp=H,
                                     valid=torch.cat([valid, valid]))


def _reversed_runs(order):
    """The order with each chunk's run reversed."""
    sides = order.sides.clone()
    off = order.offsets.tolist()
    for a, b in zip(off[:-1], off[1:]):
        sides[a:b] = order.sides[a:b].flip(0)
    return dataclasses.replace(order, sides=sides)


def _bits(t):
    return t.contiguous().view(torch.int32)


# (capacity, valid slots, distinct chunks, share on one chunk)
LISTS = {
    "duplicates": (512, 400, 6, 0.5),
    "spread": (512, 300, 400, 0.0),
    "empty_slots": (256, 37, 20, 0.2),
    "full": (128, 128, 10, 0.3),
    "none_valid": (64, 0, 5, 0.0),
}


@pytest.mark.parametrize("case", list(LISTS))
def test_order_sum_equals_index_sum(case):
    """One order built from the full list, then the ordered sum (K8b's
    plain version) of every rung's crop and of active prefixes cut at
    several ``n_act``: each equal to ``index_sum`` with ``keep=`` bit for
    bit; the reversed order differs (the data shows the order)."""
    k_full, n_valid, n_ids, hot = LISTS[case]
    ca, cb, valid = _list(k_full, n_valid, n_ids, seed=len(case), hot=hot)
    order = far_apply.dest_order(ca, cb, valid, CHUNKS)
    assert order.capacity == k_full
    assert int(order.offsets[-1]) == 2 * n_valid
    reordered = False
    for k in sorted({k_full // 4, k_full // 2, k_full}):
        for n_act in sorted({0, 1, n_valid // 3, n_valid, k_full}):
            v = valid & (torch.arange(k_full) < n_act)
            vk = v[:k]
            rows = _rows(k, seed=k + n_act)
            want = _index_sum_planes(rows, ca[:k], cb[:k], vk)
            got = far_apply.far_accumulate_plain(
                rows, order, vk, torch.empty((5, W, H)), h=H)
            assert torch.equal(_bits(got), _bits(want)), (k, n_act)
            # the same sums in the reverse list order
            other = far_apply.far_accumulate_plain(
                rows, _reversed_runs(order), vk, torch.empty((5, W, H)),
                h=H)
            reordered |= not torch.equal(_bits(other), _bits(want))
    assert reordered or case in ("spread", "none_valid")


@pytest.mark.parametrize("k", [64, 128, 256, 512])
def test_one_order_serves_every_crop(k):
    """The order of the full list and the order of the list cropped to
    ``k`` give the same sums at ``k`` (a crop only masks entries)."""
    ca, cb, valid = _list(512, 300, 12, seed=k, hot=0.3)
    full = far_apply.dest_order(ca, cb, valid, CHUNKS)
    own = far_apply.dest_order(ca[:k], cb[:k], valid[:k], CHUNKS)
    rows = _rows(k, seed=k)
    out = [far_apply.far_accumulate_plain(rows, o, valid[:k],
                                          torch.empty((5, W, H)), h=H)
           for o in (full, own)]
    assert torch.equal(_bits(out[0]), _bits(out[1]))
    assert torch.equal(_bits(out[0]), _bits(_index_sum_planes(
        rows, ca[:k], cb[:k], valid[:k])))


def test_order_into_buffers_and_crop_of_out():
    """``dest_order(into=)`` fills given buffers with the same order, and
    a smaller ``out`` gets the grid's corner."""
    ca, cb, valid = _list(256, 200, 30, seed=3, hot=0.1)
    order = far_apply.dest_order(ca, cb, valid, CHUNKS)
    buf = far_apply.empty_order(256, CHUNKS, "cpu")
    assert far_apply.dest_order(ca, cb, valid, CHUNKS, into=buf) is buf
    assert torch.equal(buf.sides, order.sides)
    assert torch.equal(buf.offsets, order.offsets)
    with pytest.raises(ValueError):
        far_apply.dest_order(ca[:128], cb[:128], valid[:128], CHUNKS,
                             into=buf)
    rows = _rows(256, seed=3)
    full = far_apply.far_accumulate_plain(rows, order, valid,
                                          torch.empty((5, W, H)), h=H)
    corner = far_apply.far_accumulate_call(rows, order, valid,
                                           torch.empty((5, W - 7, H - 5)),
                                           h=H)
    assert torch.equal(corner, full[:, :W - 7, :H - 5])


def _strip(n_pairs_cap=512):
    """The folded strip (layers in contact across index-distant chunks),
    its list rebuilt on the CPU, and the apply's keywords."""
    ls = folded_strip_lattice(64, 8, device="cpu")
    px, py = ls.pos[..., 0].contiguous(), ls.pos[..., 1].contiguous()
    vx, vy = ls.vel[..., 0].contiguous(), ls.vel[..., 1].contiguous()
    ff = FarFieldSpec(max_pairs=n_pairs_cap, max_tile_pairs=64, skin=4.0,
                      horizon=8)
    radius = 4.0
    fl = rebuild_far_list_planes(px, py, ls.alive, s=2, ff=ff,
                                 radius=radius, vx=vx, vy=vy, dt=0.01)
    hot = torch.stack([px, py, vx, vy])
    kw = dict(s=2, ff=ff, radius=radius, dt=0.01, ecoeff=0.75,
              friction=0.1)
    return hot, ls.alive.to(torch.float32), fl, kw


def test_k8_plain_matches_the_cpu_routes():
    """K8 through its plain versions (the windows read from the planes,
    the ordered sums) against the narrow and the mirror route on the
    folded strip, within the apply's tolerance (their side sums add the
    16 terms in torch's order); a list with no valid slot gives zeros;
    and the CPU's bucketed apply counts narrow and mirror, never K8."""
    hot, alive_f, fl, kw = _strip()
    n = int(fl.n_pairs)
    assert n > 0
    w, h = alive_f.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, kw["ff"])
    planes = (hot[0], hot[1], hot[2], hot[3], alive_f)
    order = far_apply.dest_order(fl.ca, fl.cb, fl.valid, (wp // 4) * (hp // 4))
    got = farfield4.far_delta_planes_kernel(planes, fl, order, w=wp, h=hp,
                                            **kw)[:, :w, :h]
    assert float(got.abs().max()) > 0
    before = dict(farfield4.APPLY_ROUTES)
    for narrow_max in (farfield4.NARROW_MAX, 0):
        ref = farfield4.bucketed_far_delta_planes(
            hot, alive_f, fl, n, buckets=(256,), narrow_max=narrow_max,
            **kw)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        sw = farfield4.bucketed_far_delta_planes(
            hot, alive_f, fl, None, buckets=(256,), narrow_max=narrow_max,
            order=farfield4.BlockOrder(fl, same_list=True), **kw)
        assert torch.equal(sw, ref)
    ran = {k: v - before[k] for k, v in farfield4.APPLY_ROUTES.items()}
    assert ran == {"narrow": 2, "mirror": 2, "kernel": 0}
    none = dataclasses.replace(fl, valid=torch.zeros_like(fl.valid))
    zero = farfield4.far_delta_planes_kernel(
        planes, none, far_apply.dest_order(none.ca, none.cb, none.valid,
                                           order.offsets.shape[0] - 1),
        w=wp, h=hp, **kw)
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("n_act", [0, 5, 40])
def test_k8_active_prefix_with_the_full_lists_order(n_act):
    """An active prefix through K8 with the order of the full list equals
    K8 with the prefix's own order bit for bit, and the CPU route within
    the tolerance."""
    hot, alive_f, fl, kw = _strip()
    w, h = alive_f.shape
    _cwx, _cwy, wp, hp = _chunk_dims(w, h, kw["ff"])
    planes = (hot[0], hot[1], hot[2], hot[3], alive_f)
    chunks = (wp // 4) * (hp // 4)
    part = crop_active(fl, n_act)
    k = 256
    flk = crop_far_list(part, k)
    outs = [farfield4.far_delta_planes_kernel(
        planes, flk, far_apply.dest_order(o.ca, o.cb, o.valid, chunks),
        w=wp, h=hp, **kw) for o in (fl, flk)]
    assert torch.equal(outs[0], outs[1])
    ref = farfield4.bucketed_far_delta_planes(hot, alive_f, part, k,
                                              buckets=(k,), **kw)
    if n_act == 0:
        assert ref is None or torch.equal(ref, torch.zeros_like(ref))
        assert torch.equal(outs[0], torch.zeros_like(outs[0]))
    else:
        torch.testing.assert_close(outs[0][:, :w, :h], ref, rtol=0,
                                   atol=1e-5)


def test_kernel_route_only_on_the_cards_default_layout():
    """K8 takes CUDA tensors with the default lane blocks; an explicit
    lane block and every CPU call keep the record-table routes."""
    assert farfield4.kernel_route("cuda")
    assert farfield4.kernel_route("cuda", 32, 32)
    assert not farfield4.kernel_route("cuda", 64)
    assert not farfield4.kernel_route("cuda", 32, 128)
    assert not farfield4.kernel_route("cpu")
    assert not farfield4.kernel_route("cpu", 32, None)


def test_block_order_builds_once():
    """A block's order is built at the first apply that takes it and
    kept: in that apply's rung for one shared list, before it otherwise."""
    _hot, _alive_f, fl, _kw = _strip()
    same = farfield4.BlockOrder(fl, same_list=True)
    order, build = same.take(64, 16)
    assert build is not None
    build()
    again, none = same.take(64, 16)
    assert again is order and none is None
    with pytest.raises(ValueError):
        same.take(128, 16)
    want = far_apply.dest_order(fl.ca, fl.cb, fl.valid, 16 * 4)
    assert torch.equal(order.sides, want.sides)
    prefix = farfield4.BlockOrder(fl)
    order, build = prefix.take(64, 16)
    assert build is None and torch.equal(order.offsets, want.offsets)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """The checks before K8's pointers reach a kernel: an output past the
    order's grid, a grid height off the chunk, rows of another rung,
    slots that are not bool, planes of two shapes."""
    ca, cb, valid = _list(64, 40, 10, seed=9)
    order = far_apply.dest_order(ca, cb, valid, CHUNKS)
    rows = _rows(64, seed=9)
    for out, h, v, r in ((torch.empty((5, W + 4, H)), H, valid, rows),
                         (torch.empty((5, W, H)), H + 2, valid, rows),
                         (torch.empty((5, W, H)), H, valid, rows[:64]),
                         (torch.empty((5, W, H)), H, valid.int(), rows)):
        with pytest.raises(ValueError):
            far_apply.far_accumulate_call(r, order, v, out, h=h)
    fl = kernel_list(ca, cb, valid)
    planes = [torch.zeros((W, H))] * 4 + [torch.zeros((W, H - 1))]
    with pytest.raises(ValueError):
        far_apply.far_pairs_call(planes, fl, s=2, ff=FarFieldSpec(),
                                 radius=1.0, dt=0.01, ecoeff=0.5,
                                 friction=0.1, h=H, world_h=H)
