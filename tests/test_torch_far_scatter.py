"""The far apply's fixed-order scatter and its padding chunks.

``stencil.index_sum`` sums each destination's rows in ascending source
order from +0.0, which is what the CPU's ``index_add_`` does; on the
card it is what makes the far apply reproducible run to run and equal
to the CPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The candidate list's empty slots hold the last chunk id of the rebuild's
tile-padded chunk grid, which lies past a plane whose width is not a
multiple of the tile.  JAX's gather clamps such a row and the masked
slot adds nothing; torch's indexing raises.  So the planified far frame
applies on the padded width: there both apply routes equal the windowed
gather (``farfield.far_collision_terms``)."""

import numpy as np
import pytest
import torch

from softbody_tpu_torch.ops import farfield4
from softbody_tpu_torch.ops.farfield import (
    FarFieldSpec,
    _chunk_dims,
    crop_far_list,
    far_collision_terms,
    rebuild_far_list_planes,
)
from softbody_tpu_torch.ops.stencil import index_sum


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", [1, 3, 5, 32, 640])
def test_index_sum_is_index_add_in_source_order(width):
    """Heavy duplicates (up to ~2000 rows on one index, values over ten
    orders of magnitude, so the order shows in the last bits): equal to
    ``index_add_`` on zeros and to a sequential sum, bit for bit."""
    rng = np.random.default_rng(width)
    n_src, n_dst = 20_000 // width + 64, 11
    idx = rng.integers(0, n_dst, n_src)
    idx[:40] = 3
    src = (rng.normal(0, 1, (n_src, width))
           * np.exp(rng.normal(0, 5, (n_src, width)))).astype(np.float32)
    got = index_sum(torch.from_numpy(idx), torch.from_numpy(src), n_dst)
    ref = torch.zeros((n_dst, width)).index_add_(
        0, torch.from_numpy(idx), torch.from_numpy(src))
    seq = np.zeros((n_dst, width), np.float32)
    np.add.at(seq, idx, src)
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), seq)
    # rows of +-0.0 left out through ``keep`` change no sum, not even the
    # sign of a zero (the far apply's empty slots)
    zero = rng.random(n_src) < 0.3
    src[zero] = np.where(rng.random((int(zero.sum()), width)) < 0.5, 0.0,
                         -0.0)
    src[:8] = -0.0
    idx[zero] = 3
    full = torch.zeros((n_dst, width)).index_add_(
        0, torch.from_numpy(idx), torch.from_numpy(src))
    kept = index_sum(torch.from_numpy(idx), torch.from_numpy(src), n_dst,
                     keep=torch.from_numpy(~zero))
    assert torch.equal(kept, full)
    assert torch.equal(torch.signbit(kept), torch.signbit(full))


def test_far_apply_ignores_padding_chunks():
    """A 44 × 16 plane (the tile is 16: the rebuild's chunk grid has a
    column of padding chunks past x = 44), folded so that far pairs
    overlap: the bucket's empty slots name a padding chunk, and the
    narrow and the mirror routes on the padded width equal the windowed
    gather (on the plane's own width they raised)."""
    w, h, s = 44, 16, 1
    ff = FarFieldSpec(max_pairs=512, max_tile_pairs=64, skin=4.0,
                      horizon=8)
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    pos = np.stack([xs * 2.0 + 100.0, ys * 2.0 + 100.0], -1)
    pos = pos + rng.uniform(-1.5, 1.5, pos.shape)
    pos[xs >= 40] -= (30.0, 0.0)     # fold the last columns back
    px, py = (torch.from_numpy(pos[..., i].astype(np.float32))
              for i in range(2))
    vx, vy = (torch.from_numpy(rng.normal(0, 3, (w, h)).astype(np.float32))
              for _ in range(2))
    alive = torch.from_numpy(rng.random((w, h)) > 0.05)
    kw = dict(s=s, ff=ff, radius=1.2)
    fl = rebuild_far_list_planes(px, py, alive, vx=vx, vy=vy, dt=1e-3, **kw)
    n_pairs, overflow = fl.counts()
    assert overflow == 0 and 0 < n_pairs < 256
    empty = crop_far_list(fl, 256).ca[n_pairs:]
    assert bool((empty // (h // ff.chunk) >= w // ff.chunk).all())
    apply_kw = dict(dt=1e-3, ecoeff=0.75, friction=0.5, **kw)
    ref = torch.stack(far_collision_terms(px, py, vx, vy, alive, fl,
                                          world_h=32, **apply_kw))
    assert bool((ref != 0).any())
    wp = _chunk_dims(w, h, ff)[2]
    routes = dict(farfield4.APPLY_ROUTES)
    for buckets in ((256, 512), (1024,)):     # narrow, then mirror
        got = farfield4.bucketed_far_delta_from_fn(
            lambda: torch.stack([px, py, vx, vy, alive.to(torch.float32)]),
            fl, n_pairs, w=wp, h=h, buckets=buckets, **apply_kw)[:, :w]
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert farfield4.APPLY_ROUTES["narrow"] == routes["narrow"] + 1
    assert farfield4.APPLY_ROUTES["mirror"] == routes["mirror"] + 1
