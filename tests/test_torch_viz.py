"""The port's rasterizer (``softbody_tpu_torch/viz.py``) against the JAX
package's (``softbody_tpu/viz.py``) on the same scene: more than one
particle chunk (n > 1024) and beam chunk (m > 128), so later chunks
overwrite earlier ones, with dead particles and beams, trails, and
non-finite and far-off positions.  Float images agree within 1e-6 (the
mean of a chunk's beam colours is summed in another order than JAX's
``einsum``: an ulp at most); ``render_packet``'s uint8 images are
equal."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu import viz as jviz
from softbody_tpu_torch import viz as tviz


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, n=1500, m=700):
    """Host arrays of a packet: 1500 particles (two particle chunks), 700
    beams (six beam chunks), crowded in the middle so chunks overlap,
    10% dead of each, beams with long and zero-length spans, a NaN, an
    inf and a 1e30 coordinate."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20, 1020, (n, 2)).astype(np.float32)
    pos[:600] = rng.uniform(400, 600, (600, 2))
    pos[1490] = (np.nan, 500.0)
    pos[1491] = (500.0, np.inf)
    pos[1492] = (1e30, 300.0)
    a = rng.integers(0, n, m)
    b = np.clip(a + rng.integers(-3, 4, m), 0, n - 1)
    a[:200], b[:200] = rng.integers(0, 600, 200), rng.integers(0, 600, 200)
    a[200:203], b[200:203] = 1490, (0, 1, 2)
    a[203:206], b[203:206] = 1492, (3, 4, 5)
    b[206] = a[206]
    return types.SimpleNamespace(
        pos=pos, particle_alive=rng.random(n) > 0.1,
        beam_a=a.astype(np.int32), beam_b=b.astype(np.int32),
        beam_alive=rng.random(m) > 0.1,
        beam_strain=rng.normal(0, 1, m).astype(np.float32),
        beam_stress=rng.normal(0, 1, m).astype(np.float32))


FIELDS = ("pos", "particle_alive", "beam_a", "beam_b", "beam_alive",
          "beam_strain", "beam_stress")
CASES = {
    "res64": dict(resolution=64, particle_radius=10.0),
    "res97-r3-trails": dict(resolution=97, particle_radius=3.0, trails=True),
    "res200-r25": dict(resolution=200, particle_radius=25.0),
}


@pytest.fixture(scope="module")
def jax_images():
    """JAX's float images of each case, rendered once."""
    pkt = _scene()
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        prev = (np.random.default_rng(1).random(
            (kw["resolution"],) * 2 + (3,)).astype(np.float32)
            if kw.pop("trails", False) else None)
        img = jviz.render_frame(
            *(jnp.asarray(getattr(pkt, f)) for f in FIELDS),
            prev_frame=None if prev is None else jnp.asarray(prev), **kw)
        out[name] = (np.asarray(img), prev, kw)
    return out


def _port_frame(pkt, prev, kw):
    t = {f: torch.as_tensor(getattr(pkt, f)) for f in FIELDS}
    t["beam_a"], t["beam_b"] = t["beam_a"].long(), t["beam_b"].long()
    return tviz.render_frame(
        *(t[f] for f in FIELDS),
        prev_frame=None if prev is None else torch.as_tensor(prev), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_render_frame_matches_jax(case, jax_images):
    ref, prev, kw = jax_images[case]
    got = _port_frame(_scene(), prev, kw)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape
    # drawn pixels: some of each kind, so the chunks overwrite
    assert (ref.sum(-1) > 0).sum() > 1000
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_render_frame_passes_split_at_chunks(monkeypatch, jax_images):
    """Many small passes (bounded candidates) give the image of one pass
    bit for bit: a pass holds whole chunks."""
    ref, prev, kw = jax_images["res200-r25"]
    one = _port_frame(_scene(), prev, kw)
    monkeypatch.setattr(tviz, "_MAX_CANDIDATES", 2000)
    monkeypatch.setattr(tviz, "_MAX_PRIMITIVES", 300)
    many = _port_frame(_scene(), prev, kw)
    assert torch.equal(one, many)


def test_render_packet_uint8_equal():
    pkt = _scene(seed=3)
    ref = jviz.render_packet(pkt, resolution=64, particle_radius=10.0)
    got = tviz.render_packet(pkt, resolution=64, particle_radius=10.0,
                             device="cpu")
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, ref)


def test_render_packet_needs_a_device_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviz.render_packet(_scene(seed=3), resolution=16)
