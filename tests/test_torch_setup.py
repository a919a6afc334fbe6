"""The PyTorch port's scaffolding against the JAX package: it imports
without JAX, builds the same scenes, converts state both ways, and packs
the same consts vector."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softbody_tpu import PhysicsConstants, StaticConfig, UserInput
from softbody_tpu.models import cloth_lattice as j_cloth_lattice
from softbody_tpu.models import make_lattice as j_make_lattice
from softbody_tpu.models import tearing_cloth_lattice as j_tearing
from softbody_tpu.ops.pallas.fused_substep import _consts_vector
import softbody_tpu_torch as tb
from softbody_tpu_torch.convert import (
    lattice_state_from_numpy,
    lattice_state_to_numpy,
)
from softbody_tpu_torch.models import cloth_lattice, make_lattice
from softbody_tpu_torch.models import scenes, tearing_cloth_lattice

from torch_parity import consts_to_port, random_state, uin_to_port
from torch_threads import two_torch_threads  # noqa: F401

PORT_MODULES = (
    "softbody_tpu_torch",
    "softbody_tpu_torch.config",
    "softbody_tpu_torch.convert",
    "softbody_tpu_torch.models",
    "softbody_tpu_torch.ops.stencil",
    "softbody_tpu_torch.ops.farfield",
    "softbody_tpu_torch.ops.farfield4",
    "softbody_tpu_torch.ops.cuda.fused_substep2",
    "softbody_tpu_torch.ops.cuda.band_detect",
    "softbody_tpu_torch.ops.cuda.collide_stencil",
    "softbody_tpu_torch.ops.cuda.fused_substep",
    "softbody_tpu_torch.ops.cuda.recmirror",
    "softbody_tpu_torch.engine",
    "softbody_tpu_torch.engine.backends",
    "softbody_tpu_torch.engine.engine",
    "softbody_tpu_torch.engine.lock",
    "softbody_tpu_torch.engine.protocol",
    "softbody_tpu_torch.engine.worker",
    "softbody_tpu_torch.snapshot",
    "softbody_tpu_torch.state",
    "softbody_tpu_torch.models.lattice",
    "softbody_tpu_torch.models.scenes",
    "softbody_tpu_torch.ops.incidence",
    "softbody_tpu_torch.ops.forces",
    "softbody_tpu_torch.ops.integrate",
    "softbody_tpu_torch.ops.collisions",
    "softbody_tpu_torch.ops.step",
    "softbody_tpu_torch.ops.planify",
    "softbody_tpu_torch.ops.directed",
    "softbody_tpu_torch.ops.compiled",
    "softbody_tpu_torch.cli",
    "softbody_tpu_torch.viz",
    "softbody_tpu_torch.tui",
    "softbody_tpu_torch.mapping",
    "softbody_tpu_torch.editor",
    "softbody_tpu_torch.utils",
    "softbody_tpu_torch.utils.png",
    "softbody_tpu_torch.utils.profiling",
    "softbody_tpu_torch.parallel",
    "softbody_tpu_torch.parallel.mesh",
    "softbody_tpu_torch.parallel.batched",
    "softbody_tpu_torch.parallel.spatial",
    "softbody_tpu_torch.parallel.lattice_spatial",
    "softbody_tpu_torch.parallel.fused_spatial",
    "softbody_tpu_torch.parallel.fused_spatial2",
    "chip_smoke",
    "kernel_variants",
)


def test_port_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'softbody_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr


def _assert_arrays_equal(got: dict, ref: dict):
    for k in ("pos", "vel", "acc", "alive", "pinned"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for c, (eg, er) in enumerate(zip(got["edges"], ref["edges"])):
        for k in er:
            assert eg[k].dtype == er[k].dtype, (c, k)
            np.testing.assert_array_equal(eg[k], er[k], err_msg=f"{c} {k}")


def test_tearing_cloth_lattice_matches():
    kw = dict(n_particles=32 * 32, fall_speed=2.5, slits=2,
              strain_limit=0.22, yield_strain=0.18)
    js, jspec, jcfg, jconsts = j_tearing(**kw)
    ts, tspec, tcfg, tconsts = tearing_cloth_lattice(**kw, device="cpu")
    _assert_arrays_equal(lattice_state_to_numpy(ts),
                         lattice_state_to_numpy(js))
    assert (tspec.width, tspec.height, tspec.collision_stencil) == (
        jspec.width, jspec.height, jspec.collision_stencil)
    for f in ("bounds_size", "particle_radius", "subticks",
              "collision_mode", "force_mode"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tconsts == consts_to_port(jconsts)


def test_make_and_cloth_lattice_match():
    pinned = np.zeros((12, 9), bool)
    pinned[:, -1] = True
    kw = dict(spacing=7.5, spring=80.0, damp=3.0, diagonals=False,
              pinned_mask=pinned)
    _assert_arrays_equal(
        lattice_state_to_numpy(make_lattice(12, 9, **kw, device="cpu")),
        lattice_state_to_numpy(j_make_lattice(12, 9, **kw)))
    ts, tspec, tcfg = cloth_lattice(w=16, h=12, spacing=15.0, pin_top=True,
                                  device="cpu")
    js, jspec, jcfg = j_cloth_lattice(w=16, h=12, spacing=15.0, pin_top=True)
    _assert_arrays_equal(lattice_state_to_numpy(ts),
                         lattice_state_to_numpy(js))
    assert tcfg.particle_radius == jcfg.particle_radius


def test_convert_round_trip():
    arrays = random_state(9, 7, seed=3)
    st = lattice_state_from_numpy(**arrays, device="cpu")
    _assert_arrays_equal(lattice_state_to_numpy(st), arrays)


@pytest.mark.parametrize("mouse", [False, True])
def test_consts_vector_matches(mouse):
    consts = PhysicsConstants.default()
    consts.gravity = jnp.asarray([0.3, -0.123456], jnp.float32)
    consts.elasticity = jnp.float32(0.37)
    uin = UserInput(
        user_strength=jnp.float32(1.7), mouse_active=jnp.asarray(mouse),
        mouse_pos=jnp.asarray([400.5, 321.25], jnp.float32),
        mouse_vel=jnp.asarray([-3.0, 2.5], jnp.float32),
        applied_force=jnp.asarray([0.1, -0.2], jnp.float32))
    cfg = StaticConfig(subticks=48, particle_radius=3.3,
                       collision_mode="allpairs")
    ref = np.asarray(_consts_vector(consts, uin, cfg, 77))
    got = tb.consts_vector(consts_to_port(consts), uin_to_port(uin),
                           tb.StaticConfig(subticks=48, particle_radius=3.3),
                           77).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


GENERAL_ENTRY_POINTS = {
    "state_from_numpy": lambda: tb.state_from_numpy(np.zeros((3, 2))),
    "empty_state": lambda: tb.empty_state(3, 2),
    "sim_state_from_numpy": lambda: tb.sim_state_from_numpy(
        **tb.sim_state_to_numpy(tb.empty_state(3, 2, device="cpu"))),
    "default_scene": lambda: scenes.default_scene(),
    "cloth": lambda: scenes.cloth(4, 4),
    "blob": lambda: scenes.blob(radius=60.0),
    "self_colliding_cloth": lambda: scenes.self_colliding_cloth(64),
    "multi_blob": lambda: scenes.multi_blob(n_blobs=1),
    "tearing_cloth": lambda: scenes.tearing_cloth(64),
}


@pytest.mark.parametrize("name", sorted(GENERAL_ENTRY_POINTS))
def test_general_entry_points_default_to_cuda(name, monkeypatch):
    """The general engine's state builders and scenes run on the card
    unless told otherwise, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GENERAL_ENTRY_POINTS[name]()
