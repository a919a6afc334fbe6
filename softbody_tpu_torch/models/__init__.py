"""Scene builders (port of ``softbody_tpu.models``, dense lattices)."""

from .lattice_dense import (  # noqa: F401
    cloth_lattice,
    make_lattice,
    tearing_cloth_lattice,
)
