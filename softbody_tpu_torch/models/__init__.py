"""Scene builders (port of ``softbody_tpu.models``): dense lattices and
the general engine's scene families."""

from .lattice import add_rectangle, lattice_arrays, merge_scenes  # noqa: F401
from .lattice_dense import (  # noqa: F401
    cloth_lattice,
    lattice_to_simstate,
    make_lattice,
    tearing_cloth_lattice,
)
from .scenes import (  # noqa: F401
    SCENES,
    blob,
    cloth,
    default_scene,
    multi_blob,
    self_colliding_cloth,
    tearing_cloth,
)
