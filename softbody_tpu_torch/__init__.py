"""softbody_tpu_torch — the PyTorch + CUDA port of ``softbody_tpu``.

The dense-lattice tearing-cloth path with far-field self-collision, for
one NVIDIA H100: plain torch ops around two hand-written Hopper kernels
(``csrc/``), the fused lattice substep (K1) and the far-field band
detection (K2).  Every module mirrors the JAX package's module of the
same name; the JAX package is the reference the port is tested against.
This package never imports JAX.
"""

from .config import (  # noqa: F401
    PhysicsConstants,
    StaticConfig,
    UserInput,
    consts_vector,
)
from .convert import (  # noqa: F401
    constants_from_numpy,
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    user_input_from_numpy,
)

__version__ = "0.1.0"
