"""softbody_tpu_torch — the PyTorch + CUDA port of ``softbody_tpu``.

For one NVIDIA H100: the dense-lattice paths (the fused tearing-cloth
frame with far-field self-collision, the stencil backend, the per-edge
fused frame) and the general gather engine (``state``, ``ops/step``),
as plain torch ops around hand-written Hopper kernels (``csrc/``, K1–K7).
Every module mirrors the JAX package's module of the same name; the JAX
package is the reference the port is tested against.  This package never
imports JAX.

The exports match the JAX package's.  ``frame`` runs a frame op by op;
``frame_jit``, the counterpart of JAX's jitted and donating frame, runs
it on the card as one captured CUDA graph per key (``ops/compiled.py``)
and as ``frame`` on the CPU.  ``python -m softbody_tpu_torch`` is the
CLI (``cli.py``).
"""

from .config import (  # noqa: F401
    DEFAULT_BOUNDS_SIZE,
    DEFAULT_PARTICLE_RADIUS,
    DEFAULT_SUBTICKS,
    PhysicsConstants,
    StaticConfig,
    UserInput,
    consts_vector,
)
from .convert import (  # noqa: F401
    constants_from_numpy,
    lattice_state_from_numpy,
    lattice_state_to_numpy,
    planified_state_from_numpy,
    planified_state_to_numpy,
    sim_state_from_numpy,
    sim_state_to_numpy,
    user_input_from_numpy,
)
from .ops import frame, frame_jit, substep  # noqa: F401
from .state import SimState, empty_state, state_from_numpy  # noqa: F401

__version__ = "0.1.0"
