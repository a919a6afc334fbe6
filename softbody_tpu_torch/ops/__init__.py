"""Physics ops: plain torch glue and the kernel wrappers (``cuda/``).
The exports are the JAX package's ``softbody_tpu.ops`` exports;
``frame_jit`` is the frame captured as a CUDA graph (``compiled.py``)."""

from .step import frame, frame_jit, run_frames, substep  # noqa: F401
from .forces import accumulate_forces, beam_forces  # noqa: F401
from .collisions import build_grid, collision_terms  # noqa: F401
from .integrate import integrate_particles  # noqa: F401
from .incidence import build_incidence  # noqa: F401
