"""Physics ops: plain torch glue and the kernel wrappers (``cuda/``).
The exports are the JAX package's ``softbody_tpu.ops`` exports but for
``frame_jit`` (torch runs eagerly: ``frame`` is the frame function)."""

from .step import frame, run_frames, substep  # noqa: F401
from .forces import accumulate_forces, beam_forces  # noqa: F401
from .collisions import build_grid, collision_terms  # noqa: F401
from .integrate import integrate_particles  # noqa: F401
from .incidence import build_incidence  # noqa: F401
