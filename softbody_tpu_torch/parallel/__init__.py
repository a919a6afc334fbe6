"""Multi-device parallelism of the port: device meshes, world-parallel
batches (dp) and spatial slabs (sp), single-controller (one process
drives every shard; ``parallel/mesh.py``)."""

from .mesh import Mesh, make_mesh, pad_to_multiple  # noqa: F401
from .batched import (  # noqa: F401
    batched_frame_fn,
    device_put_batched,
    stack_states,
    unstack_states,
)
from .spatial import (  # noqa: F401
    ShardedState,
    pad_state_for_mesh,
    shard_state,
    spatial_frame_fn,
    unshard_state,
)
