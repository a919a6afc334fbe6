"""Engine backends (port of ``softbody_tpu.engine``, lattice backends)."""

from .backends import FusedLatticeBackend, LatticeBackend  # noqa: F401
