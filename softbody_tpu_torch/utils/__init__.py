"""Utilities (port of ``softbody_tpu.utils``): PNG IO, profiling and
observability helpers."""

from .png import write_png  # noqa: F401
from .profiling import Profiler  # noqa: F401
