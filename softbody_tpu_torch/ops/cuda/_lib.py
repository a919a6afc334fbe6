"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

At first use each source is compiled by its own ``nvcc`` process (all
started together), the objects are linked into one shared library with a
plain C interface under ``softbody_tpu_torch/_build/`` (named by a hash
of the sources, the shared header and the flags, so an edit rebuilds),
and the library is loaded with ``ctypes``.  Nothing is built or loaded
at import time.

Flags: ``sm_90a``; no ``--use_fast_math`` (it flushes denormals and
approximates ``sqrtf`` and ``/``); ``-fmad=false`` so no multiply-add is
contracted into an FMA — the kernels then round every float32 operation
exactly as the plain torch versions do, which keeps the int32 spring
sums and the band flags bit-identical to them."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_substep2.cu", "band_detect.cu", "collide_stencil.cu",
           "fused_substep.cu", "recmirror.cu", "graph_cond.cu",
           "far_apply.cu")
HEADERS = ("lattice_device.cuh", "band_device.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _sources(csrc: Path) -> tuple:
    """:data:`SOURCES` in ``csrc``: another checkout's may predate one
    (the package's own has them all)."""
    return tuple(n for n in SOURCES if csrc == CSRC or (csrc / n).exists())


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources(csrc) + HEADERS:
        # another checkout's csrc/ may predate a header
        if (csrc / name).exists() or name in SOURCES:
            h.update((csrc / name).read_bytes())
    return BUILD_DIR / f"libsoftbody_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> tuple:
    """Compile the kernels of ``csrc`` (the package's own by default; the
    same sources of another checkout, for comparing two versions in one
    process) if the library is missing.  Returns ``(path, seconds spent
    building, ptxas report)`` — 0 s and an empty report when the library
    was already there."""
    out = library_path(csrc)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    sources = _sources(csrc)
    for name in sources:
        obj = BUILD_DIR / f"{tag}.{Path(name).stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outputs = [proc.communicate() for proc in procs]
    for name, proc, (stdout, stderr) in zip(sources, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                               f"\n{stdout}\n{stderr}")
    report = [stderr for _stdout, stderr in outputs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "".join(report)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    return bind(build()[0])


def bind(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entries."""
    lib = ctypes.CDLL(str(path))
    # int sb_fused_substep2(hot, immut, far, obs_in, hot_out, obs_out,
    #                       consts_host, w, h, stencil, quantized, stream)
    lib.sb_fused_substep2.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _P]
    lib.sb_fused_substep2.restype = _I
    # int sb_fused_substep2_variant(..., stencil, quantized, rsqrt,
    #                               rollgroup, stream): the same with K1's
    # instance picked (libraries built before it existed lack it)
    if hasattr(lib, "sb_fused_substep2_variant"):
        lib.sb_fused_substep2_variant.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        lib.sb_fused_substep2_variant.restype = _I
    # int sb_fused_substep2_mode(hot, immut, far, obs_in, refs, hot_out,
    #     obs_out, stats, side, consts_host, w, h, stencil, quantized,
    #     rsqrt, rollgroup, trig, detect, nospring, noint, stream): every
    #     mode of K1 (libraries built before it existed lack it)
    if hasattr(lib, "sb_fused_substep2_mode"):
        lib.sb_fused_substep2_mode.argtypes = [_P] * 10 + [_I] * 10 + [_P]
        lib.sb_fused_substep2_mode.restype = _I
    # int sb_fused_substep2_modex(..., stream, extras_dev): the same with
    #     the N_EXTRA far-field scalars read from device memory
    if hasattr(lib, "sb_fused_substep2_modex"):
        lib.sb_fused_substep2_modex.argtypes = ([_P] * 10 + [_I] * 10
                                                + [_P, _P])
        lib.sb_fused_substep2_modex.restype = _I
    # int sb_fused_substep2_dev(hot, immut, far, obs_in, refs, hot_out,
    #     obs_out, stats, side, consts_dev, w, h, stencil, quantized,
    #     rsqrt, rollgroup, trig, detect, nospring, noint, skip, stream,
    #     extras_dev): every constant in device memory, the pair skip
    #     decided by the caller (libraries built before it lack it; so
    #     do the _dev entries of K3 and K4 below)
    if hasattr(lib, "sb_fused_substep2_dev"):
        lib.sb_fused_substep2_dev.argtypes = ([_P] * 10 + [_I] * 11
                                              + [_P, _P])
        lib.sb_fused_substep2_dev.restype = _I
    # int sb_fused_substep_dev(mut, immut, far, mut_out, consts_dev, skip,
    #                          w, h, stencil, quantized, stream)
    if hasattr(lib, "sb_fused_substep_dev"):
        lib.sb_fused_substep_dev.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        lib.sb_fused_substep_dev.restype = _I
    # int sb_collide_stencil_dev(px, py, vx, vy, strides_host, alive, out,
    #                            consts_dev, skip, w, h, stencil, stream)
    if hasattr(lib, "sb_collide_stencil_dev"):
        lib.sb_collide_stencil_dev.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.sb_collide_stencil_dev.restype = _I
    # int sb_cond_begin(stream, pred, child), sb_cond_end(child): an IF
    #     node of the graph the stream captures (ops/compiled.py)
    if hasattr(lib, "sb_cond_begin"):
        lib.sb_cond_begin.argtypes = [_P, _P, _P]
        lib.sb_cond_begin.restype = _I
        lib.sb_cond_end.argtypes = [_P]
        lib.sb_cond_end.restype = _I
        # int sb_stream_create(void** out): a stream of the caller's own
        lib.sb_stream_create.argtypes = [ctypes.POINTER(_P)]
        lib.sb_stream_create.restype = _I
    # int sb_stamp(slot, stream): %globaltimer into an int64 slot (the
    #     tracer's device marks, utils/profiling.py)
    if hasattr(lib, "sb_stamp"):
        lib.sb_stamp.argtypes = [_P, _P]
        lib.sb_stamp.restype = _I
    # int sb_band_flags(px, py, dev, bdev, alive, out, offsets_host,
    #                   n_offsets, w, h, stream)
    lib.sb_band_flags.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _P]
    lib.sb_band_flags.restype = _I
    # int sb_collide_stencil(px, py, vx, vy, alive, out, two_r, inv_dt2,
    #                        ecoeff, friction, w, h, stencil, stream)
    lib.sb_collide_stencil.argtypes = [_P, _P, _P, _P, _P, _P, _F, _F, _F,
                                       _F, _I, _I, _I, _P]
    lib.sb_collide_stencil.restype = _I
    # int sb_collide_stencil_strided(px, py, vx, vy, strides_host, alive,
    #                                out, two_r, inv_dt2, ecoeff, friction,
    #                                w, h, stencil, stream)
    if hasattr(lib, "sb_collide_stencil_strided"):
        lib.sb_collide_stencil_strided.argtypes = [_P] * 7 + [_F] * 4 + [
            _I, _I, _I, _P]
        lib.sb_collide_stencil_strided.restype = _I
    # int sb_fused_substep(mut, immut, far, mut_out, consts_host, w, h,
    #                      stencil, quantized, stream)
    lib.sb_fused_substep.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.sb_fused_substep.restype = _I
    # int sb_cast_rows(x, y, rows, stream) and sb_uncast_rows(y, x, rows,
    #                                                       stream)
    for fn in (lib.sb_cast_rows, lib.sb_uncast_rows):
        fn.argtypes = [_P, _P, _L, _P]
        fn.restype = _I
    # int sb_mirror_records(px, py, vx, vy, alive, out, w, h, w_out, h_out,
    #                       mb, stream)
    lib.sb_mirror_records.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _P]
    lib.sb_mirror_records.restype = _I
    # int sb_far_pairs(px, py, vx, vy, alive, sx, sy, w, h, ca, cb, valid,
    #     k, cwy, world_h, s, two_r, dt2, ecoeff, friction, ecoeff_dev,
    #     friction_dev, scratch, stream) and sb_far_accumulate(scratch,
    #     keys, offsets, valid, k, capacity, cwy, out, wo, ho, stream): K8
    #     (libraries built before it existed lack them)
    if hasattr(lib, "sb_far_pairs"):
        lib.sb_far_pairs.argtypes = ([_P] * 5 + [_L, _L, _I, _I] + [_P] * 3
                                     + [_I, _I, _L, _I] + [_F] * 4
                                     + [_P] * 4)
        lib.sb_far_pairs.restype = _I
        lib.sb_far_accumulate.argtypes = [_P] * 4 + [_I] * 3 + [_P, _I, _I,
                                                                _P]
        lib.sb_far_accumulate.restype = _I
    # int sb_<kernel>_occupancy(stencil, out[5]) of K1, K4, K3 and K2
    # (libraries built before they existed lack them)
    for name in ("sb_fused_substep2_occupancy", "sb_fused_substep_occupancy",
                 "sb_collide_stencil_occupancy", "sb_band_flags_occupancy"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [_I, ctypes.POINTER(_I)]
            getattr(lib, name).restype = _I
    lib.sb_error_string.argtypes = [_I]
    lib.sb_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().sb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def occupancy(kernel: str, stencil: int, devc: bool = False) -> dict:
    """Residency on the current device of K1 (``kernel="fused_substep2"``),
    K4 (``"fused_substep"``), K3 (``"collide_stencil"``, the interleaved
    layout of path A) or K2 (``"band_flags"``; one shape for every
    stencil) at stencil radius ``stencil``: resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes per thread, dynamic shared bytes and threads per
    block.  ``devc``: K1's, K3's or K4's instance that reads its
    constants from device memory."""
    out = (_I * 5)()
    fn = getattr(library(), f"sb_{kernel}_occupancy")
    check(fn(stencil | (1 << 16 if devc else 0), out),
          f"{kernel} occupancy")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                smem_bytes=out[3], threads=out[4])
