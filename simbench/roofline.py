"""The yardstick's arithmetic and timing helpers, frozen with the
benchmark: the card's peaks, the least time a kernel's work needs (its
bound), the operation counts of the substep kernels, and two ways to
time device work with CUDA events, and one that sums a call's device
operations in the profiler's trace.

Bytes count each input read once and each output written once;
operations are counted per particle from the kernels' sources (a square
root or a division counts as one), each spring and each unordered pair
once."""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

# NVIDIA's H100 SXM data sheet: device memory rate, and float32 outside
# the tensor cores (dense, at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def half_offsets(s: int):
    """The collision stencil's half offsets of Chebyshev radius ``s``:
    each unordered index pair once."""
    return tuple((dx, dy) for dx in range(0, s + 1)
                 for dy in range(-s, s + 1)
                 if (dx, dy) != (0, 0) and (dx > 0 or dy > 0))


def bound(n_bytes: float, n_ops: float):
    """``(ms, what)``: the larger of bytes over the memory rate and
    float32 operations over the float32 rate, and which it was."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def substep_ops(n: int, s: int) -> float:
    """The fused substep kernel (K1, K4): per particle 4 classes × (one
    spring evaluation of 16 ops, the int32 conversions and the −own +
    reaction sums 8, the edge update 11) + per half offset one pair
    evaluation of 38 ops and the 10 sums that apply it at both ends +
    the integration's ~60."""
    return n * (4 * (16 + 8 + 11) + len(half_offsets(s)) * 48 + 60)


def k1_bytes(n: int) -> float:
    """K1's non-observing call: reads the 18 hot planes, the 2 immutable
    and the 5 far-delta planes, writes the 18 hot planes (float32)."""
    return (18 + 2 + 5 + 18) * 4 * n


def k3_ops(n: int, s: int) -> float:
    """The collision stencil kernel (K3): each unordered pair once, a
    pair evaluation of 38 ops and the 10 sums that apply it at both
    ends."""
    return n * len(half_offsets(s)) * 48


def k3_bytes(n: int) -> float:
    """K3: reads px, py, vx, vy (float32) and alive (one byte), writes
    dvx, dvy, dax, day, dyn (float32)."""
    return n * (4 * 4 + 1) + 5 * 4 * n


def mirror_bound(n_plane: int, n_table: int):
    """The record mirror (K7): reads five planes, writes the table; no
    arithmetic."""
    return bound(5 * n_plane * 4 + n_table * 4, 0)


def timed_ms(fn, iters: int, warm: int = 1) -> float:
    """ms per call of ``fn``, host-paced: CUDA events around ``iters``
    calls after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warm: int = 1) -> float:
    """Device ms per call of ``fn``: the calls are queued behind a
    ``torch.cuda._sleep`` long enough for the host to enqueue them all,
    so the events between the first and the last time the device alone
    and not the host's launch rate.  Doubles the sleep until it outlasts
    the enqueueing; ``iters`` times the launches of one call must stay
    below the device's launch queue (~1000), where the host would
    block."""
    for _ in range(warm):
        fn()
    cycles = 20_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 2
    raise AssertionError("the host did not get ahead of the device")


def traced_ms(fn, iters: int, warm: int = 1) -> float:
    """Device ms per call of ``fn`` from the profiler's trace: the summed
    durations of the device operations (kernels, copies, fills) that
    ``iters`` calls launch, over ``iters``.  The host's waits inside a
    call (a count read back) are not device time and are not counted."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


class Probe(NamedTuple):
    """One call of a layer at the window's last state, for the per-layer
    readers: the call (None where the layer has nothing to do), the
    calls per timed batch, and its bound ``(ms, what)`` where one is
    counted."""

    fn: Optional[object]
    iters: int
    bound: Optional[tuple] = None
