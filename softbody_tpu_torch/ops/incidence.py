"""Beam→particle incidence tables (a copy of
``softbody_tpu/ops/incidence.py``, numpy only): the replacement for the
reference's fixed-point atomic force scatter (compute.wgsl:127-130).

The reference accumulates each beam's equal/opposite endpoint forces with
``atomicAdd`` into an i32 buffer at scale 65536 (compute.wgsl:68-70) —
making the sum order-independent.  A gather needs no atomics;
the beam topology is known host-side and only *shrinks* at runtime
(breakage masks), so we invert it once into a padded per-particle gather
list:

    force[i] = Σ_k  beam_force[inc_beam[i, k]] * inc_sign[i, k]

With integer (fixed-point) summation this is *bit-identical* to the
reference's atomic accumulation for any order.  Padding slots point at
beam 0 with sign 0.
"""

from __future__ import annotations

import numpy as np


def build_incidence(
    beam_a: np.ndarray,
    beam_b: np.ndarray,
    num_particles: int,
    *,
    min_degree: int = 4,
    pad_multiple: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Build padded incidence tables.

    Sign convention matches compute.wgsl:127-130: endpoint ``a`` receives
    ``-force``, endpoint ``b`` receives ``+force``.

    Returns ``(inc_beam [N, D] int32, inc_sign [N, D] int8)`` where ``D``
    is the max particle degree rounded up to ``pad_multiple``.
    """
    beam_a = np.asarray(beam_a, np.int64)
    beam_b = np.asarray(beam_b, np.int64)
    n = int(num_particles)
    m = beam_a.shape[0]

    endpoints = np.concatenate([beam_a, beam_b])
    signs = np.concatenate(
        [np.full(m, -1, np.int8), np.full(m, 1, np.int8)]
    )
    beam_ids = np.concatenate([np.arange(m), np.arange(m)])

    order = np.argsort(endpoints, kind="stable")
    endpoints = endpoints[order]
    signs = signs[order]
    beam_ids = beam_ids[order]

    counts = np.bincount(endpoints, minlength=n)
    max_deg = int(counts.max()) if counts.size else 0
    d = max(min_degree, -(-max(max_deg, 1) // pad_multiple) * pad_multiple)

    inc_beam = np.zeros((n, d), np.int32)
    inc_sign = np.zeros((n, d), np.int8)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(endpoints.shape[0]) - starts[endpoints]
    inc_beam[endpoints, rank] = beam_ids
    inc_sign[endpoints, rank] = signs
    return inc_beam, inc_sign
