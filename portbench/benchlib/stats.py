"""The yardstick's arithmetic: percentiles, the device's busy time, and the
peaks the rooflines and ``step_mfu`` are shares of.

``busy_ns`` is a frozen copy of the union in
``gymrl_tpu_torch/utils/profiling.py`` ``kernel_stats`` :42-59 (copies and
memsets are not kernels and are not counted).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the card's full 700 W (not measured).
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,  # float32 outside the tensor cores
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (0 ≤ q ≤ 100), interpolated
    linearly between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def merged(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(spans: list[tuple[int, int]]) -> int:
    """Time covered by at least one of ``spans``."""
    busy, end = 0, -1
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
