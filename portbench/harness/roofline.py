"""Peaks of the cards the benchmark knows, and a kernel's bound.

Published rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM3. A card set below 700 W runs slower under load; the run prints
its power limit beside the shares.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def bound_s(flops, nbytes, kind):
    """Least seconds the card ``kind`` can take for ``flops`` float32
    operations and ``nbytes`` moved: the larger of the two times, or None
    for a card not in :data:`PEAKS`."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(flops / peak["fp32_flops"], nbytes / peak["bytes_per_s"])


def share_pct(flops, nbytes, kind, seconds):
    """Roofline share in %: the bound over the measured seconds; None
    where either is missing (no such kernel ran, or the card is
    unknown)."""
    least = bound_s(flops, nbytes, kind)
    if least is None or not seconds:
        return None
    return 100.0 * least / seconds
