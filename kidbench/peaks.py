"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the yardstick of every roofline share."""

PEAK_F32_OPS = 67e12       # float32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12       # HBM3, bytes/s


def bound_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_F32_OPS)
