"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM bytes per second and float32
operations per second outside the tensor cores.  A card set below 700 W
reaches less; the run prints its power limit beside every share."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_ms(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 peak, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
