"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the denominators of every roofline share.
The port's kernels are scalar float32 code outside the tensor cores."""

PEAK_F32_FLOPS = 67e12   # float32, CUDA cores
PEAK_BYTES = 3.35e12     # HBM3 bandwidth, bytes per second


def bound_s(operations: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    operations at the float32 peak and the bytes at the memory peak."""
    return max(operations / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
