"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

The configurations state float32 with TF32 off, so their products run
outside the tensor cores, where 67 TFLOP/s is the peak. A change that puts
them on the tensor cores (3xTF32, for instance) needs this table re-based
first, in a benchmark change of its own.
"""
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the f32 peak or
    bytes over the memory rate, whichever is longer."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
