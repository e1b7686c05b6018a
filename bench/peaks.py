"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at its
700 W power limit; frozen here so that no change to the program moves them.
The program's own table is ``repro_torch/launch/roofline.py``."""

HBM_BYTES_S = 3.35e12      # HBM3
TF32_FLOPS_S = 495e12      # tensor cores, dense: the highest rate for 32-bit operands


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the work can take on the card: the larger of its bytes
    at the memory rate and its operations at the TF32 rate."""
    return max(nbytes / HBM_BYTES_S, flops / TF32_FLOPS_S)
