"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 bandwidth and float32 throughput
outside the tensor cores, the precision every kernel of these cells
computes in."""

BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(flops: float, nbytes: float):
    """``(seconds, "operations" or "bytes")``: the least time the card
    could take for the work, and which of the two peaks bounds it."""
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")
