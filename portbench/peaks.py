"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). The benchmark's own table:
rooflines and ``mfu`` are shares of these, whatever the program assumes."""

HBM_BYTES_PER_S = 3.35e12

# FLOP/s by the rate a kind of work runs at: "bfloat16" and "tf32" on the
# tensor cores, "float32" outside them (elementwise work, FMA kernels)
FLOPS_PER_S = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}


def bound_ms(nbytes: float, flops: dict) -> tuple[float, str]:
    """The least ms the chip could take for ``nbytes`` moved once to or from
    HBM and ``flops`` ({rate: count}) at their peaks, and which of the two
    sets it: "bytes" or "operations"."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / FLOPS_PER_S[rate] for rate, n in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
