"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 and float64 outside the tensor cores
and the HBM3 bandwidth; a frozen copy of chip_smoke.py's PEAK_OPS and
PEAK_BYTES."""

PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


def bound(ops, nbytes, exp_log, dtype_name):
    """The least time (ms) the card could take: the larger of operations
    over the peak rate and bytes over the peak bandwidth."""
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(ops=ops, bytes=nbytes, exp_log=exp_log,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
