"""Copy of hipstr_tpu/utils/mathops.py.

Log-space math utilities (host + device flavors).

Capability parity with the reference's mathops (reference:
src/mathops.{h,cpp}) with one deliberate re-design: the reference uses a
bit-trick "fast" log-sum-exp approximation (src/mathops.cpp:86-106 with a
log(0.001) cutoff) inside its hot loops; on TPU, native transcendentals are
cheap, so every kernel here uses *exact* log-sum-exp.  Differences vs the
reference's outputs are therefore at the level of its fast-math error
(~1e-4 relative), which is inside our published tolerance ladder.
"""

from __future__ import annotations

import math

import numpy as np

LOG_ONE_HALF = math.log(0.5)
LOG_E_BASE_10 = 0.4342944819  # matches reference constant (src/mathops.cpp:11)
TOLERANCE = 1e-10

# Large negative stand-in for -inf that stays well inside float32 range after a
# few additions.  The reference uses -1e9 (IMPOSSIBLE, src/SeqAlignment/
# HapAligner.cpp:20); we keep the same value so oracle comparisons line up.
IMPOSSIBLE = -1.0e9


def log_sum_exp(vals, axis=None):
    """Exact log-sum-exp over a numpy array (host-side helper)."""
    vals = np.asarray(vals, dtype=np.float64)
    m = np.max(vals, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(vals - m), axis=axis, keepdims=True))
    if axis is None:
        return float(out.reshape(()))
    return np.squeeze(out, axis=axis)


def log_sum_exp_pair(a, b):
    if a > b:
        return a + math.log1p(math.exp(b - a))
    return b + math.log1p(math.exp(a - b))


# Streaming log-sum-exp (max + running scaled total), mirroring the
# reference's update/finish_streaming_log_sum_exp (src/mathops.cpp:72-84).
def streaming_lse_init():
    return (-np.inf, 0.0)


def streaming_lse_update(state, log_val):
    max_val, total = state
    if log_val <= max_val:
        return (max_val, total + math.exp(log_val - max_val))
    return (log_val, total * math.exp(max_val - log_val) + 1.0)


def streaming_lse_finish(state):
    max_val, total = state
    return max_val + math.log(total)
