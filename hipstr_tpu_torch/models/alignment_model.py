"""Copy of hipstr_tpu/models/alignment_model.py.

Global sequencing-indel HMM transition model.

Dindel-derived homopolymer-length-dependent match->insert/delete transition
probabilities plus fixed insert/delete extension constants.  Capability parity
with the reference AlignmentModel (reference:
src/SeqAlignment/AlignmentModel.{h,cpp}): probabilities for homopolymer runs
of length 1..10 come from Dindel, lengths 11..15 are linearly extrapolated,
and everything is exposed as dense lookup tables for device kernels.
"""

from __future__ import annotations

import math

import numpy as np

MAX_HOMOP_LEN = 15
LOG_INS_TO_INS = -1.0  # log(e^-1)
LOG_INS_TO_MATCH = math.log1p(-math.exp(-1.0))
LOG_DEL_TO_DEL = -1.0
LOG_DEL_TO_MATCH = math.log1p(-math.exp(-1.0))

_DINDEL_PROBS = np.array(
    [2.9e-5, 2.9e-5, 2.9e-5, 2.9e-5, 4.3e-5, 1.1e-4, 2.4e-4, 5.7e-4, 1.0e-3, 1.4e-3]
)


def _build_tables():
    m2i = np.zeros(MAX_HOMOP_LEN + 1, dtype=np.float64)
    m2d = np.zeros(MAX_HOMOP_LEN + 1, dtype=np.float64)
    m2m = np.zeros(MAX_HOMOP_LEN + 1, dtype=np.float64)
    for i in range(1, MAX_HOMOP_LEN + 1):
        if i <= 10:
            p = _DINDEL_PROBS[i - 1]
        else:
            p = _DINDEL_PROBS[9] + 4.3e-4 * (i - 10)
        m2i[i] = math.log(p)
        m2d[i] = math.log(p)
        m2m[i] = math.log(1.0 - 2.0 * p)
    return m2m, m2i, m2d


LOG_MATCH_TO_MATCH, LOG_MATCH_TO_INS, LOG_MATCH_TO_DEL = _build_tables()
