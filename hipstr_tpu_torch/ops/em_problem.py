"""One locus's inputs to the batched stutter EM (ops/em_batched.py).

A copy of the JAX package's EMProblem (hipstr_tpu/ops/em_batched.py).
The pool's host workers build these and send them to the parent, whose
device EM packs and trains them; this module imports no torch, so a
worker builds and pickles them without loading it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class EMProblem:
    """One locus's EM inputs (host lists -> dense arrays)."""
    haploid: bool
    period: int
    bps: np.ndarray            # [A] int, bps[0] = ref allele (0)
    allele_index: np.ndarray   # [R] int
    sample_index: np.ndarray   # [R] int
    log_p1: np.ndarray         # [R]
    log_p2: np.ndarray         # [R]
    num_samples: int
    reads_per_sample: np.ndarray  # [S]

    @classmethod
    def build(cls, haploid: bool, period: int, num_bps: List[List[int]],
              log_p1: List[List[float]], log_p2: List[List[float]],
              ref_allele: int = 0) -> "EMProblem":
        sizes = sorted({b for per_sample in num_bps for b in per_sample
                        if b != ref_allele})
        bps = [ref_allele] + sizes
        index = {b: i for i, b in enumerate(bps)}
        ai, p1, p2, si, rps = [], [], [], [], []
        for s, per_sample in enumerate(num_bps):
            rps.append(len(per_sample))
            for j, b in enumerate(per_sample):
                ai.append(index[b])
                p1.append(log_p1[s][j])
                p2.append(log_p2[s][j])
                si.append(s)
        return cls(haploid, period, np.asarray(bps, np.int32),
                   np.asarray(ai, np.int32), np.asarray(si, np.int32),
                   np.asarray(p1, np.float64), np.asarray(p2, np.float64),
                   len(num_bps), np.asarray(rps, np.float64))
