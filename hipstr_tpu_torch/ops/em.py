"""Copy of hipstr_tpu/ops/em.py.

Length-based PCR stutter EM.

Capability parity with EMStutterGenotyper (reference:
src/em_stutter_genotyper.{h,cpp}): alleles are the distinct observed STR bp
lengths (reference first), the E-step sets P(read|allele) from the stutter
PMF and computes genotype + per-read phase posteriors, and the M-step
re-estimates allele frequencies and the six stutter parameters from expected
artifact counts with the reference's pseudocounts
(em_stutter_genotyper.cpp:63-127).

Re-design: everything is dense log-space tensor algebra over [reads, A] /
[samples, A, A] arrays — the reference's per-read triple loops become
logsumexp reductions — so the same code path runs vectorized on host (numpy,
float64) today and batches across loci on device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..models.stutter import StutterModel
from .posteriors import LOG_ONE_HALF, log_genotype_priors, sample_posteriors

TOLERANCE = 1e-10


def _lse(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    if axis is not None:
        return np.squeeze(out, axis=axis)
    return float(out.reshape(()))


@dataclass
class EMResult:
    converged: bool
    stutter_model: StutterModel
    num_iterations: int
    total_LL: float
    log_gt_priors: np.ndarray          # [A]
    bps_per_allele: List[int]
    log_sample_posteriors: np.ndarray  # [S, A, A]


class EMStutterGenotyper:
    """EM over observed STR lengths for one locus."""

    def __init__(self, haploid: bool, motif_len: int,
                 num_bps: List[List[int]], log_p1: List[List[float]],
                 log_p2: List[List[float]], ref_allele: int):
        self.haploid = haploid
        self.motif_len = motif_len

        sizes = sorted({b for per_sample in num_bps for b in per_sample
                        if b != ref_allele})
        self.bps = [ref_allele] + sizes
        self.A = len(self.bps)
        index = {b: i for i, b in enumerate(self.bps)}

        reads_allele, reads_p1, reads_p2, reads_sample = [], [], [], []
        self.reads_per_sample = []
        for s, per_sample in enumerate(num_bps):
            self.reads_per_sample.append(len(per_sample))
            for j, b in enumerate(per_sample):
                reads_allele.append(index[b])
                reads_p1.append(log_p1[s][j])
                reads_p2.append(log_p2[s][j])
                reads_sample.append(s)
        self.allele_index = np.array(reads_allele, dtype=np.int64)
        self.log_p1 = np.array(reads_p1)
        self.log_p2 = np.array(reads_p2)
        self.sample_index = np.array(reads_sample, dtype=np.int64)
        self.S = len(num_bps)
        self.R = len(reads_allele)
        self.read_weights = np.ones(self.R)

        self.stutter_model: Optional[StutterModel] = None
        self.log_gt_priors = None
        self.log_post = None
        self.total_LLs = None

    # ---- initialization ------------------------------------------------------
    def _init_log_gt_priors(self):
        """Pseudocount-1 allele frequencies (reference:
        em_stutter_genotyper.cpp:10-19)."""
        counts = np.ones(self.A)
        rps = np.array(self.reads_per_sample, dtype=np.float64)
        np.add.at(counts, self.allele_index, 1.0 / rps[self.sample_index])
        self.log_gt_priors = np.log(counts) - math.log(counts.sum())

    # ---- E step --------------------------------------------------------------
    def _aln_probs(self) -> np.ndarray:
        bps = np.array(self.bps)
        return self.stutter_model.log_pmf_grid(
            bps[None, :], bps[self.allele_index][:, None])

    def _priors_matrix(self) -> np.ndarray:
        """Population-frequency genotype priors (reference:
        em_stutter_genotyper.cpp:129-144)."""
        if self.haploid:
            pri = np.full((self.A, self.A), -np.finfo(np.float64).max / 2)
            np.fill_diagonal(pri, self.log_gt_priors)
            return pri
        return self.log_gt_priors[:, None] + self.log_gt_priors[None, :]

    # ---- M step --------------------------------------------------------------
    def _recalc_log_gt_priors(self):
        post = self.log_post  # [S, A, A]
        first = _lse(_lse(post, axis=2), axis=0)   # contribution of allele 1
        second = _lse(_lse(post, axis=1), axis=0)  # contribution of allele 2
        counts = np.logaddexp(first, second)
        self.log_gt_priors = counts - _lse(counts)

    def _phase_posteriors(self, aln_probs):
        """[R, A, A, 2] normalized phase posteriors (reference:
        em_stutter_genotyper.cpp:152-168); aln_probs[r, a] plays the PMF."""
        p1 = LOG_ONE_HALF + self.log_p1[:, None] + aln_probs  # [R, A]
        p2 = LOG_ONE_HALF + self.log_p2[:, None] + aln_probs
        t1 = p1[:, :, None]                # [R, A1, 1]
        t2 = p2[:, None, :]                # [R, 1, A2]
        tot = np.logaddexp(t1, t2)         # [R, A1, A2]
        return t1 - tot, t2 - tot

    def _recalc_stutter_model(self, aln_probs):
        """Expected artifact counts -> new stutter params (reference:
        em_stutter_genotyper.cpp:63-127)."""
        ph1, ph2 = self._phase_posteriors(aln_probs)
        post_r = self.log_post[self.sample_index]  # [R, A, A]
        # weight of (read, gt-allele) pairs, phases folded in
        W0 = _lse(post_r + ph1, axis=2)  # [R, A] over second allele
        W1 = _lse(post_r + ph2, axis=1)  # [R, A] over first allele

        bps = np.array(self.bps)
        diff = bps[self.allele_index][:, None] - bps[None, :]  # [R, A]
        in_frame = (diff % self.motif_len) == 0
        eff_out = diff - np.trunc(diff / self.motif_len).astype(np.int64)
        eff_in = diff // self.motif_len

        def collect(mask, extra=None):
            vals = []
            for W in (W0, W1):
                v = W[mask]
                if extra is not None:
                    v = v + extra[mask]
                vals.append(v)
            return np.concatenate(vals) if vals else np.empty(0)

        with np.errstate(divide="ignore"):
            log_abs_out = np.log(np.maximum(np.abs(eff_out), 1)).astype(np.float64)
            log_abs_in = np.log(np.maximum(np.abs(eff_in), 1)).astype(np.float64)

        in_eq = np.concatenate([[0.0], collect(in_frame & (diff == 0))])
        in_up = np.concatenate([[0.0], collect(in_frame & (diff > 0))])
        in_down = np.concatenate([[0.0], collect(in_frame & (diff < 0))])
        in_diffs = np.concatenate(
            [[0.0, math.log(1.1)], collect(in_frame & (diff != 0), log_abs_in)])
        out_up = np.concatenate([[0.0], collect(~in_frame & (diff > 0))])
        out_down = np.concatenate([[0.0], collect(~in_frame & (diff < 0))])
        out_diffs = np.concatenate(
            [[0.0, math.log(1.1)], collect(~in_frame, log_abs_out)])

        in_tot_up, in_tot_down = _lse(in_up), _lse(in_down)
        in_tot_eq, in_tot_diffs = _lse(in_eq), _lse(in_diffs)
        out_tot_up, out_tot_down = _lse(out_up), _lse(out_down)
        out_tot_diffs = _lse(out_diffs)
        out_tot = np.logaddexp(out_tot_up, out_tot_down)
        in_pgeom = min(0.999, math.exp(np.logaddexp(in_tot_up, in_tot_down)
                                       - in_tot_diffs))
        out_pgeom = min(0.999, math.exp(out_tot - out_tot_diffs))
        log_total = np.logaddexp(
            _lse(np.array([in_tot_up, in_tot_down, in_tot_eq])), out_tot)
        in_pup = math.exp(in_tot_up - log_total)
        in_pdown = math.exp(in_tot_down - log_total)
        out_pup = math.exp(out_tot_up - log_total)
        out_pdown = math.exp(out_tot_down - log_total)
        self.stutter_model = StutterModel(in_pgeom, in_pup, in_pdown,
                                          out_pgeom, out_pup, out_pdown,
                                          self.motif_len)

    # ---- main loop -----------------------------------------------------------
    def train(self, max_iter=100, min_LL_abs_change=0.01,
              min_LL_frac_change=0.001) -> EMResult:
        max_param_diff = 0.0001
        self._init_log_gt_priors()
        self.stutter_model = StutterModel.default(self.motif_len)

        LL = -np.finfo(np.float64).max
        num_iter = 1
        while num_iter <= max_iter:
            aln_probs = self._aln_probs()
            priors = self._priors_matrix()
            self.log_post, self.total_LLs, new_LL = sample_posteriors(
                np, aln_probs, self.log_p1, self.log_p2, self.read_weights,
                self.sample_index, self.S, priors)

            if new_LL < LL + TOLERANCE:
                # LL can dip slightly due to M-step pseudocounts; accept
                # (reference: em_stutter_genotyper.cpp:195-199)
                return self._result(True, num_iter, new_LL)

            self._recalc_log_gt_priors()
            prev = self.stutter_model
            self._recalc_stutter_model(aln_probs)

            abs_change = new_LL - LL
            frac_change = -(new_LL - LL) / LL
            if (abs_change < min_LL_abs_change and frac_change < min_LL_frac_change) \
                    or self.stutter_model.parameters_within_threshold(prev, max_param_diff):
                return self._result(True, num_iter, new_LL)
            LL = new_LL
            num_iter += 1
        return self._result(False, num_iter - 1, LL)

    def _result(self, converged, iters, LL) -> EMResult:
        return EMResult(converged, self.stutter_model, iters, LL,
                        self.log_gt_priors, list(self.bps), self.log_post)
