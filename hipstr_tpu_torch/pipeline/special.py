"""Copy of hipstr_tpu/pipeline/special.py.

Small exact special-function statistics.

Replaces the reference's vendored cephes `bdtr` binomial CDF (used for the
allele-bias p-value, reference: src/seq_stutter_genotyper.cpp:965-982) and
htslib's `kt_fisher_exact` strand-bias test (reference:
seq_stutter_genotyper.cpp:1366-1375) with exact log-space implementations.
"""

from __future__ import annotations

import math

from scipy.special import betainc


def binomial_cdf(k: int, n: int, p: float) -> float:
    """P(X <= k) for X ~ Binomial(n, p) via the regularized incomplete beta
    (the identity cephes' bdtr uses)."""
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    return float(betainc(n - k, k + 1, 1.0 - p))


def allele_bias_pvalue(hap_a_count: int, hap_b_count: int) -> float:
    """log10 two-sided binomial p-value for allele depth bias
    (reference: SeqStutterGenotyper::compute_allele_bias)."""
    total = hap_a_count + hap_b_count
    if total == 0:
        return 1.0  # "not applicable" sentinel (> 0 means omit)
    if hap_a_count == hap_b_count:
        return 0.0
    pvalue = 2.0 * binomial_cdf(min(hap_a_count, hap_b_count), total, 0.5)
    return math.log10(min(1.0, pvalue))


def _log_hyper_prob(n11, n12, n21, n22):
    """log P of one 2x2 table under the hypergeometric distribution."""
    def lchoose(n, k):
        return (math.lgamma(n + 1) - math.lgamma(k + 1)
                - math.lgamma(n - k + 1))
    r1 = n11 + n12
    c1 = n11 + n21
    n = n11 + n12 + n21 + n22
    return lchoose(r1, n11) + lchoose(n - r1, c1 - n11) - lchoose(n, c1)


def fisher_exact_two_sided(n11: int, n12: int, n21: int, n22: int) -> float:
    """Two-sided Fisher exact p-value: sum of table probabilities <= observed
    (the convention htslib's kt_fisher_exact uses)."""
    r1 = n11 + n12
    c1 = n11 + n21
    n = n11 + n12 + n21 + n22
    lo = max(0, c1 - (n - r1))
    hi = min(r1, c1)
    obs = _log_hyper_prob(n11, n12, n21, n22)
    total = 0.0
    for k in range(lo, hi + 1):
        lp = _log_hyper_prob(k, r1 - k, c1 - k, n - r1 - c1 + k)
        # include tables at most as probable as the observed one (with the
        # customary epsilon slack for fp comparison)
        if lp <= obs + 1e-7:
            total += math.exp(lp)
    return min(1.0, total)


def fisher_strand_pvalue(fw_one: int, rv_one: int, fw_two: int, rv_two: int) -> float:
    """log10 two-sided Fisher strand-bias p-value."""
    two = fisher_exact_two_sided(fw_one, rv_one, fw_two, rv_two)
    return math.log10(min(1.0, two))
