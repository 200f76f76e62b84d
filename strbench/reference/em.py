"""The plain reference of the stutter EM: one locus's stutter model learned
from its reads' repeat-length changes, in a precision of the caller's
choosing.

HipSTR's EMStutterGenotyper (reference src/em_stutter_genotyper.cpp:10-226,
src/stutter_model.cpp:29-53, src/genotyper.cpp:20-80) written in plain
PyTorch, per locus, after the port's host EM (hipstr_tpu_torch/ops/em.py)
as it stood when the benchmark was defined: alleles are the distinct
observed lengths (the reference allele first), the E-step takes the
stutter PMF as each read's alignment probability, the M-step re-estimates
the allele frequencies and the six stutter parameters from expected
artifact counts with the reference's pseudocounts, and the loop stops on
the LL dip, the LL change or the parameter change.  It imports nothing of
the program; its input is a locus's reads as (sample, length change,
log phase weights), which the harness takes from the EM problem the
program built and checks against the generator's truth.
"""

from __future__ import annotations

import math

import torch

LOG_ONE_HALF = math.log(0.5)
TOLERANCE = 1e-10
MAX_PARAM_DIFF = 1e-4
DEFAULT = (0.9, 0.1, 0.1, 0.8, 0.01, 0.01)   # em_stutter_genotyper.cpp:58-61


def _lse(x, dim):
    m = torch.amax(x, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.sum(torch.exp(x - m), dim=dim,
                                    keepdim=True))).squeeze(dim)


def _lse_all(x):
    return _lse(x.reshape(-1), 0)


def log_pmf(params, diff, period: int, dtype):
    """log P(read length - allele length = diff) under the stutter model
    (stutter_model.cpp:29-53); diff is an integer tensor."""
    in_geom, in_up, in_down, out_geom, out_up, out_down = (
        torch.as_tensor(p, dtype=dtype) for p in params)
    in_frame = torch.remainder(diff, period) == 0
    eff = diff - torch.trunc(diff.double() / period).long()
    out_pmf = torch.where(
        eff < 0, torch.log(out_down) + torch.log(out_geom)
        + torch.log1p(-out_geom) * (-eff - 1).to(dtype),
        torch.log(out_up) + torch.log(out_geom)
        + torch.log1p(-out_geom) * (eff - 1).to(dtype))
    rep = torch.div(diff, period, rounding_mode="floor")
    equal = torch.log(1 - in_up - in_down - out_up - out_down)
    in_pmf = torch.where(
        rep == 0, equal, torch.where(
            rep < 0, torch.log(in_down) + torch.log(in_geom)
            + torch.log1p(-in_geom) * (-rep - 1).to(dtype),
            torch.log(in_up) + torch.log(in_geom)
            + torch.log1p(-in_geom) * (rep.abs() - 1).to(dtype)))
    return torch.where(in_frame, in_pmf, out_pmf)


def train(haploid: bool, period: int, bps, allele_index, sample_index,
          log_p1, log_p2, num_samples: int, reads_per_sample,
          dtype=torch.float64, max_iter: int = 100,
          min_abs: float = 0.01, min_frac: float = 0.001):
    """(params (6 floats), converged, iterations) of one locus.  bps [A]
    the allele lengths (bps[0] the reference's); per read its allele
    index, sample index and log phase weights."""
    dt = dtype
    bps = torch.as_tensor(bps, dtype=torch.long)
    ai = torch.as_tensor(allele_index, dtype=torch.long)
    si = torch.as_tensor(sample_index, dtype=torch.long)
    p1 = torch.as_tensor(log_p1, dtype=torch.float64).to(dt)
    p2 = torch.as_tensor(log_p2, dtype=torch.float64).to(dt)
    rps = torch.as_tensor(reads_per_sample, dtype=torch.float64)
    A, S = bps.numel(), num_samples
    # pseudocount-1 allele frequencies (em_stutter_genotyper.cpp:10-19)
    counts = torch.ones(A, dtype=torch.float64).index_add(
        0, ai, 1.0 / rps[si])
    log_freq = (torch.log(counts) - math.log(float(counts.sum()))).to(dt)
    params = DEFAULT
    diff = bps[ai][:, None] - bps[None, :]          # [R, A] read - allele
    eye = torch.eye(A, dtype=torch.bool)
    in_frame = torch.remainder(diff, period) == 0
    eff_out = diff - torch.trunc(diff.double() / period).long()
    eff_in = torch.div(diff, period, rounding_mode="floor")
    log_abs_out = torch.log(eff_out.abs().clamp(min=1).double()).to(dt)
    log_abs_in = torch.log(eff_in.abs().clamp(min=1).double()).to(dt)
    zero = torch.zeros(1, dtype=dt)
    pseudo_geom = torch.tensor([0.0, math.log(1.1)], dtype=dt)
    LL = -torch.finfo(torch.float64).max
    it = 1
    while it <= max_iter:
        aln = log_pmf(params, diff, period, dt)    # P(read | allele)
        if haploid:
            pri = torch.where(eye, log_freq[:, None] + 0 * log_freq[None, :],
                              torch.tensor(-1e300, dtype=torch.float64).to(dt))
        else:
            pri = log_freq[:, None] + log_freq[None, :]
        t1 = LOG_ONE_HALF + p1[:, None] + aln
        t2 = LOG_ONE_HALF + p2[:, None] + aln
        a, b = t1[:, :, None], t2[:, None, :]
        m = torch.maximum(a, b)
        contrib = m + torch.log1p(torch.exp(torch.minimum(a, b) - m))
        sums = torch.zeros((S, A, A), dtype=dt).index_add(0, si, contrib)
        unnorm = pri[None] + sums
        totals = _lse(unnorm.reshape(S, A * A), 1)
        log_post = unnorm - totals[:, None, None]
        new_LL = float(totals.double().sum())
        if new_LL < LL + TOLERANCE:
            return params, True, it
        # allele frequencies (em_stutter_genotyper.cpp:21-40)
        first = _lse(_lse(log_post, 2), 0)
        second = _lse(_lse(log_post, 1), 0)
        cnt = torch.logaddexp(first, second)
        log_freq = cnt - _lse_all(cnt)
        # stutter parameters (em_stutter_genotyper.cpp:63-127)
        tot = torch.logaddexp(t1[:, :, None], t2[:, None, :])
        ph1, ph2 = t1[:, :, None] - tot, t2[:, None, :] - tot
        post_r = log_post[si]
        W = torch.stack([_lse(post_r + ph1, 2), _lse(post_r + ph2, 1)])

        def total(mask, extra=None, seeds=zero):
            v = W + (extra if extra is not None else 0)
            return _lse_all(torch.cat([seeds, v[:, mask].reshape(-1)]))

        in_up = total(in_frame & (diff > 0))
        in_down = total(in_frame & (diff < 0))
        in_eq = total(in_frame & (diff == 0))
        in_diffs = total(in_frame & (diff != 0), log_abs_in, pseudo_geom)
        out_up = total(~in_frame & (diff > 0))
        out_down = total(~in_frame & (diff < 0))
        out_diffs = total(~in_frame, log_abs_out, pseudo_geom)
        out_tot = torch.logaddexp(out_up, out_down)
        log_total = torch.logaddexp(
            _lse_all(torch.stack([in_up, in_down, in_eq])), out_tot)
        prev = params
        params = (min(0.999, float(torch.exp(torch.logaddexp(in_up, in_down)
                                             - in_diffs))),
                  float(torch.exp(in_up - log_total)),
                  float(torch.exp(in_down - log_total)),
                  min(0.999, float(torch.exp(out_tot - out_diffs))),
                  float(torch.exp(out_up - log_total)),
                  float(torch.exp(out_down - log_total)))
        abs_change = new_LL - LL
        frac_change = -(new_LL - LL) / LL
        if (abs_change < min_abs and frac_change < min_frac) or all(
                abs(x - y) < MAX_PARAM_DIFF for x, y in zip(params, prev)):
            return params, True, it
        LL = new_LL
        it += 1
    return params, False, it - 1
