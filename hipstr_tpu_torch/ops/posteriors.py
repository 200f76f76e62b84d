"""Genotype posteriors: the fused batched posteriors in PyTorch, and the
host (numpy, float64) posteriors and genotype extraction.

`batched_pool_posteriors` is the counterpart of
hipstr_tpu/ops/posteriors.py::batched_pool_posteriors (an XLA op in the
JAX package, not a Pallas kernel; reference src/genotyper.cpp:44-80 plus
the mate-pair LL summing of seq_stutter_genotyper.cpp:530-564).  The
per-sample sum (`sample_sums`) adds each sample's reads in order, as the
host posteriors' np.add.at does, in the port's own kernel
csrc/sample_sum.cu on the card (no atomics: the VCF is the same from run
to run, and float64 equals the host's bit for bit).

`log_genotype_priors`, `read_genotype_lls`, `sample_posteriors` and
`extract_genotypes` are copies of the numpy functions of
hipstr_tpu/ops/posteriors.py (reference src/genotyper.cpp:20-251) that the
host genotyper, the VCF records and the stutter EM call, without the JAX
branches: `xp` is numpy.  The module imports no torch: the pool's host
workers call the numpy functions, and the torch functions import it (and
the kernels) when they run.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np

NEG = -1.0e30
LOG_ONE_HALF = math.log(0.5)
LOG_E_BASE_10 = 0.4342944819  # reference constant (src/mathops.cpp:11)


def batched_pool_posteriors(LL, pm: dict, Sm: int, dtype):
    """(log_post [G, Sm, H, H], totals [G, Sm]) straight from the
    [G, P, H] pool LLs of the HMM dispatch.

    pm is the stacked padded posterior-meta dict (hap_aligner.prepare_locus):
    pool_row/mate_index/sample [G, R] int, has_mate/read_ok [G, R] bool,
    weights/log_p1/log_p2 [G, R], col_index [G, H], n_alleles [G],
    haploid [G].  Padded reads carry weight 0; alleles >= n_alleles[g] are
    masked NEG."""
    import torch
    G, P, H = LL.shape
    dev = LL.device
    LL = LL.to(dtype)
    cols = pm.get("col_index")
    if cols is not None:
        # speculative dispatches align a superset haplotype; gather the
        # columns of the genotyper's current alleles
        LL = torch.gather(LL, 2, cols.long()[:, None, :].expand(G, P, H))
    pool_row = pm["pool_row"].long()
    R = pool_row.shape[1]
    LLr = torch.gather(LL, 1, pool_row[:, :, None].expand(G, R, H))
    LLr = torch.where(pm["read_ok"].bool()[:, :, None], LLr, 0.0)
    mate = torch.gather(LLr, 1, pm["mate_index"].long()[:, :, None]
                        .expand(G, R, H))
    comb = LLr + torch.where(pm["has_mate"].bool()[:, :, None], mate, 0.0)

    n_all = pm["n_alleles"].long()
    A = n_all.to(dtype)[:, None, None]                           # runtime A
    amask = torch.arange(H, device=dev)[None, :] < n_all[:, None]
    gmask = amask[:, :, None] & amask[:, None, :]
    diag = torch.eye(H, dtype=torch.bool, device=dev)[None]
    log2 = torch.log(torch.tensor(2.0, dtype=dtype, device=dev))
    homo = log2 - torch.log(A) - torch.log(A + 1.0)
    het = -torch.log(A) - torch.log(A + 1.0)
    pri = torch.where(diag, homo, het)
    pri_hap = torch.where(diag, -torch.log(A), NEG)
    priors = torch.where(pm["haploid"].bool()[:, None, None], pri_hap, pri)
    priors = torch.where(gmask, priors, NEG)

    w = pm["weights"].to(dtype)
    t1 = LOG_ONE_HALF + pm["log_p1"].to(dtype)[:, :, None] + comb
    t2 = LOG_ONE_HALF + pm["log_p2"].to(dtype)[:, :, None] + comb
    a = t1[:, :, :, None]
    b = t2[:, :, None, :]
    m = torch.maximum(a, b)
    lse = m + torch.log1p(torch.exp(torch.minimum(a, b) - m))   # [G,R,H,H]
    contrib = w[:, :, None, None] * lse

    sums = sample_sums(contrib.reshape(G, R, H * H), pm["sample"], w,
                       Sm).reshape(G, Sm, H, H)
    unnorm = priors[:, None] + sums
    unnorm = torch.where(gmask[:, None], unnorm, NEG)
    flat = unnorm.reshape(G, Sm, H * H)
    mx = torch.amax(flat, dim=2)
    totals = mx + torch.log(torch.sum(torch.exp(flat - mx[:, :, None]), dim=2))
    log_post = unnorm - totals[:, :, None, None]
    return log_post, totals


def sample_sums(contrib, sample, weights, Sm: int):
    """[G, Sm, C]: each locus's per-read cells contrib [G, R, C] summed
    over the reads of each sample (sample, weights [G, R]), each sample's
    reads added in order from 0, as the host posteriors' np.add.at adds
    them.  A read of weight 0 (the padding's) adds an exact zero and is
    skipped.  On a CUDA tensor the kernel csrc/sample_sum.cu runs
    (sample_sum_kernel) or the call raises; a CPU tensor takes
    sample_sums_plain."""
    runs = sample_runs(sample, weights, Sm)
    if contrib.device.type == "cpu":
        return sample_sums_plain(contrib, *runs)
    if contrib.device.type == "cuda":
        return sample_sum_kernel(contrib, *runs)
    raise ValueError(f"sample_sums: unsupported device {contrib.device}")


def sample_runs(sample, weights, Sm: int):
    """(order [G, R], start [G, Sm], count [G, Sm]), int32: each locus's
    read indices stably sorted by sample, and where each sample's run
    starts in that order and how many reads it holds.  Reads of weight 0
    sort past the last sample and belong to no run."""
    import torch
    G, R = sample.shape
    key = torch.where(weights != 0, sample.long(), Sm)
    order = torch.sort(key, dim=1, stable=True).indices
    slot = key + (Sm + 1) * torch.arange(G, device=key.device)[:, None]
    count = torch.bincount(slot.reshape(-1), minlength=G * (Sm + 1)).reshape(
        G, Sm + 1)[:, :Sm]
    start = torch.cumsum(count, 1) - count
    return order.int(), start.int(), count.int()


def sample_sums_plain(contrib, order, start, count):
    """The plain PyTorch version of csrc/sample_sum.cu: pass k adds the
    k-th read of every sample's run to that sample's sums."""
    import torch
    G, R, C = contrib.shape
    Sm = start.shape[1]
    out = torch.zeros((G, Sm, C), dtype=contrib.dtype, device=contrib.device)
    order, start, count = order.long(), start.long(), count.long()
    for k in range(int(count.max()) if count.numel() else 0):
        rows = torch.gather(order, 1, torch.clamp(start + k, max=R - 1))
        vals = torch.gather(contrib, 1, rows[:, :, None].expand(G, Sm, C))
        out = torch.where((k < count)[:, :, None], out + vals, out)
    return out


def sample_sum_kernel(contrib, order, start, count):
    """Launch csrc/sample_sum.cu on CUDA tensors: [G, Sm, C]."""
    import torch

    from .. import kernels
    G, R, C = contrib.shape
    Sm = start.shape[1]
    dev, dtype = contrib.device, contrib.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sample_sums: dtype {dtype}")
    for name, t, dt, shape in (("contrib", contrib, dtype, (G, R, C)),
                               ("order", order, torch.int32, (G, R)),
                               ("start", start, torch.int32, (G, Sm)),
                               ("count", count, torch.int32, (G, Sm))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    out = torch.empty((G, Sm, C), dtype=dtype, device=dev)
    kernels.launch("sample_sum", dtype, dev, (G, R, Sm, C),
                   kernels.ptr(contrib), kernels.ptr(order),
                   kernels.ptr(start), kernels.ptr(count), kernels.ptr(out),
                   ctypes.c_int(G), ctypes.c_int(R), ctypes.c_int(Sm),
                   ctypes.c_int(C))
    return out


def log_genotype_priors(xp, num_alleles, haploid: bool, dtype=np.float64):
    """[A, A] prior matrix (reference: src/genotyper.cpp:20-42).

    Diploid: phased het 1/(n(n+1)), homozygous 2/(n(n+1)).
    Haploid: homozygous 1/n, het impossible.
    """
    A = num_alleles
    eye = xp.eye(A, dtype=bool)
    if haploid:
        homo = -math.log(A)
        het = -1.0e308 / 2 if dtype == np.float64 else NEG
        return xp.where(eye, xp.asarray(homo, dtype=dtype), het)
    homo = math.log(2.0) - math.log(A) - math.log(A + 1)
    het = -math.log(A) - math.log(A + 1)
    return xp.where(eye, xp.asarray(homo, dtype=dtype),
                    xp.asarray(het, dtype=dtype))


def read_genotype_lls(xp, log_aln_probs, log_p1, log_p2, read_weights):
    """[reads, A, A] per-read genotype log-likelihood contributions.

    reference: the inner expression of calc_log_sample_posteriors
    (src/genotyper.cpp:51-61).
    """
    t1 = LOG_ONE_HALF + log_p1[:, None] + log_aln_probs      # [R, A]
    t2 = LOG_ONE_HALF + log_p2[:, None] + log_aln_probs      # [R, A]
    a = t1[:, :, None]
    b = t2[:, None, :]
    m = xp.maximum(a, b)
    lse = m + xp.log1p(xp.exp(xp.minimum(a, b) - m))
    return read_weights[:, None, None] * lse


def sample_posteriors(xp, log_aln_probs, log_p1, log_p2, read_weights,
                      sample_index, num_samples, priors):
    """Normalized per-sample genotype posteriors + total LLs.

    Returns (log_post [S, A, A], sample_total_LL [S], total_LL scalar).
    reference: src/genotyper.cpp:44-80.
    """
    contrib = read_genotype_lls(xp, log_aln_probs, log_p1, log_p2, read_weights)
    A = log_aln_probs.shape[1]
    sums = _segment_sum(xp, contrib, sample_index, num_samples)
    unnorm = priors[None, :, :] + sums
    flat = unnorm.reshape(num_samples, A * A)
    m = xp.max(flat, axis=1)
    totals = m + xp.log(xp.sum(xp.exp(flat - m[:, None]), axis=1))
    log_post = unnorm - totals[:, None, None]
    return log_post, totals, xp.sum(totals)


def _segment_sum(xp, contrib, sample_index, num_samples):
    out = np.zeros((num_samples,) + contrib.shape[1:], dtype=contrib.dtype)
    np.add.at(out, sample_index, contrib)
    return out


class GenotypeExtraction(NamedTuple):
    best_hap_a: np.ndarray           # [S] ML haplotype pair (phased)
    best_hap_b: np.ndarray
    best_gt_a: np.ndarray            # [S] ML variant alleles
    best_gt_b: np.ndarray
    log_phased_post: np.ndarray      # [S] posterior of ML phased genotype
    log_unphased_post: np.ndarray    # [S]
    hap_log_phased_post: np.ndarray  # [S] same at haplotype level
    hap_log_unphased_post: np.ndarray
    gls: np.ndarray | None           # [S, V*(V+1)/2] log10 GLs (diploid order)
    gl_diffs: np.ndarray | None      # [S]
    pls: np.ndarray | None           # [S, G]
    phased_gls: np.ndarray | None    # [S, V*V]


def extract_genotypes(log_post: np.ndarray, sample_total_LLs: np.ndarray,
                      hap_to_allele: np.ndarray, num_variants: int,
                      haploid: bool, num_alleles: int,
                      calc_gls=False, calc_pls=False, calc_phased_gls=False
                      ) -> GenotypeExtraction:
    """Marginalize haplotype posteriors to variant genotypes + likelihoods.

    Host-side (numpy, float64); mirrors
    Genotyper::extract_genotypes_and_likelihoods (src/genotyper.cpp:129-251)
    including the prior-removal corrections for GL/PHASEDGL.
    """
    S, A, _ = log_post.shape
    V = num_variants
    flat = log_post.reshape(S, A * A)
    best = np.argmax(flat, axis=1)
    best_a, best_b = best // A, best % A
    best_gt_a = hap_to_allele[best_a]
    best_gt_b = hap_to_allele[best_b]

    # marginalize haplotype pairs -> variant pairs
    gt_index = (hap_to_allele[:, None] * V + hap_to_allele[None, :]).reshape(-1)
    marg = np.full((S, V * V), -np.inf)
    for g in range(V * V):
        mask = gt_index == g
        if mask.any():
            vals = flat[:, mask]
            m = vals.max(axis=1)
            marg[:, g] = m + np.log(np.sum(np.exp(vals - m[:, None]), axis=1))

    sidx = np.arange(S)
    hap_lpp = flat[sidx, best_a * A + best_b]
    alt = flat[sidx, best_b * A + best_a]
    same = best_a == best_b
    hap_lup = np.where(same, hap_lpp, np.logaddexp(hap_lpp, alt))

    lpp = marg[sidx, best_gt_a * V + best_gt_b]
    alt2 = marg[sidx, best_gt_b * V + best_gt_a]
    same_gt = best_gt_a == best_gt_b
    lup = np.where(same_gt, lpp, np.logaddexp(lpp, alt2))

    gls = gl_diffs = pls = phased_gls = None
    if calc_gls or calc_pls or calc_phased_gls:
        hom_corr = (-math.log(num_alleles) if haploid
                    else math.log(2) - math.log(num_alleles) - math.log(num_alleles + 1))
        het_corr = (0.0 if haploid
                    else -math.log(num_alleles) - math.log(num_alleles + 1))
        if haploid:
            gl_ncfg = math.log(2) + math.log(num_alleles) - math.log(V)
            pgl_ncfg = math.log(num_alleles) - math.log(V)
        else:
            gl_ncfg = math.log(2) + 2 * (math.log(num_alleles) - math.log(V))
            pgl_ncfg = 2 * (math.log(num_alleles) - math.log(V))

        gls_list = [[] for _ in range(S)]
        pgl_list = [[] for _ in range(S)]
        for i1 in range(V):
            for i2 in range(V):
                g = i1 * V + i2
                ag = i2 * V + i1
                corr = hom_corr if i1 == i2 else het_corr
                if (i2 <= i1) and (not haploid or i1 == i2):
                    base = (sample_total_LLs - (corr + gl_ncfg)
                            + np.logaddexp(marg[:, g], marg[:, ag]))
                    for s in range(S):
                        gls_list[s].append(base[s] * LOG_E_BASE_10)
                if calc_phased_gls and (not haploid or i1 == i2):
                    val = (sample_total_LLs - (corr + pgl_ncfg)
                           + marg[:, g]) * LOG_E_BASE_10
                    for s in range(S):
                        pgl_list[s].append(val[s])
        gls = np.array(gls_list)
        if calc_phased_gls:
            phased_gls = np.array(pgl_list)

        # GLDIFF (reference: src/genotyper.cpp:106-127)
        gl_diffs = np.empty(S)
        for s in range(S):
            g = gls[s]
            if V == 1:
                gl_diffs[s] = -1000.0
                continue
            mx = g.max()
            lower = g[g < mx]
            second = lower.max() if lower.size else mx
            if haploid:
                gi = best_gt_a[s]
            else:
                mn, mxg = sorted((best_gt_a[s], best_gt_b[s]))
                gi = mxg * (mxg + 1) // 2 + mn
            gl_diffs[s] = (mx - second if abs(mx - g[gi]) < 1e-10
                           else g[gi] - mx)

        if calc_pls:
            mx = gls.max(axis=1, keepdims=True)
            pls = np.minimum(999, (-10 * (gls - mx)).astype(np.int64))
        if not calc_gls:
            gls = None

    return GenotypeExtraction(best_a, best_b, best_gt_a, best_gt_b,
                              lpp, lup, hap_lpp, hap_lup,
                              gls, gl_diffs, pls, phased_gls)
