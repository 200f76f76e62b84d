"""Fused genotype posteriors for a batch of loci, in PyTorch.

Counterpart of hipstr_tpu/ops/posteriors.py::batched_pool_posteriors (an
XLA op in the JAX package, not a Pallas kernel; reference
src/genotyper.cpp:44-80 plus the mate-pair LL summing of
seq_stutter_genotyper.cpp:530-564).  The per-sample sum is a contraction
with a one-hot [G, R, Sm] sample matrix in the working dtype (TF32 is off,
device.py), so the result does not depend on the order atomics land in:
the VCF is the same from run to run.
"""

from __future__ import annotations

import math

import torch

NEG = -1.0e30
LOG_ONE_HALF = math.log(0.5)


def batched_pool_posteriors(LL, pm: dict, Sm: int, dtype):
    """(log_post [G, Sm, H, H], totals [G, Sm]) straight from the
    [G, P, H] pool LLs of the HMM dispatch.

    pm is the stacked padded posterior-meta dict (hap_aligner.prepare_locus):
    pool_row/mate_index/sample [G, R] int, has_mate/read_ok [G, R] bool,
    weights/log_p1/log_p2 [G, R], col_index [G, H], n_alleles [G],
    haploid [G].  Padded reads carry weight 0; alleles >= n_alleles[g] are
    masked NEG."""
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

    onehot = torch.nn.functional.one_hot(pm["sample"].long(), Sm).to(dtype)
    sums = torch.bmm(onehot.transpose(1, 2),
                     contrib.reshape(G, R, H * H)).reshape(G, Sm, H, H)
    unnorm = priors[:, None] + sums
    unnorm = torch.where(gmask[:, None], unnorm, NEG)
    flat = unnorm.reshape(G, Sm, H * H)
    mx = torch.amax(flat, dim=2)
    totals = mx + torch.log(torch.sum(torch.exp(flat - mx[:, :, None]), dim=2))
    log_post = unnorm - totals[:, :, None, None]
    return log_post, totals
