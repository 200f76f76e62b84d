"""The plain reference of the fused genotype posteriors: each sample's
phased genotype posteriors from a locus's read x haplotype LLs.

HipSTR's calc_log_sample_posteriors (reference src/genotyper.cpp:20-80,
with the mate-pair LL sum of seq_stutter_genotyper.cpp:530-564) written
per locus in plain PyTorch: each read takes its pool's LLs (the columns
of the current alleles), adds its mate's, mixes the two phases with the
read's phase weights, and the weighted contributions are summed per
sample in the reads' order; genotype priors are uniform over phased
genotypes (1/(A(A+1)) het, 2/(A(A+1)) hom; 1/A haploid).  It imports
nothing of the program: the read-to-pool map, mates, weights, phases,
samples and allele columns are the dispatch's packed posterior inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_ONE_HALF = math.log(0.5)


def sample_posteriors(LL, pm: dict, dtype):
    """(log_post [S, A, A], totals [S], samples with reads [S] bool) of one
    locus: LL [P, H] (any float tensor), pm the locus's padded posterior
    meta (numpy)."""
    dev = LL.device
    A = int(pm["n_alleles"])
    cols = torch.as_tensor(np.asarray(pm["col_index"])[:A], device=dev).long()
    LL = LL.to(dtype)[:, cols]                                # [P, A]
    w = torch.as_tensor(np.asarray(pm["weights"]), device=dev).to(dtype)
    keep = w != 0
    rows = torch.as_tensor(np.asarray(pm["pool_row"]), device=dev).long()
    ok = torch.as_tensor(np.asarray(pm["read_ok"]), device=dev).bool()
    read_ll = torch.where(ok[:, None], LL[rows], torch.zeros((), dtype=dtype,
                                                             device=dev))
    mate = torch.as_tensor(np.asarray(pm["mate_index"]), device=dev).long()
    has = torch.as_tensor(np.asarray(pm["has_mate"]), device=dev).bool()
    comb = read_ll + torch.where(has[:, None], read_ll[mate],
                                 torch.zeros((), dtype=dtype, device=dev))
    p1 = torch.as_tensor(np.asarray(pm["log_p1"]), device=dev).to(dtype)
    p2 = torch.as_tensor(np.asarray(pm["log_p2"]), device=dev).to(dtype)
    t1 = (LOG_ONE_HALF + p1[:, None] + comb)[:, :, None]
    t2 = (LOG_ONE_HALF + p2[:, None] + comb)[:, None, :]
    contrib = w[:, None, None] * torch.logaddexp(t1, t2)      # [R, A, A]
    sample = torch.as_tensor(np.asarray(pm["sample"]), device=dev).long()
    S = int(sample[keep].max()) + 1 if bool(keep.any()) else 0
    sums = torch.zeros((S, A, A), dtype=dtype, device=dev)
    sums.index_add_(0, sample[keep], contrib[keep])
    present = torch.zeros(S, dtype=torch.bool, device=dev)
    present[sample[keep]] = True
    eye = torch.eye(A, dtype=torch.bool, device=dev)
    if bool(np.asarray(pm["haploid"])):
        homo, het = -math.log(A), -1e30
    else:
        homo = math.log(2.0) - math.log(A) - math.log(A + 1)
        het = -math.log(A) - math.log(A + 1)
    pri = torch.where(eye, torch.tensor(homo, dtype=dtype, device=dev),
                      torch.tensor(het, dtype=dtype, device=dev))
    unnorm = pri[None] + sums
    totals = torch.logsumexp(unnorm.reshape(S, A * A), dim=1)
    return unnorm - totals[:, None, None], totals, present
