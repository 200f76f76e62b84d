"""The plain reference of a VCF record's genotype fields: each sample's
GB, Q and PQ from its phased haplotype-pair posteriors.

HipSTR's extract_genotypes_and_likelihoods (reference src/genotyper.cpp:
129-251, the part that sets the called genotype and its posteriors)
written per locus in NumPy: the called haplotype pair is the phased pair
of greatest posterior; haplotype pairs are summed into pairs of repeat
alleles (each haplotype's repeat option); PQ is the called allele pair's
phased posterior, Q its unphased one (both orders summed for a het); GB
is each called allele's length less the reference allele's.  It imports
nothing of the program.
"""

from __future__ import annotations

import itertools

import numpy as np


def called(log_post: np.ndarray, hap_allele: np.ndarray,
           allele_bp: np.ndarray) -> list:
    """[(GB pair, Q, PQ)] per sample: log_post [S, H, H] phased haplotype
    pair posteriors, hap_allele [H] each haplotype's repeat allele,
    allele_bp [V] each allele's length less the reference allele's."""
    S, H, _ = log_post.shape
    V = int(hap_allele.max()) + 1
    post = np.exp(log_post.astype(np.float64))
    pair = np.zeros((S, V, V))
    np.add.at(pair, (slice(None), hap_allele[:, None], hap_allele[None, :]),
              post)
    out = []
    for s in range(S):
        best = int(np.argmax(log_post[s].reshape(-1)))
        a, b = hap_allele[best // H], hap_allele[best % H]
        pq = pair[s, a, b]
        q = pq if a == b else pq + pair[s, b, a]
        out.append(((int(allele_bp[a]), int(allele_bp[b])), float(q),
                    float(pq)))
    return out


def record_fields(text: str) -> list:
    """[(GB pair, Q, PQ, GB of the GT's alleles by the record's own
    REF/ALT)] per sample of a HipSTR VCF record line (FORMAT GT:GB:Q:PQ:
    ...); None for a sample without a call."""
    cols = text.rstrip("\n").split("\t")
    alleles = [cols[3]] + (cols[4].split(",") if cols[4] != "." else [])
    keys = cols[8].split(":")
    out = []
    for sample in cols[9:]:
        f = dict(zip(keys, sample.split(":")))
        if f.get("GT", ".") in (".", "./.") or "PQ" not in f:
            out.append(None)
            continue
        gt = [int(x) for x in f["GT"].split("|")]
        gb = tuple(int(x) for x in f["GB"].split("|"))
        by_gt = tuple(len(alleles[g]) - len(alleles[0]) for g in gt)
        out.append((gb, float(f["Q"]), float(f["PQ"]), by_gt))
    return out


def sample_order(read_bp: np.ndarray, read_sample: np.ndarray,
                 truth: dict, names: list) -> list:
    """The name of each of the locus's samples (by the genotyper's own
    sample index), worked out from the reads: each sample's reads' best
    alleles (read_bp, each read's length change by the reference LLs)
    against each name's reads' length changes as the generator made them
    (truth {name: {change: reads}}); the assignment that shares the most
    reads."""
    S = int(read_sample.max()) + 1 if read_sample.size else 0
    have = [dict(zip(*np.unique(read_bp[read_sample == s],
                                return_counts=True))) for s in range(S)]
    want = [{int(d): n for d, n in truth[nm].items()} for nm in names]
    share = np.array([[sum(min(int(c), w.get(int(d), 0))
                           for d, c in h.items()) for w in want]
                      for h in have])
    best = max(itertools.permutations(range(len(names)), S),
               key=lambda p: sum(share[s, p[s]] for s in range(S)))
    return [names[j] for j in best]
