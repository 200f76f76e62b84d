"""Copy of hipstr_tpu/phasing/haplotype_tracker.py.

Sliding-window family SNP haplotype tracking.

Capability parity with the reference HaplotypeTracker / DiploidHaplotype
(reference: src/haplotype_tracker.{h,cpp}): a +/-window of phased family SNP
genotypes per sample, child<->parent haplotype edit distances, and inference
of the family inheritance pattern with best/second-best score gates.

Re-design: the reference packs SNP alleles into 63-bit words in deques; here
each sample's window haplotypes are numpy uint8 vectors (XOR + popcount via
vector ops), kept for the window and moved along the indexed VCF.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..io.vcf_read import VCFReader
from .pedigree import NuclearFamily


class HaplotypeTracker:
    def __init__(self, families: List[NuclearFamily], snp_vcf: VCFReader,
                 window_size: int = 500000):
        self.families = families
        self.snp_vcf = snp_vcf
        self.window_size = window_size
        self._samples: List[str] = []
        for fam in families:
            self._samples.extend(fam.get_samples())
        # each sample's places among the family members (a sample in two
        # families is two members)
        self._member_index: Dict[str, List[int]] = {}
        for i, s in enumerate(self._samples):
            self._member_index.setdefault(s, []).append(i)
        self._chrom: Optional[str] = None
        self._position = -1
        self._skip: Set[str] = set()
        self._window: Tuple[int, int] = (-1, -1)
        self.positions: List[int] = []           # 1-based VCF positions
        # per SNP: [members, 2] uint8, (a == 1, b == 1) of each member
        self._rows: List[np.ndarray] = []
        self._h1: Dict[str, np.ndarray] = {}
        self._h2: Dict[str, np.ndarray] = {}

    def num_stored_snps(self) -> int:
        return len(self.positions)

    def advance(self, chrom: str, position: int,
                sites_to_skip: Optional[Set[str]] = None) -> None:
        """Load the +/-window around `position` (reference:
        HaplotypeTracker::advance, haplotype_tracker.cpp:85-121).

        Unlike the JAX package's copy, which rebuilds the window from the
        VCF on every call, a call on the same chromosome at a position at
        or past the last one (with the same sites to skip) moves the
        window as the reference does: SNPs left of it are dropped and only
        the SNPs past the old window's end are read.  The haplotypes are
        the same either way."""
        sites_to_skip = sites_to_skip or set()
        start = max(0, position - self.window_size)
        end = position + self.window_size
        moving = (chrom == self._chrom and position >= self._position
                  and sites_to_skip == self._skip)
        if moving:
            keep = bisect.bisect_left(self.positions, start + 1)
            self.positions = self.positions[keep:]
            self._rows = self._rows[keep:]
            read_from = max(start, self._window[1])
        else:
            self.positions, self._rows = [], []
            read_from = start
        self._chrom, self._position = chrom, position
        self._skip = set(sites_to_skip)
        self._window = (start, end)

        new = self.snp_vcf.query(chrom, read_from, end) \
            if read_from < end else ()
        for variant in new:
            key = f"{variant.chrom}:{variant.pos + 1}"
            if key in sites_to_skip:
                continue
            self.positions.append(variant.pos + 1)
            # one (a == 1, b == 1) pair per family member, in family order
            row = []
            for fam in self.families:
                use_gts = not (fam.is_missing_genotype(variant)
                               or not fam.is_mendelian(variant))
                for s in fam.get_samples():
                    if use_gts:
                        a, b, _ = variant.genotype(s)
                    else:
                        a = b = 0
                    row.append((1 if a == 1 else 0, 1 if b == 1 else 0))
            self._rows.append(np.array(row, dtype=np.uint8).reshape(-1, 2))
        bits = np.stack(self._rows) if self._rows else np.zeros(
            (0, len(self._samples), 2), np.uint8)
        # a sample in several families has one entry per SNP and family
        for s, idx in self._member_index.items():
            self._h1[s] = bits[:, idx, 0].reshape(-1)
            self._h2[s] = bits[:, idx, 1].reshape(-1)

    def edit_distances(self, sample_a: str, sample_b: str) -> np.ndarray:
        """2x2 matrix of haplotype edit distances (reference:
        DiploidHaplotype::edit_distances)."""
        out = np.zeros((2, 2), dtype=np.int64)
        ha = (self._h1[sample_a], self._h2[sample_a])
        hb = (self._h1[sample_b], self._h2[sample_b])
        for i in range(2):
            for j in range(2):
                out[i, j] = int(np.sum(ha[i] != hb[j]))
        return out

    def infer_haplotype_inheritance(self, family: NuclearFamily,
                                    max_best_score: int,
                                    min_second_best_score: int,
                                    bad_sites: Optional[Set[int]] = None
                                    ) -> Tuple[bool, List[int], List[int], Set[int]]:
        """Reference: haplotype_tracker.cpp:133-183.  Returns
        (ok, maternal_indices, paternal_indices, bad_sites) where indices
        encode child-parent haplotype pairings 0..3 (1+1, 1+2, 2+1, 2+2)."""
        bad_sites = bad_sites if bad_sites is not None else set()
        maternal: List[int] = []
        paternal: List[int] = []
        mismatch_idx: Set[int] = set()
        positions = np.array(self.positions)

        for child in family.children:
            md = self.edit_distances(child, family.mother).reshape(-1)
            order = np.argsort(md, kind="stable")
            min_mat, second_mat = int(md[order[0]]), int(md[order[1]])
            min_mat_index = int(order[0])
            if min_mat > max_best_score or second_mat < min_second_best_score:
                return False, [], [], bad_sites

            pd = self.edit_distances(child, family.father).reshape(-1)
            order = np.argsort(pd, kind="stable")
            min_pat, second_pat = int(pd[order[0]]), int(pd[order[1]])
            min_pat_index = int(order[0])
            if min_pat > max_best_score or second_pat < min_second_best_score:
                return False, [], [], bad_sites

            # the maternal and paternal matches must involve different child
            # haplotypes
            if min_mat_index in (0, 1):
                if min_pat_index not in (2, 3):
                    return False, [], [], bad_sites
            elif min_pat_index not in (0, 1):
                return False, [], [], bad_sites

            # inconsistent sites under the chosen inheritance pattern
            ch = (self._h1[child], self._h2[child])
            mh = (self._h1[family.mother], self._h2[family.mother])
            ph = (self._h1[family.father], self._h2[family.father])
            ia = 0 if min_mat_index in (0, 1) else 1
            ib = 0 if min_mat_index in (0, 2) else 1
            mismatch = np.nonzero(ch[ia] != mh[ib])[0]
            mismatch_idx.update(int(x) for x in mismatch)
            ia = 0 if min_pat_index in (0, 1) else 1
            ib = 0 if min_pat_index in (0, 2) else 1
            mismatch = np.nonzero(ch[ia] != ph[ib])[0]
            mismatch_idx.update(int(x) for x in mismatch)

            maternal.append(min_mat_index)
            paternal.append(min_pat_index)

        for idx in mismatch_idx:
            bad_sites.add(int(positions[idx]))
        return True, maternal, paternal, bad_sites
