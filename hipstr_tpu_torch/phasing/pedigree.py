"""Copy of hipstr_tpu/phasing/pedigree.py.

Pedigree parsing into nuclear families.

Capability parity with the reference pedigree module (reference:
src/pedigree.{h,cpp}): FAM-file graph, pruning to samples with data,
decomposition into simple nuclear families, and per-variant missing-genotype
and Mendelian-consistency checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from ..io.vcf_read import VcfVariant


@dataclass
class NuclearFamily:
    family_id: str
    mother: str
    father: str
    children: List[str]

    def size(self) -> int:
        return 2 + len(self.children)

    def get_samples(self) -> List[str]:
        return [self.mother, self.father] + list(self.children)

    def is_missing_genotype(self, variant: VcfVariant) -> bool:
        return any(variant.genotype(s) is None for s in self.get_samples())

    def is_mendelian(self, variant: VcfVariant) -> bool:
        """Reference: NuclearFamily::is_mendelian (pedigree.h:68-84)."""
        gm = variant.genotype(self.mother)
        gf = variant.genotype(self.father)
        if gm is None or gf is None:
            return False
        m1, m2, _ = gm
        f1, f2, _ = gf
        for child in self.children:
            gc = variant.genotype(child)
            if gc is None:
                return False
            c1, c2, _ = gc
            ok_a = (c1 in (m1, m2)) and (c2 in (f1, f2))
            ok_b = (c1 in (f1, f2)) and (c2 in (m1, m2))
            if not (ok_a or ok_b):
                return False
        return True


def parse_fam_file(path: str) -> List[dict]:
    rows = []
    with open(path) as fh:
        for line in fh:
            toks = line.split()
            if len(toks) < 4 or line.startswith("#"):
                continue
            rows.append(dict(family=toks[0], child=toks[1],
                             father=toks[2], mother=toks[3]))
    return rows


def extract_pedigree_nuclear_families(path: str, samples_with_data: Set[str]
                                      ) -> List[NuclearFamily]:
    """Prune the pedigree to samples with data and keep simple nuclear
    families (reference: pedigree.cpp extract_pedigree_nuclear_families)."""
    rows = parse_fam_file(path)
    present = samples_with_data

    # group children by (mother, father) among fully-present trios
    groups: Dict[tuple, List[str]] = {}
    fam_of: Dict[tuple, str] = {}
    parents: Set[str] = set()
    children: Set[str] = set()
    for r in rows:
        if r["father"] in ("0", "") or r["mother"] in ("0", ""):
            continue
        if r["child"] not in present or r["father"] not in present \
                or r["mother"] not in present:
            continue
        key = (r["mother"], r["father"])
        groups.setdefault(key, []).append(r["child"])
        fam_of[key] = r["family"]
        parents.update(key)
        children.add(r["child"])

    # a component is "nuclear" when the parents themselves aren't children of
    # other present samples and the children have no present offspring
    fams = []
    for (mother, father), kids in sorted(groups.items()):
        if mother in children or father in children:
            continue
        if any(k in parents for k in kids):
            continue
        fams.append(NuclearFamily(fam_of[(mother, father)], mother, father,
                                  sorted(kids)))
    return fams
