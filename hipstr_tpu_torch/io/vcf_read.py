"""Copy of hipstr_tpu/io/vcf_read.py.

VCF reading (plain or BGZF-compressed).

Capability parity with the reference's htslib-backed VCF::VCFReader/Variant
(reference: src/vcf_reader.{h,cpp}): sample indexing, region queries, typed
INFO/FORMAT access, phased-genotype extraction with missing tracking.
Region queries scan chromosome-ordered records with a per-chromosome offset
cache (a .tbi reader can slot in later without changing the interface).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader


@dataclass
class VcfVariant:
    chrom: str
    pos: int                  # 0-based
    vid: str
    alleles: List[str]        # ref + alts
    qual: str
    vfilter: str
    info: Dict[str, str]
    format_keys: List[str]
    sample_fields: List[List[str]]
    samples: List[str]
    _sample_index: Dict[str, int]

    @property
    def ref(self) -> str:
        return self.alleles[0]

    def num_alleles(self) -> int:
        return len(self.alleles)

    def is_biallelic_snp(self) -> bool:
        return len(self.alleles) == 2 and all(len(a) == 1 for a in self.alleles)

    def has_info(self, key: str) -> bool:
        return key in self.info

    def get_info_int(self, key: str) -> Optional[int]:
        v = self.info.get(key)
        return None if v is None else int(v)

    def get_info_float(self, key: str) -> Optional[float]:
        v = self.info.get(key)
        return None if v is None else float(v)

    def sample_field(self, key: str, sample: str) -> Optional[str]:
        try:
            ki = self.format_keys.index(key)
        except ValueError:
            return None
        si = self._sample_index.get(sample)
        if si is None:
            return None
        parts = self.sample_fields[si]
        if ki >= len(parts):
            return None
        return parts[ki]

    def genotype(self, sample: str) -> Optional[Tuple[int, int, bool]]:
        """(gt_a, gt_b, phased) or None if missing."""
        gt = self.sample_field("GT", sample)
        if gt is None or gt.startswith("."):
            return None
        phased = "|" in gt
        sep = "|" if phased else "/"
        parts = gt.split(sep)
        if len(parts) == 1:
            a = int(parts[0])
            return (a, a, True)
        if parts[0] == "." or parts[1] == ".":
            return None
        return (int(parts[0]), int(parts[1]), phased)

    def gl_matrix(self, key: str = "GL") -> Dict[str, List[float]]:
        out = {}
        for s in self.samples:
            v = self.sample_field(key, s)
            if v is not None and v != ".":
                out[s] = [float(x) for x in v.split(",")]
        return out


class VCFReader:
    def __init__(self, path: str):
        self.path = path
        # Tabix streaming mode: with a .tbi present, queries seek BGZF
        # chunks instead of loading the file (reference capability:
        # src/vcf_reader.cpp htslib tbx region seek) — required for
        # multi-GB SNP VCFs.
        self._tbi = None
        import os
        if os.path.exists(path + ".tbi"):
            try:
                from .tabix import read_tabix
                self._tbi = read_tabix(path + ".tbi")
            except Exception:
                self._tbi = None
        if self._tbi is not None:
            self._init_streaming(path)
            return
        self._lines = self._read_lines(path)
        self.samples: List[str] = []
        self._sample_index: Dict[str, int] = {}
        self._header_end = 0
        for i, line in enumerate(self._lines):
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                self.samples = cols[9:]
                self._sample_index = {s: j for j, s in enumerate(self.samples)}
                self._header_end = i + 1
                break
        # chromosome -> (first record index, last+1)
        self._chrom_ranges: Dict[str, Tuple[int, int]] = {}
        cur = None
        start = self._header_end
        for i in range(self._header_end, len(self._lines)):
            c = self._lines[i].split("\t", 1)[0]
            if c != cur:
                if cur is not None:
                    self._chrom_ranges[cur] = (start, i)
                cur = c
                start = i
        if cur is not None:
            self._chrom_ranges[cur] = (start, len(self._lines))

    def _init_streaming(self, path: str) -> None:
        from .bgzf import BgzfReader
        self._bgzf = BgzfReader(path)
        self._lines = None
        self.samples = []
        self._sample_index = {}
        header = []
        buf = b""
        while True:
            chunk = self._bgzf.read(65536)
            if not chunk:
                break
            buf += chunk
            stop = False
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                text = line.decode("latin1")
                if text.startswith("##"):
                    header.append(text)
                    continue
                if text.startswith("#CHROM"):
                    cols = text.split("\t")
                    self.samples = cols[9:]
                    self._sample_index = {s: j
                                          for j, s in enumerate(self.samples)}
                stop = True
                break
            if stop:
                break
        self._chrom_ranges = {n: None for n in self._tbi.names}

    def _stream_query(self, chrom: str, start: int, end: int):
        chunks = self._tbi.chunks(chrom, start, end)
        for u, v in chunks:
            self._bgzf.seek_virtual(u)
            buf = b""
            done = False
            while not done:
                if self._bgzf.virtual_offset >= v and b"\n" not in buf:
                    break
                chunk = self._bgzf.read(65536)
                if not chunk:
                    done = True
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    text = line.decode("latin1")
                    if not text or text.startswith("#"):
                        continue
                    cols = text.split("\t", 2)
                    if cols[0] != chrom:
                        if self._tbi.name_index.get(cols[0], -1) > \
                                self._tbi.name_index.get(chrom, -1):
                            done = True
                            break
                        continue
                    pos = int(cols[1]) - 1
                    if pos >= end:
                        done = True
                        break
                    if pos < start:
                        continue
                    yield self._parse(text)

    @staticmethod
    def _read_lines(path: str) -> List[str]:
        with open(path, "rb") as fh:
            magic = fh.read(2)
        if magic == b"\x1f\x8b":
            try:
                data = BgzfReader(path).read_all()
            except ValueError:
                with gzip.open(path, "rb") as fh:
                    data = fh.read()
            return data.decode("latin1").splitlines()
        with open(path) as fh:
            return fh.read().splitlines()

    def has_chrom(self, chrom: str) -> bool:
        return chrom in self._chrom_ranges

    def chromosomes(self) -> List[str]:
        return list(self._chrom_ranges)

    def _parse(self, line: str) -> VcfVariant:
        cols = line.rstrip("\n").split("\t")
        alts = [] if cols[4] in (".", "") else cols[4].split(",")
        info = {}
        for kv in cols[7].split(";"):
            if "=" in kv:
                k, v = kv.split("=", 1)
                info[k] = v
            elif kv:
                info[kv] = ""
        fmt = cols[8].split(":") if len(cols) > 8 else []
        sample_fields = [c.split(":") for c in cols[9:]]
        return VcfVariant(cols[0], int(cols[1]) - 1, cols[2],
                          [cols[3]] + alts, cols[5], cols[6], info, fmt,
                          sample_fields, self.samples, self._sample_index)

    def __iter__(self) -> Iterator[VcfVariant]:
        if self._lines is None:
            self._bgzf.seek_virtual(0)
            buf = b""
            while True:
                chunk = self._bgzf.read(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    text = line.decode("latin1")
                    if text and not text.startswith("#"):
                        yield self._parse(text)
            return
        for i in range(self._header_end, len(self._lines)):
            yield self._parse(self._lines[i])

    def query(self, chrom: str, start: int, end: int) -> Iterator[VcfVariant]:
        """Variants with pos in [start, end) (0-based)."""
        if self._lines is None:
            yield from self._stream_query(chrom, start, end)
            return
        rng = self._chrom_ranges.get(chrom)
        if rng is None:
            return
        import bisect
        lo, hi = rng
        if not hasattr(self, "_pos_cache"):
            self._pos_cache = {}
        positions = self._pos_cache.get(chrom)
        if positions is None:
            positions = [int(self._lines[i].split("\t", 2)[1]) - 1
                         for i in range(lo, hi)]
            self._pos_cache[chrom] = positions
        left = bisect.bisect_left(positions, start)
        for i in range(lo + left, hi):
            v = self._parse(self._lines[i])
            if v.pos >= end:
                break
            yield v


def read_vcf_alleles(ref_vcf: "VCFReader", region) -> Optional[Tuple[int, List[str]]]:
    """Match a reference-panel VCF record to a BED region via its START/END
    INFO tags within a +/-50 bp pad; returns (pos_0based, alleles) or None.

    Reference: read_vcf_alleles (src/vcf_input.cpp:21-50).
    """
    pad = 50
    pad_start = max(0, region.start - pad)
    for variant in ref_vcf.query(region.chrom, pad_start, region.stop + pad):
        if "START" not in variant.info or "END" not in variant.info:
            continue
        str_start = int(variant.info["START"])
        str_stop = int(variant.info["END"])
        if str_start == region.start + 1 and str_stop == region.stop:
            return variant.pos, list(variant.alleles)
        if variant.pos + 1 > region.start + pad:
            break
    return None
