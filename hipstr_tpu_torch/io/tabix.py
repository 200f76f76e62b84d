"""Copy of hipstr_tpu/io/tabix.py.

Tabix (.tbi) index reading and writing for bgzipped, coordinate-sorted
tab-delimited files (VCF preset).

Independent implementation from the public tabix format specification
(https://samtools.github.io/hts-specs/tabix.pdf); the binning scheme is the
same UCSC scheme as BAI (io/bam.py reg2bin/reg2bins).  Gives the reference's
capability of region-seeking huge SNP/ref VCFs without loading them
(reference: src/vcf_reader.cpp over htslib tbx).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

from .bam import reg2bin, reg2bins
from .bgzf import BgzfWriter


class TabixIndex:
    def __init__(self, names: List[str],
                 bins: List[Dict[int, List[Tuple[int, int]]]],
                 linear: List[List[int]],
                 preset: int = 2, col_seq: int = 1, col_beg: int = 2,
                 col_end: int = 2, meta: int = ord("#"), skip: int = 0):
        self.names = names
        self.name_index = {n: i for i, n in enumerate(names)}
        self.bins = bins
        self.linear = linear
        self.preset = preset
        self.col_seq = col_seq
        self.col_beg = col_beg
        self.col_end = col_end
        self.meta = meta
        self.skip = skip

    def chunks(self, chrom: str, start: int, end: int) -> List[Tuple[int, int]]:
        """Candidate (virtual_start, virtual_end) chunks for [start, end)."""
        rid = self.name_index.get(chrom)
        if rid is None:
            return []
        lin = self.linear[rid]
        win = start >> 14
        min_off = lin[win] if win < len(lin) else (lin[-1] if lin else 0)
        out = []
        for b in reg2bins(start, end):
            for u, v in self.bins[rid].get(b, ()):
                if v > min_off:
                    out.append((max(u, min_off), v))
        out.sort()
        # merge adjacent/overlapping chunks
        merged: List[Tuple[int, int]] = []
        for u, v in out:
            if merged and u <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], v))
            else:
                merged.append((u, v))
        return merged


def read_tabix(path: str) -> TabixIndex:
    try:
        from .bgzf import BgzfReader
        data = BgzfReader(path).read_all()
    except Exception:
        # plain (non-BGZF) gzip members: inflate them all
        with open(path, "rb") as fh:
            raw = fh.read()
        data = b""
        d = zlib.decompressobj(zlib.MAX_WBITS | 32)
        while raw:
            data += d.decompress(raw)
            raw = d.unused_data
            if raw:
                d = zlib.decompressobj(zlib.MAX_WBITS | 32)
    if data[:4] != b"TBI\x01":
        raise ValueError(f"{path} is not a tabix index")
    off = 4
    (n_ref, preset, col_seq, col_beg, col_end, meta, skip,
     l_nm) = struct.unpack_from("<8i", data, off)
    off += 32
    names = data[off:off + l_nm].split(b"\x00")[:n_ref]
    names = [n.decode() for n in names]
    off += l_nm
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[List[int]] = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bd: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                u, v = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((u, v))
            bd[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins.append(bd)
        linear.append(lin)
    return TabixIndex(names, bins, linear, preset, col_seq, col_beg,
                      col_end, meta, skip)


class TabixBuilder:
    """Accumulates (chrom, beg, end, virtual_start, virtual_end) records and
    writes a VCF-preset .tbi."""

    def __init__(self):
        self.names: List[str] = []
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[Dict[int, int]] = []

    def add(self, chrom: str, beg: int, end: int,
            v_start: int, v_end: int) -> None:
        if not self.names or self.names[-1] != chrom:
            if chrom in self.names:
                raise ValueError("records must be chromosome-grouped")
            self.names.append(chrom)
            self.bins.append({})
            self.linear.append({})
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins[-1].setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        lin = self.linear[-1]
        for win in range(beg >> 14, (max(end - 1, beg) >> 14) + 1):
            if win not in lin or v_start < lin[win]:
                lin[win] = v_start

    def write(self, path: str) -> None:
        out = bytearray(b"TBI\x01")
        nm = b"".join(n.encode() + b"\x00" for n in self.names)
        out += struct.pack("<8i", len(self.names), 2, 1, 2, 0, ord("#"), 0,
                           len(nm))
        out += nm
        for bd, lin in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bd))
            for b in sorted(bd):
                chunks = bd[b]
                out += struct.pack("<Ii", b, len(chunks))
                for u, v in chunks:
                    out += struct.pack("<QQ", u, v)
            n_intv = max(lin) + 1 if lin else 0
            out += struct.pack("<i", n_intv)
            prev = 0
            vals = []
            for win in range(n_intv):
                if win in lin:
                    prev = lin[win]
                vals.append(prev)
            out += struct.pack(f"<{n_intv}Q", *vals)
        w = BgzfWriter(path)
        w.write(bytes(out))
        w.close()
