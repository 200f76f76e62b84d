"""Copy of hipstr_tpu/io/fasta.py.

FASTA reading/writing with .fai indexing.

Capability parity with the reference's faidx-backed FastaReader (reference:
src/fasta_reader.{h,cpp} over htslib faidx): indexed chromosome fetch, a
file-or-directory entry point, and ##contig VCF header lines.  Written from
the public faidx format description.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


class FastaReader:
    def __init__(self, path: str):
        """`path` is a FASTA file or a directory of per-chromosome FASTAs."""
        self._sources: Dict[str, Tuple[str, int, int, int, int]] = {}
        self._order: List[str] = []
        self._cache: Dict[str, str] = {}
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.endswith((".fa", ".fasta")):
                    self._index_file(os.path.join(path, name))
        else:
            self._index_file(path)

    def _index_file(self, path: str) -> None:
        fai = path + ".fai"
        if not os.path.exists(fai):
            write_fai(path)
        with open(fai) as fh:
            for line in fh:
                name, length, offset, linebases, linewidth = line.split()[:5]
                self._sources[name] = (path, int(length), int(offset),
                                       int(linebases), int(linewidth))
                self._order.append(name)

    def contigs(self) -> List[Tuple[str, int]]:
        return [(n, self._sources[n][1]) for n in self._order]

    def has_chrom(self, chrom: str) -> bool:
        return chrom in self._sources

    def chrom_length(self, chrom: str) -> int:
        return self._sources[chrom][1]

    def get_sequence(self, chrom: str) -> str:
        if chrom not in self._cache:
            path, length, offset, linebases, linewidth = self._sources[chrom]
            nlines = (length + linebases - 1) // linebases
            nbytes = length + nlines * (linewidth - linebases)
            with open(path, "rb") as fh:
                fh.seek(offset)
                raw = fh.read(nbytes)
            self._cache[chrom] = raw.decode("latin1").replace("\n", "") \
                .replace("\r", "")
            # keep at most a couple of chromosomes resident
            if len(self._cache) > 2:
                for k in list(self._cache):
                    if k != chrom:
                        del self._cache[k]
                        break
        return self._cache[chrom]

    def get_subsequence(self, chrom: str, start: int, stop: int) -> str:
        return self.get_sequence(chrom)[start:stop]

    def contig_header_lines(self) -> List[str]:
        return [f"##contig=<ID={n},length={self._sources[n][1]}>"
                for n in self._order]


def write_fasta(path: str, contigs: List[Tuple[str, str]],
                line_width: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
    write_fai(path)


def write_fai(path: str) -> None:
    """Build the .fai index for an existing FASTA file."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = linewidth = 0
        pos = 0
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + len(raw)
                linebases = linewidth = 0
            else:
                if linebases == 0 and line:
                    linebases = len(line)
                    linewidth = len(raw)
                length += len(line)
            pos += len(raw)
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(path + ".fai", "w") as fh:
        for e in entries:
            fh.write("\t".join(str(x) for x in e) + "\n")
