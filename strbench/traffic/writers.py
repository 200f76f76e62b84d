"""Frozen copies of the writers the benchmark's datasets go through.

BGZF blocks, BAM records with their BAI index, the tabix index of a
bgzipped VCF and the FASTA with its .fai: copies of
hipstr_tpu_torch/io/{bgzf,bam,tabix,fasta}.py (writer halves only) as they
stood when the benchmark was defined, so that a change to the program's
readers or writers cannot change the inputs the benchmark measures on.
The bytes they write equal the program's writers' (strbench/tests).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAX_BLOCK_SIZE = 65280
EOF_MARKER = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])
_SEQ_IDX = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
# byte -> 4-bit base code (15, N, for anything else), byte -> raw quality
_SEQ_CODE = np.full(256, 15, np.uint8)
for _c, _i in _SEQ_IDX.items():
    _SEQ_CODE[ord(_c)] = _i
_QUAL_RAW = bytes(min(93, max(0, b - 33)) for b in range(256))
_CIGAR_IDX = {c: i for i, c in enumerate("MIDNSHP=X")}


def _compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 25 + 1
    header = struct.pack("<BBBBIBBHBBHH", 0x1f, 0x8b, 0x08, 0x04, 0, 0, 0xff,
                         6, 0x42, 0x43, 2, bsize - 1)
    return header + payload + struct.pack("<II", zlib.crc32(data),
                                          len(data) & 0xffffffff)


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._coffset = 0

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK_SIZE:
            self._flush_block(MAX_BLOCK_SIZE)

    def _flush_block(self, n=None) -> None:
        n = len(self._buf) if n is None else n
        if n == 0:
            return
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        block = _compress_block(chunk, self._level)
        self._fh.write(block)
        self._coffset += len(block)

    def close(self) -> None:
        self._flush_block()
        self._fh.write(EOF_MARKER)
        self._fh.close()


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec 5.3)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def clean_draws(rng, n: int, rate: float) -> bool:
    """Draw the n uniforms of a read's per-base error test at once when
    none of them falls under `rate` (the stream then stands where n single
    draws leave it) and return True; else put the stream back and return
    False, for the caller's base-by-base loop.  The generators' bytes are
    those of the originals' loops, several times faster."""
    state = rng.bit_generator.state
    if not (rng.random(n) < rate).any():
        return True
    rng.bit_generator.state = state
    return False


def cigar_end(pos: int, cigar) -> int:
    """Exclusive reference end of a record."""
    return pos + sum(n for n, op in cigar if op in "MDN=X")


def encode_read(name: str, flag: int, ref_id: int, pos: int, cigar,
                seq: str, qual: str, rg: str) -> bytes:
    """One BAM record (mapq 60, no mate, one RG:Z tag), as
    io/bam.encode_record writes it."""
    name_b = name.encode() + b"\x00"
    cigar_b = b"".join(struct.pack("<I", (n << 4) | _CIGAR_IDX[op])
                       for n, op in cigar)
    l_seq = len(seq)
    codes = _SEQ_CODE[np.frombuffer(seq.upper().encode(), np.uint8)]
    if l_seq % 2:
        codes = np.append(codes, np.uint8(0))
    seq_b = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    qual_b = qual.encode("latin1").translate(_QUAL_RAW)
    tags_b = b"RGZ" + rg.encode() + b"\x00"
    bin_ = reg2bin(pos, cigar_end(pos, cigar))
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name_b), 60, bin_,
                       len(cigar), flag, l_seq, -1, -1, 0) \
        + name_b + cigar_b + seq_b + qual_b + tags_b
    return struct.pack("<I", len(body)) + body


class BamWriter:
    """Coordinate-sorted BAM writer with its BAI index; records come
    encoded (encode_read), with their (ref_id, pos, end)."""

    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 header_text: str):
        self.path = path
        self._w = BgzfWriter(path)
        self.ref_names = ref_names
        text = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        self._w.write(struct.pack("<i", len(ref_names)))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb
                          + struct.pack("<i", l))
        self._bins: List[Dict[int, List[Tuple[int, int]]]] = [
            dict() for _ in ref_names]
        self._linear: List[Dict[int, int]] = [dict() for _ in ref_names]
        self._last_key = None

    def write(self, ref_id: int, pos: int, end: int, encoded: bytes) -> None:
        key = (ref_id, pos)
        if self._last_key is not None and key < self._last_key:
            raise ValueError("records must be coordinate-sorted")
        self._last_key = key
        start_v = self._w.virtual_offset
        self._w.write(encoded)
        end_v = self._w.virtual_offset
        end_pos = max(end, pos + 1)
        chunks = self._bins[ref_id].setdefault(reg2bin(pos, end_pos), [])
        if chunks and chunks[-1][1] == start_v:
            chunks[-1] = (chunks[-1][0], end_v)
        else:
            chunks.append((start_v, end_v))
        lin = self._linear[ref_id]
        for win in range(pos >> 14, ((end_pos - 1) >> 14) + 1):
            if win not in lin or start_v < lin[win]:
                lin[win] = start_v

    def close(self) -> None:
        self._w.close()
        with open(self.path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01" + struct.pack("<i", len(self.ref_names)))
            for bins, linear in zip(self._bins, self._linear):
                fh.write(struct.pack("<i", len(bins)))
                for b in sorted(bins):
                    fh.write(struct.pack("<I", b)
                             + struct.pack("<i", len(bins[b])))
                    for cb, ce in bins[b]:
                        fh.write(struct.pack("<QQ", cb, ce))
                n_intv = max(linear) + 1 if linear else 0
                fh.write(struct.pack("<i", n_intv))
                prev = 0
                for win in range(n_intv):
                    prev = linear.get(win, prev)
                    fh.write(struct.pack("<Q", prev))


class TabixBuilder:
    """The VCF-preset .tbi of a bgzipped VCF written record by record."""

    def __init__(self):
        self.names: List[str] = []
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[Dict[int, int]] = []

    def add(self, chrom: str, beg: int, end: int, v_start: int,
            v_end: int) -> None:
        if not self.names or self.names[-1] != chrom:
            self.names.append(chrom)
            self.bins.append({})
            self.linear.append({})
        chunks = self.bins[-1].setdefault(reg2bin(beg, max(end, beg + 1)), [])
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
                out += struct.pack("<Ii", b, len(bd[b]))
                for u, v in bd[b]:
                    out += struct.pack("<QQ", u, v)
            n_intv = max(lin) + 1 if lin else 0
            out += struct.pack("<i", n_intv)
            prev, vals = 0, []
            for win in range(n_intv):
                prev = lin.get(win, prev)
                vals.append(prev)
            out += struct.pack(f"<{n_intv}Q", *vals)
        w = BgzfWriter(path)
        w.write(bytes(out))
        w.close()


def write_bgzipped_vcf(path: str, header_lines, records) -> None:
    """A bgzipped VCF and its .tbi, each record indexed over its REF."""
    w = BgzfWriter(path)
    tbi = TabixBuilder()
    w.write(("\n".join(header_lines) + "\n").encode())
    for line in records:
        cols = line.split("\t", 4)
        beg = int(cols[1]) - 1
        v0 = w.virtual_offset
        w.write((line + "\n").encode())
        tbi.add(cols[0], beg, beg + len(cols[3]), v0, w.virtual_offset)
    w.close()
    tbi.write(path + ".tbi")


def write_fasta(path: str, contigs, line_width: int = 60) -> None:
    """The FASTA and its .fai (one line width for every contig)."""
    fai = []
    pos = 0
    with open(path, "w") as fh:
        for name, seq in contigs:
            head = f">{name}\n"
            fh.write(head)
            pos += len(head)
            fai.append((name, len(seq), pos, min(line_width, len(seq)),
                        min(line_width, len(seq)) + 1))
            for i in range(0, len(seq), line_width):
                line = seq[i:i + line_width] + "\n"
                fh.write(line)
                pos += len(line)
    with open(path + ".fai", "w") as fh:
        for e in fai:
            fh.write("\t".join(str(x) for x in e) + "\n")
