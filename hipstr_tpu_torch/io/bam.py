"""Copy of hipstr_tpu/io/bam.py.

BAM reading/writing with BAI indexing (no external dependencies).

Independent implementation of the BAM encoding and the BAI binning index from
the public SAM/BAM specification.  Capability parity with the role of the
reference's htslib-backed bam_io layer (reference: src/bam_io.{h,cpp} over
lib/htslib): read-group-aware headers, per-region record iteration, and
writing coordinate-sorted indexed BAMs (the simulator uses the writer to
produce inputs for golden comparisons against the reference binary).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader, BgzfWriter

_SEQ_CODE = "=ACMGRSVTWYHKDBN"
_SEQ_IDX = {c: i for i, c in enumerate(_SEQ_CODE)}
_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_IDX = {c: i for i, c in enumerate(_CIGAR_OPS)}


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int          # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, str]]   # (length, op)
    mate_ref_id: int
    mate_pos: int
    tlen: int
    seq: str
    qual: str                       # phred+33 string
    tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & 0x1)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_mate_unmapped(self) -> bool:
        return bool(self.flag & 0x8)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_first_mate(self) -> bool:
        return bool(self.flag & 0x40)

    @property
    def is_second_mate(self) -> bool:
        return bool(self.flag & 0x80)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & 0x400)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 0x800)

    def end_position(self) -> int:
        """Exclusive reference end (htslib GetEndPosition semantics)."""
        end = self.pos
        for n, op in self.cigar:
            if op in "MDN=X":
                end += n
        return end

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar)


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    out = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return out


def _encode_tags(tags: Dict[str, Tuple[str, object]]) -> bytes:
    out = bytearray()
    for tag, (ttype, val) in tags.items():
        out.extend(tag.encode())
        if ttype == "Z":
            out.append(ord("Z"))
            out.extend(str(val).encode() + b"\x00")
        elif ttype == "i":
            out.append(ord("i"))
            out.extend(struct.pack("<i", int(val)))
        elif ttype == "A":
            out.append(ord("A"))
            out.extend(str(val)[:1].encode())
        elif ttype == "f":
            out.append(ord("f"))
            out.extend(struct.pack("<f", float(val)))
        else:
            raise ValueError(f"unsupported tag type {ttype}")
    return bytes(out)


def _decode_tags(buf: bytes) -> Dict[str, Tuple[str, object]]:
    tags: Dict[str, Tuple[str, object]] = {}
    i = 0
    int_fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}
    while i + 3 <= len(buf):
        tag = buf[i:i + 2].decode()
        ttype = chr(buf[i + 2])
        i += 3
        if ttype == "Z" or ttype == "H":
            j = buf.index(b"\x00", i)
            tags[tag] = ("Z", buf[i:j].decode("latin1"))
            i = j + 1
        elif ttype == "A":
            tags[tag] = ("A", chr(buf[i]))
            i += 1
        elif ttype in int_fmt:
            size = struct.calcsize(int_fmt[ttype])
            tags[tag] = ("i", struct.unpack(int_fmt[ttype], buf[i:i + size])[0])
            i += size
        elif ttype == "f":
            tags[tag] = ("f", struct.unpack("<f", buf[i:i + 4])[0])
            i += 4
        elif ttype == "B":
            sub = chr(buf[i])
            n = struct.unpack("<I", buf[i + 1:i + 5])[0]
            size = struct.calcsize(int_fmt.get(sub, "<f"))
            i += 5 + n * size
        else:
            raise ValueError(f"unsupported tag type {ttype}")
    return tags


def encode_record(rec: BamRecord) -> bytes:
    name_b = rec.name.encode() + b"\x00"
    cigar_b = b"".join(
        struct.pack("<I", (n << 4) | _CIGAR_IDX[op]) for n, op in rec.cigar)
    l_seq = len(rec.seq)
    seq_b = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(rec.seq.upper()):
        code = _SEQ_IDX.get(c, 15)
        if i % 2 == 0:
            seq_b[i // 2] = code << 4
        else:
            seq_b[i // 2] |= code
    qual_b = bytes((min(93, max(0, ord(q) - 33)) for q in rec.qual)) \
        if rec.qual else b"\xff" * l_seq
    tags_b = _encode_tags(rec.tags)

    if rec.is_unmapped or not rec.cigar:
        bin_ = reg2bin(rec.pos, rec.pos + 1)
    else:
        bin_ = reg2bin(rec.pos, rec.end_position())
    body = struct.pack(
        "<iiBBHHHiiii", rec.ref_id, rec.pos, len(name_b), rec.mapq, bin_,
        len(rec.cigar), rec.flag, l_seq, rec.mate_ref_id, rec.mate_pos,
        rec.tlen) + name_b + cigar_b + bytes(seq_b) + qual_b + tags_b
    return struct.pack("<I", len(body)) + body


# decode_record fast paths: one 2-char string per packed byte, and a
# 256-byte translate table mapping raw qual -> phred+33 char (capped 93)
_SEQ_PAIR = [_SEQ_CODE[b >> 4] + _SEQ_CODE[b & 0xf] for b in range(256)]
_QUAL_XLAT = bytes(min(93, q) + 33 for q in range(256))


def decode_record(buf: bytes) -> BamRecord:
    (ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, mate_ref,
     mate_pos, tlen) = struct.unpack("<iiBBHHHiiii", buf[:32])
    off = 32
    name = buf[off:off + l_name - 1].decode()
    off += l_name
    if n_cigar:
        vals = struct.unpack("<%dI" % n_cigar, buf[off:off + 4 * n_cigar])
        cigar = [(v >> 4, _CIGAR_OPS[v & 0xf]) for v in vals]
        off += 4 * n_cigar
    else:
        cigar = []
    nb = (l_seq + 1) // 2
    seq = "".join(map(_SEQ_PAIR.__getitem__, buf[off:off + nb]))[:l_seq]
    off += nb
    qual = buf[off:off + l_seq].translate(_QUAL_XLAT).decode("latin1")
    off += l_seq
    tags = _decode_tags(buf[off:])
    return BamRecord(name, flag, ref_id, pos, mapq, cigar, mate_ref,
                     mate_pos, tlen, seq, qual, tags)


class BamWriter:
    """Coordinate-sorted BAM writer with on-the-fly BAI indexing."""

    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 header_text: str = "", build_index: bool = True):
        self.path = path
        self.build_index = build_index
        self._w = BgzfWriter(path)
        self.ref_names = ref_names
        if not header_text:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lens))
        text = header_text.encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        self._w.write(struct.pack("<i", len(ref_names)))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb
                          + struct.pack("<i", l))
        # index state
        self._bins: List[Dict[int, List[Tuple[int, int]]]] = [
            dict() for _ in ref_names]
        self._linear: List[Dict[int, int]] = [dict() for _ in ref_names]
        self._last_key = None

    def write(self, rec: BamRecord) -> None:
        key = (rec.ref_id, rec.pos)
        if self.build_index:
            if self._last_key is not None and key < self._last_key:
                raise ValueError("records must be coordinate-sorted")
        self._last_key = key
        start_v = self._w.virtual_offset
        self._w.write(encode_record(rec))
        end_v = self._w.virtual_offset
        if self.build_index and rec.ref_id >= 0:
            end_pos = max(rec.end_position(), rec.pos + 1)
            b = reg2bin(rec.pos, end_pos)
            chunks = self._bins[rec.ref_id].setdefault(b, [])
            if chunks and chunks[-1][1] == start_v:
                chunks[-1] = (chunks[-1][0], end_v)
            else:
                chunks.append((start_v, end_v))
            lin = self._linear[rec.ref_id]
            for win in range(rec.pos >> 14, ((end_pos - 1) >> 14) + 1):
                if win not in lin or start_v < lin[win]:
                    lin[win] = start_v
        self._lastv = end_v

    def close(self) -> None:
        self._w.close()
        if self.build_index:
            self._write_bai()

    def _write_bai(self) -> None:
        with open(self.path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01" + struct.pack("<i", len(self.ref_names)))
            for bins, linear in zip(self._bins, self._linear):
                fh.write(struct.pack("<i", len(bins)))
                for b in sorted(bins):
                    chunks = bins[b]
                    fh.write(struct.pack("<I", b)
                             + struct.pack("<i", len(chunks)))
                    for cb, ce in chunks:
                        fh.write(struct.pack("<QQ", cb, ce))
                n_intv = max(linear) + 1 if linear else 0
                fh.write(struct.pack("<i", n_intv))
                prev = 0
                for win in range(n_intv):
                    if win in linear:
                        prev = linear[win]
                    fh.write(struct.pack("<Q", prev))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamReader:
    """Sequential + region-indexed BAM reader."""

    def __init__(self, path: str):
        self.path = path
        self._r = BgzfReader(path)
        magic = self._r.read(4)
        assert magic == b"BAM\x01", "not a BAM file"
        l_text = struct.unpack("<i", self._r.read(4))[0]
        self.header_text = self._r.read(l_text).decode("latin1")
        n_ref = struct.unpack("<i", self._r.read(4))[0]
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._r.read(4))[0]
            self.ref_names.append(self._r.read(l_name)[:-1].decode())
            self.ref_lens.append(struct.unpack("<i", self._r.read(4))[0])
        self._data_voffset = self._r.virtual_offset
        self._bai = self._load_bai(path + ".bai")

    def _load_bai(self, path: str):
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return None
        assert data[:4] == b"BAI\x01"
        n_ref = struct.unpack("<i", data[4:8])[0]
        off = 8
        index = []
        for _ in range(n_ref):
            n_bin = struct.unpack("<i", data[off:off + 4])[0]
            off += 4
            bins = {}
            for _ in range(n_bin):
                b = struct.unpack("<I", data[off:off + 4])[0]
                n_chunk = struct.unpack("<i", data[off + 4:off + 8])[0]
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack("<QQ", data[off:off + 16])
                    chunks.append((cb, ce))
                    off += 16
                bins[b] = chunks
            n_intv = struct.unpack("<i", data[off:off + 4])[0]
            off += 4
            linear = list(struct.unpack(f"<{n_intv}Q", data[off:off + 8 * n_intv]))
            off += 8 * n_intv
            index.append((bins, linear))
        return index

    def _read_record(self) -> Optional[BamRecord]:
        szb = self._r.read(4)
        if len(szb) < 4:
            return None
        sz = struct.unpack("<I", szb)[0]
        return decode_record(self._r.read(sz))

    def __iter__(self) -> Iterator[BamRecord]:
        self._r.seek_virtual(self._data_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[BamRecord]:
        """Records overlapping [start, end) on chrom (0-based)."""
        try:
            rid = self.ref_names.index(chrom)
        except ValueError:
            return
        if self._bai is not None:
            bins, linear = self._bai[rid]
            chunks = []
            min_lin = linear[start >> 14] if (start >> 14) < len(linear) else None
            for b in reg2bins(start, end):
                for cb, ce in bins.get(b, []):
                    if min_lin is not None and ce <= min_lin:
                        continue
                    chunks.append((cb, ce))
            chunks.sort()
            merged = []
            for cb, ce in chunks:
                if merged and cb <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
                else:
                    merged.append((cb, ce))
            for cb, ce in merged:
                self._r.seek_virtual(cb)
                while self._r.virtual_offset < ce:
                    rec = self._read_record()
                    if rec is None:
                        return
                    if rec.ref_id != rid or rec.pos >= end:
                        break
                    if rec.end_position() > start:
                        yield rec
        else:
            for rec in self:
                if rec.ref_id == rid and rec.pos < end and \
                        rec.end_position() > start:
                    yield rec

    def fetch_raw(self, chrom: str, start: int, end: int):
        """Raw record bodies for the [start, end) fetch window:
        (blob bytes, body offsets, body lengths, ref_id), or None when no
        index / unknown chrom.  Position screening is left to the consumer
        (native bam_filter_batch applies the same yield condition as
        fetch); trailing records of a BAI chunk may extend past the window
        and are screened there too."""
        try:
            rid = self.ref_names.index(chrom)
        except ValueError:
            return b"", [], [], -1
        if self._bai is None:
            return None
        bins, linear = self._bai[rid]
        chunks = []
        min_lin = linear[start >> 14] if (start >> 14) < len(linear) else None
        for b in reg2bins(start, end):
            for cb, ce in bins.get(b, []):
                if min_lin is not None and ce <= min_lin:
                    continue
                chunks.append((cb, ce))
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        blob = bytearray()
        offs: List[int] = []
        lens: List[int] = []
        r = self._r
        for cb, ce in merged:
            r.seek_virtual(cb)
            # bulk-read the chunk's inflated bytes, then split records by
            # their length prefixes; the final record may extend past ce
            # (BAI chunk ends bound record STARTS) — read its tail directly
            data = bytearray(r.read_upto(ce))
            base = len(blob)
            split = None
            from .. import native as _native
            while True:
                split = _native.split_bam_records_native(data)
                if split is None or split[0] >= 0:
                    break
                need = split[1]           # final record extends past ce
                got = r.read(need - len(data))
                if not got:
                    break                 # truncated file
                data.extend(got)
            if split is not None and split[0] >= 0:
                n_rec, r_offs, r_lens = split[0], split[2], split[3]
                offs.extend((base + v for v in r_offs[:n_rec].tolist()))
                lens.extend(r_lens[:n_rec].tolist())
            else:
                off = 0
                while off < len(data):
                    if off + 4 > len(data):
                        data.extend(r.read(off + 4 - len(data)))
                    sz = int.from_bytes(data[off:off + 4], "little")
                    end = off + 4 + sz
                    if end > len(data):
                        data.extend(r.read(end - len(data)))
                        if len(data) < end:
                            break  # truncated file
                    offs.append(base + off + 4)
                    lens.append(sz)
                    off = end
            blob.extend(data)
        return bytes(blob), offs, lens, rid

    def read_groups(self) -> List[Dict[str, str]]:
        """Parsed @RG lines from the header."""
        out = []
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                d = {}
                for tok in line.split("\t")[1:]:
                    if ":" in tok:
                        k, v = tok.split(":", 1)
                        d[k] = v
                out.append(d)
        return out

    def close(self) -> None:
        self._r.close()
