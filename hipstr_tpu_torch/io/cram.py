"""Copy of hipstr_tpu/io/cram.py.

CRAM 3.0 reader (independent implementation from the public CRAM 3.0
specification; https://samtools.github.io/hts-specs/CRAMv3.pdf).

Capability parity with the reference's CRAM input path (reference:
src/bam_io.{h,cpp} BamCramReader over htslib).  Supports the structures the
common writers emit: gzip/raw/rANS-4x8 block compression, EXTERNAL / HUFFMAN
/ BETA / GAMMA / SUBEXP / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP encodings,
single-ref and multi-ref slices, reference-based sequence reconstruction
(external FASTA or embedded reference), .crai region queries, and mate
resolution for non-detached pairs.  Decoded records are `BamRecord`s, so the
rest of the pipeline is agnostic to the container format.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from .bam import BamRecord


# ----------------------------------------------------------------- varints
class ByteStream:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32le(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def itf8(self) -> int:
        b1 = self.u8()
        if b1 < 0x80:
            return b1
        if b1 < 0xC0:
            return ((b1 & 0x3F) << 8) | self.u8()
        if b1 < 0xE0:
            return ((b1 & 0x1F) << 16) | (self.u8() << 8) | self.u8()
        if b1 < 0xF0:
            v = ((b1 & 0x0F) << 24) | (self.u8() << 16) | (self.u8() << 8) \
                | self.u8()
        else:
            v = ((b1 & 0x0F) << 28) | (self.u8() << 20) | (self.u8() << 12) \
                | (self.u8() << 4) | (self.u8() & 0x0F)
        # ITF8 stores int32; reinterpret the top bit as sign
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b1 = self.u8()
        n_extra = 0
        mask = 0x80
        while n_extra < 8 and (b1 & mask):
            n_extra += 1
            mask >>= 1
        if n_extra == 0:
            return b1
        if n_extra >= 8:
            v = int.from_bytes(self.read(8), "big")
        else:
            v = b1 & ((1 << (7 - n_extra)) - 1)
            for _ in range(n_extra):
                v = (v << 8) | self.u8()
        return v - (1 << 64) if v >= (1 << 63) else v

    def itf8_array(self) -> List[int]:
        return [self.itf8() for _ in range(self.itf8())]


class BitStream:
    """MSB-first bit reader over the core data block."""

    __slots__ = ("buf", "byte_pos", "bit_pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.byte_pos = 0
        self.bit_pos = 0

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.buf[self.byte_pos]
            v = (v << 1) | ((byte >> (7 - self.bit_pos)) & 1)
            self.bit_pos += 1
            if self.bit_pos == 8:
                self.bit_pos = 0
                self.byte_pos += 1
        return v


# ---------------------------------------------------------------- rANS 4x8
def _rans4x8_decode(data: bytes) -> bytes:
    """rANS-4x8 entropy decoder (order 0/1), per the CRAM 3.0 spec §13."""
    st = ByteStream(data)
    order = st.u8()
    st.u32le()          # compressed size of the stream that follows
    n_out = st.u32le()
    out = bytearray(n_out)
    TF = 12
    TOTFREQ = 1 << TF
    RANS_LOW = 1 << 23

    def read_freq() -> int:
        f = st.u8()
        if f >= 0x80:
            return ((f & 0x7F) << 8) | st.u8()
        return f

    def read_table(zero_is_total: bool = False):
        """Symbol->frequency table with the spec's RLE layout (htslib
        rANS_static.c semantics: order-1 contexts map F==0 to TOTFREQ,
        and a table summing to TOTFREQ-1 duplicates the last slot)."""
        F = [0] * 256
        sym = st.u8()
        rle = 0
        while True:
            f = read_freq()
            if zero_is_total and f == 0:
                f = TOTFREQ
            F[sym] = f
            if rle > 0:
                rle -= 1
                sym += 1
            else:
                nxt = st.u8()
                if nxt == sym + 1:
                    rle = st.u8()
                sym = nxt
                if sym == 0:
                    break
        C = [0] * 257
        for s in range(256):
            C[s + 1] = C[s] + F[s]
        lookup = bytearray(TOTFREQ)
        for s in range(256):
            if F[s]:
                lookup[C[s]:C[s + 1]] = bytes([s]) * F[s]
        total = C[256]
        if total < TOTFREQ:  # historically filled 4095, not 4096
            lookup[total] = lookup[total - 1] if total else 0
        return F, C, lookup

    if order == 0:
        F, C, lookup = read_table()
        R = [st.u32le() for _ in range(4)]
        buf, pos = st.buf, st.pos
        blen = len(buf)
        out_end = n_out & ~3
        for i in range(out_end):
            j = i & 3
            r = R[j]
            m = r & (TOTFREQ - 1)
            s = lookup[m]
            out[i] = s
            r = F[s] * (r >> TF) + m - C[s]
            while r < RANS_LOW and pos < blen:
                r = (r << 8) | buf[pos]
                pos += 1
            R[j] = r
        # remainder: peek-only, streams 0..2 (htslib order-0 tail switch)
        for k in range(n_out & 3):
            out[out_end + k] = lookup[R[k] & (TOTFREQ - 1)]
        return bytes(out)

    # order 1: per-context tables; 4 streams over FLOOR quarters, stream 3
    # continues through the tail (htslib rans_uncompress_O1 layout)
    Fs: Dict[int, list] = {}
    Cs: Dict[int, list] = {}
    Ls: Dict[int, bytearray] = {}
    ctx = st.u8()
    rle = 0
    while True:
        F, C, lookup = read_table(zero_is_total=True)
        Fs[ctx], Cs[ctx], Ls[ctx] = F, C, lookup
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            nxt = st.u8()
            if nxt == ctx + 1:
                rle = st.u8()
            ctx = nxt
            if ctx == 0:
                break
    R = [st.u32le() for _ in range(4)]
    buf, pos = st.buf, st.pos
    blen = len(buf)
    n4 = n_out >> 2
    idx = [0, n4, 2 * n4, 3 * n4]
    last = [0, 0, 0, 0]
    for _ in range(n4):
        for j in range(4):
            r = R[j]
            m = r & (TOTFREQ - 1)
            c = last[j]
            s = Ls[c][m]
            out[idx[j]] = s
            r = Fs[c][s] * (r >> TF) + m - Cs[c][s]
            while r < RANS_LOW and pos < blen:
                r = (r << 8) | buf[pos]
                pos += 1
            R[j] = r
            last[j] = s
            idx[j] += 1
    # tail: stream 3 with its running context
    r = R[3]
    c = last[3]
    for i in range(4 * n4, n_out):
        m = r & (TOTFREQ - 1)
        s = Ls[c][m]
        out[i] = s
        r = Fs[c][s] * (r >> TF) + m - Cs[c][s]
        while r < RANS_LOW and pos < blen:
            r = (r << 8) | buf[pos]
            pos += 1
        c = s
    return bytes(out)


def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == 0:
        return data
    if method == 1:
        return zlib.decompress(data, zlib.MAX_WBITS | 32)
    if method == 4:
        return _rans4x8_decode(data)
    if method == 2:
        import bz2
        return bz2.decompress(data)
    if method == 3:
        import lzma
        return lzma.decompress(data)
    raise NotImplementedError(f"CRAM block compression method {method}")


# ---------------------------------------------------------------- encodings
class Encoding:
    """One data-series codec (CRAM 3.0 §12)."""

    def __init__(self, codec: int, args: bytes):
        self.codec = codec
        st = ByteStream(args)
        if codec == 0:      # NULL
            pass
        elif codec == 1:    # EXTERNAL
            self.content_id = st.itf8()
        elif codec == 3:    # HUFFMAN (canonical)
            self.alphabet = st.itf8_array()
            self.bitlens = st.itf8_array()
            self._build_huffman()
        elif codec == 4:    # BYTE_ARRAY_LEN
            c1 = st.itf8()
            a1 = st.read(st.itf8())
            c2 = st.itf8()
            a2 = st.read(st.itf8())
            self.len_enc = Encoding(c1, a1)
            self.val_enc = Encoding(c2, a2)
        elif codec == 5:    # BYTE_ARRAY_STOP
            self.stop_byte = st.u8()
            self.content_id = st.itf8()
        elif codec == 6:    # BETA
            self.offset = st.itf8()
            self.length = st.itf8()
        elif codec == 7:    # SUBEXP
            self.offset = st.itf8()
            self.k = st.itf8()
        elif codec == 9:    # GAMMA
            self.offset = st.itf8()
        else:
            raise NotImplementedError(f"CRAM encoding codec {codec}")

    def _build_huffman(self):
        # canonical codes ordered by (bit length, symbol)
        pairs = sorted(zip(self.bitlens, self.alphabet))
        self.huff: Dict[Tuple[int, int], int] = {}
        code = 0
        prev_len = 0
        for blen, sym in pairs:
            code <<= (blen - prev_len)
            self.huff[(blen, code)] = sym
            code += 1
            prev_len = blen
        self.max_len = pairs[-1][0] if pairs else 0
        self.const = self.alphabet[0] if (len(self.alphabet) == 1
                                          and self.bitlens[0] == 0) else None

    def read_int(self, core: BitStream, ext: Dict[int, ByteStream]) -> int:
        c = self.codec
        if c == 1:
            return ext[self.content_id].itf8()
        if c == 3:
            if self.const is not None:
                return self.const
            code = 0
            blen = 0
            while True:
                code = (code << 1) | core.bits(1)
                blen += 1
                sym = self.huff.get((blen, code))
                if sym is not None:
                    return sym
                if blen > self.max_len:
                    raise ValueError("bad huffman stream")
        if c == 6:
            return core.bits(self.length) - self.offset
        if c == 9:
            n = 0
            while core.bits(1) == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | core.bits(1)
            return v - self.offset
        if c == 7:
            n = 0
            while core.bits(1) == 1:
                n += 1
            if n == 0:
                v = core.bits(self.k)
            else:
                v = ((1 << (n + self.k - 1))
                     | core.bits(n + self.k - 1))
            return v - self.offset
        raise NotImplementedError(f"int decode for codec {c}")

    def read_byte(self, core: BitStream, ext: Dict[int, ByteStream]) -> int:
        if self.codec == 1:
            return ext[self.content_id].u8()
        return self.read_int(core, ext)

    def read_bytes(self, core: BitStream, ext: Dict[int, ByteStream],
                   n: Optional[int] = None) -> bytes:
        c = self.codec
        if c == 5:
            stream = ext[self.content_id]
            start = stream.pos
            buf = stream.buf
            stop = self.stop_byte
            p = buf.index(bytes([stop]), start)
            stream.pos = p + 1
            return buf[start:p]
        if c == 4:
            ln = self.len_enc.read_int(core, ext)
            v = self.val_enc
            if v.codec == 1:
                return ext[v.content_id].read(ln)
            return bytes(v.read_byte(core, ext) for _ in range(ln))
        if c == 1:
            return ext[self.content_id].read(n if n is not None else 1)
        return bytes(self.read_byte(core, ext) for _ in range(n or 1))


# ------------------------------------------------------------------- parsing
class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, st: ByteStream, version: int):
        self.method = st.u8()
        self.content_type = st.u8()
        self.content_id = st.itf8()
        comp_size = st.itf8()
        raw_size = st.itf8()
        raw = st.read(comp_size)
        self.data = _decompress(self.method, raw, raw_size)
        if version >= 3:
            st.read(4)  # CRC32


class CompressionHeader:
    def __init__(self, data: bytes):
        st = ByteStream(data)
        # preservation map
        st.itf8()
        self.rn = True
        self.ap_delta = True
        self.rr = True
        self.sub_matrix = b"\x00" * 5
        self.tag_dict: List[List[Tuple[str, str]]] = [[]]
        for _ in range(st.itf8()):
            key = st.read(2)
            if key == b"RN":
                self.rn = bool(st.u8())
            elif key == b"AP":
                self.ap_delta = bool(st.u8())
            elif key == b"RR":
                self.rr = bool(st.u8())
            elif key == b"SM":
                self.sub_matrix = st.read(5)
            elif key == b"TD":
                blob = st.read(st.itf8())
                self.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    tags = []
                    for i in range(0, len(line), 3):
                        t = line[i:i + 3]
                        if len(t) == 3:
                            tags.append((t[:2].decode("latin1"),
                                         chr(t[2])))
                    self.tag_dict.append(tags)
                if not self.tag_dict:
                    self.tag_dict = [[]]
            else:
                raise NotImplementedError(f"preservation key {key!r}")
        # data series encodings
        st.itf8()
        self.series: Dict[str, Encoding] = {}
        for _ in range(st.itf8()):
            key = st.read(2).decode("latin1")
            codec = st.itf8()
            args = st.read(st.itf8())
            self.series[key] = Encoding(codec, args)
        # tag encodings
        st.itf8()
        self.tag_enc: Dict[int, Encoding] = {}
        for _ in range(st.itf8()):
            key = st.itf8()
            codec = st.itf8()
            args = st.read(st.itf8())
            self.tag_enc[key] = Encoding(codec, args)

        # substitution matrix: row per reference base (ACGTN), each row lists
        # the other four bases in ACGTN order with a 2-bit code each
        self.subs = {}
        bases = "ACGTN"
        for ri, rb in enumerate(bases):
            row = self.sub_matrix[ri]
            alts = [b for b in bases if b != rb]
            for k, alt in enumerate(alts):
                code = (row >> (2 * (3 - k))) & 3
                self.subs[(rb, code)] = alt


class SliceHeader:
    def __init__(self, data: bytes):
        st = ByteStream(data)
        self.ref_id = st.itf8()
        self.start = st.itf8()
        self.span = st.itf8()
        self.n_records = st.itf8()
        self.counter = st.ltf8()
        self.n_blocks = st.itf8()
        self.content_ids = st.itf8_array()
        self.embedded_ref_id = st.itf8()
        self.md5 = st.read(16)


TYPE_SIZES = {"c": ("b", 1), "C": ("B", 1), "s": ("h", 2), "S": ("H", 2),
              "i": ("i", 4), "I": ("I", 4), "f": ("f", 4)}


def _parse_tag_value(type_char: str, blob: bytes):
    if type_char == "A":
        return ("A", chr(blob[0]))
    if type_char in TYPE_SIZES:
        fmt, _ = TYPE_SIZES[type_char]
        return (type_char, struct.unpack("<" + fmt, blob)[0])
    if type_char == "Z":
        return ("Z", blob.rstrip(b"\x00").decode("latin1"))
    if type_char == "H":
        return ("H", blob.rstrip(b"\x00").decode("latin1"))
    if type_char == "B":
        sub = chr(blob[0])
        fmt, size = TYPE_SIZES[sub]
        n = struct.unpack_from("<I", blob, 1)[0]
        vals = list(struct.unpack_from(f"<{n}{fmt}", blob, 5))
        return ("B", (sub, vals))
    raise NotImplementedError(f"tag type {type_char}")


class CramReader:
    """Region-indexed CRAM 3.0 reader producing BamRecord objects."""

    def __init__(self, path: str, fasta_path: Optional[str] = None):
        self.path = path
        self.filename = path
        with open(path, "rb") as fh:
            self._data = fh.read()
        st = ByteStream(self._data)
        magic = st.read(4)
        if magic != b"CRAM":
            raise ValueError(f"{path} is not a CRAM file")
        self.major = st.u8()
        self.minor = st.u8()
        if self.major not in (2, 3):
            raise NotImplementedError(f"CRAM version {self.major}.{self.minor}")
        st.read(20)  # file id
        self._first_container = st.pos

        # first container: SAM header text
        hdr_container = self._read_container(self._first_container)
        hdr_block = hdr_container["blocks"][0]
        hst = ByteStream(hdr_block.data)
        text_len = hst.u32le()
        self.header_text = hst.read(text_len).decode("latin1", "replace")
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:]
                         if ":" in f)
                self.ref_names.append(d.get("SN", ""))
                self.ref_lens.append(int(d.get("LN", "0")))

        self._fasta = None
        if fasta_path:
            from .fasta import FastaReader
            self._fasta = FastaReader(fasta_path)
        self._ref_cache: Dict[int, str] = {}

        self._crai: List[Tuple[int, int, int, int, int, int]] = []
        try:
            with gzip.open(path + ".crai", "rt") as fh:
                for line in fh:
                    toks = line.split()
                    if len(toks) >= 6:
                        self._crai.append(tuple(int(t) for t in toks[:6]))
        except OSError:
            pass

    # -- low-level container access -------------------------------------
    def _read_container(self, offset: int) -> dict:
        st = ByteStream(self._data, offset)
        length = st.u32le()
        ref_id = st.itf8()
        start = st.itf8()
        span = st.itf8()
        n_records = st.itf8()
        st.ltf8()   # record counter
        st.ltf8()   # bases
        n_blocks = st.itf8()
        landmarks = st.itf8_array()
        if self.major >= 3:
            st.read(4)  # CRC32
        body_start = st.pos
        blocks = []
        for _ in range(n_blocks):
            blocks.append(Block(st, self.major))
        return dict(ref_id=ref_id, start=start, span=span,
                    n_records=n_records, blocks=blocks,
                    landmarks=landmarks, body_start=body_start,
                    end=body_start + length)

    def _ref_seq(self, ref_id: int) -> str:
        if ref_id < 0:
            return ""
        seq = self._ref_cache.get(ref_id)
        if seq is None:
            if self._fasta is None:
                raise RuntimeError(
                    "CRAM decoding requires the reference FASTA")
            seq = self._fasta.get_sequence(self.ref_names[ref_id]).upper()
            self._ref_cache[ref_id] = seq
        return seq

    # -- record decoding -------------------------------------------------
    def _decode_slice(self, ch: CompressionHeader, blocks: List[Block],
                      slice_index_in_container: int) -> List[BamRecord]:
        sh = SliceHeader(blocks[0].data)
        core: Optional[BitStream] = None
        ext: Dict[int, ByteStream] = {}
        embedded_ref = None
        for b in blocks[1:1 + sh.n_blocks]:
            if b.content_type == 5:
                core = BitStream(b.data)
            elif b.content_type == 4:
                ext[b.content_id] = ByteStream(b.data)
                if sh.embedded_ref_id >= 0 and b.content_id == sh.embedded_ref_id:
                    embedded_ref = b.data.decode("latin1")
        S = ch.series

        def rint(key: str, default=None) -> int:
            enc = S.get(key)
            if enc is None:
                if default is not None:
                    return default
                raise KeyError(f"missing data series {key}")
            return enc.read_int(core, ext)

        def rbyte(key: str) -> int:
            return S[key].read_byte(core, ext)

        def rbytes(key: str, n: Optional[int] = None) -> bytes:
            return S[key].read_bytes(core, ext, n)

        records: List[dict] = []
        last_pos = sh.start
        for rec_i in range(sh.n_records):
            bf = rint("BF")
            cf = rint("CF")
            ref_id = sh.ref_id
            if ref_id == -2:
                ref_id = rint("RI")
            rl = rint("RL")
            if ch.ap_delta:
                pos = last_pos + rint("AP")
                last_pos = pos
            else:
                pos = rint("AP")
            rg = rint("RG")
            if ch.rn:
                name = rbytes("RN").decode("latin1")
            else:
                name = f"cram-{sh.counter + rec_i}"
            mate_ref = -1
            mate_pos = -1
            tlen = 0
            nf = -1
            if cf & 0x2:      # detached
                mf = rint("MF")
                if not ch.rn:
                    name = rbytes("RN").decode("latin1")
                mate_ref = rint("NS")
                mate_pos = rint("NP")
                tlen = rint("TS")
                if mf & 0x1:
                    bf |= 0x20   # mate reverse strand
                if mf & 0x2:
                    bf |= 0x8    # mate unmapped
            elif cf & 0x4:    # mate is downstream in this slice
                nf = rint("NF")

            tl = rint("TL")
            tags: Dict[str, Tuple[str, object]] = {}
            for tag, type_char in ch.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(type_char)
                blob = ch.tag_enc[key].read_bytes(core, ext)
                tags[tag] = _parse_tag_value(type_char, blob)
            if rg >= 0 and "RG" not in tags:
                tags["RG"] = ("Z", self._rg_ids[rg] if rg < len(self._rg_ids)
                              else str(rg))

            features = []
            mapq = 0
            quals = b""
            bases = b""
            if not (bf & 0x4):
                fn = rint("FN")
                fpos = 0
                for _ in range(fn):
                    fc = chr(rbyte("FC"))
                    fpos += rint("FP")
                    if fc == "X":
                        features.append((fc, fpos, rbyte("BS")))
                    elif fc == "B":
                        features.append((fc, fpos, (rbyte("BA"), rbyte("QS"))))
                    elif fc == "I":
                        features.append((fc, fpos, rbytes("IN")))
                    elif fc == "S":
                        features.append((fc, fpos, rbytes("SC")))
                    elif fc == "i":
                        features.append((fc, fpos, rbyte("BA")))
                    elif fc == "D":
                        features.append((fc, fpos, rint("DL")))
                    elif fc == "H":
                        features.append((fc, fpos, rint("HC")))
                    elif fc == "P":
                        features.append((fc, fpos, rint("PD")))
                    elif fc == "N":
                        features.append((fc, fpos, rint("RS")))
                    elif fc == "Q":
                        features.append((fc, fpos, rbyte("QS")))
                    elif fc == "b":
                        features.append((fc, fpos, rbytes("BB")))
                    elif fc == "q":
                        features.append((fc, fpos, rbytes("QQ")))
                    else:
                        raise NotImplementedError(f"feature code {fc!r}")
                mapq = rint("MQ")
                if cf & 0x1:
                    quals = rbytes("QS", rl)
            else:
                bases = rbytes("BA", rl)
                if cf & 0x1:
                    quals = rbytes("QS", rl)

            records.append(dict(bf=bf, cf=cf, ref_id=ref_id, pos=pos, rl=rl,
                                name=name, mapq=mapq, tags=tags, nf=nf,
                                mate_ref=mate_ref, mate_pos=mate_pos,
                                tlen=tlen, features=features, quals=quals,
                                bases=bases, embedded_ref=embedded_ref,
                                slice_start=sh.start))

        # resolve non-detached mates (CF & 0x4 chains)
        for i, r in enumerate(records):
            if r["nf"] >= 0:
                j = i + r["nf"] + 1
                if j < len(records):
                    m = records[j]
                    r["mate_ref"] = m["ref_id"]
                    r["mate_pos"] = m["pos"] - 1
                    if m["bf"] & 0x10:
                        r["bf"] |= 0x20
                    m["mate_ref"] = r["ref_id"]
                    m["mate_pos"] = r["pos"] - 1
                    if r["bf"] & 0x10:
                        m["bf"] |= 0x20

        out = []
        for r in records:
            out.append(self._materialize(ch, r))
        # mate-pair template lengths for resolved pairs
        by_name: Dict[str, List[BamRecord]] = {}
        for rec in out:
            if rec.is_paired:
                by_name.setdefault(rec.name, []).append(rec)
        for name, pair in by_name.items():
            if len(pair) == 2:
                a, b = sorted(pair, key=lambda x: x.pos)
                span = max(a.end_position(), b.end_position()) - a.pos
                if a.tlen == 0:
                    a.tlen = span
                if b.tlen == 0:
                    b.tlen = -span
        return out

    def _materialize(self, ch: CompressionHeader, r: dict) -> BamRecord:
        rl = r["rl"]
        pos0 = r["pos"] - 1          # CRAM positions are 1-based
        cigar: List[Tuple[int, str]] = []
        if r["bf"] & 0x4:
            seq = r["bases"].decode("latin1")
        else:
            ref = r["embedded_ref"]
            ref_off = r["slice_start"] - 1 if ref is not None else 0
            if ref is None:
                ref = self._ref_seq(r["ref_id"])
            seq_arr = [""] * rl
            ops: List[Tuple[int, str]] = []   # (read_pos0, op details)

            def emit(op: str, length: int):
                if length <= 0:
                    return
                if cigar and cigar[-1][1] == op:
                    cigar[-1] = (cigar[-1][0] + length, op)
                else:
                    cigar.append((length, op))

            read_i = 0    # current read index (0-based)
            ref_i = pos0  # current reference position
            for fc, fpos, val in sorted(r["features"], key=lambda f: f[1]):
                gap = (fpos - 1) - read_i
                if gap > 0:
                    for k in range(gap):
                        seq_arr[read_i + k] = ref[ref_i + k - ref_off] \
                            if 0 <= ref_i + k - ref_off < len(ref) else "N"
                    emit("M", gap)
                    read_i += gap
                    ref_i += gap
                if fc == "X":
                    rb = ref[ref_i - ref_off] if 0 <= ref_i - ref_off < len(ref) else "N"
                    seq_arr[read_i] = ch.subs.get((rb if rb in "ACGTN" else "N",
                                                   val), "N")
                    emit("M", 1)
                    read_i += 1
                    ref_i += 1
                elif fc == "B":
                    seq_arr[read_i] = chr(val[0])
                    emit("M", 1)
                    read_i += 1
                    ref_i += 1
                elif fc == "I":
                    ins = val.decode("latin1")
                    for k, c in enumerate(ins):
                        seq_arr[read_i + k] = c
                    emit("I", len(ins))
                    read_i += len(ins)
                elif fc == "i":
                    seq_arr[read_i] = chr(val)
                    emit("I", 1)
                    read_i += 1
                elif fc == "S":
                    sc = val.decode("latin1")
                    for k, c in enumerate(sc):
                        seq_arr[read_i + k] = c
                    emit("S", len(sc))
                    read_i += len(sc)
                elif fc == "D":
                    emit("D", val)
                    ref_i += val
                elif fc == "N":
                    emit("N", val)
                    ref_i += val
                elif fc == "H":
                    emit("H", val)
                elif fc == "P":
                    emit("P", val)
                elif fc == "Q":
                    pass  # single qual already in QS array
                elif fc == "b":
                    bb = val.decode("latin1")
                    for k, c in enumerate(bb):
                        seq_arr[read_i + k] = c
                    emit("M", len(bb))
                    read_i += len(bb)
                    ref_i += len(bb)
                elif fc == "q":
                    pass
            tail = rl - read_i
            if tail > 0:
                for k in range(tail):
                    seq_arr[read_i + k] = ref[ref_i + k - ref_off] \
                        if 0 <= ref_i + k - ref_off < len(ref) else "N"
                emit("M", tail)
            seq = "".join(seq_arr)
        if not cigar and not (r["bf"] & 0x4):
            cigar = [(rl, "M")]
        qual = "".join(chr(q + 33) for q in r["quals"]) if r["quals"] else "*"
        return BamRecord(
            name=r["name"], flag=r["bf"], ref_id=r["ref_id"], pos=pos0,
            mapq=r["mapq"], cigar=cigar, mate_ref_id=r["mate_ref"],
            mate_pos=r["mate_pos"], tlen=r["tlen"], seq=seq,
            qual=qual if qual != "*" else "I" * rl, tags=r["tags"])

    # -- public API ------------------------------------------------------
    @property
    def _rg_ids(self) -> List[str]:
        ids = getattr(self, "_rg_ids_cache", None)
        if ids is None:
            ids = []
            for line in self.header_text.splitlines():
                if line.startswith("@RG"):
                    for f in line.split("\t")[1:]:
                        if f.startswith("ID:"):
                            ids.append(f[3:])
            self._rg_ids_cache = ids
        return ids

    def read_groups(self) -> List[Dict[str, str]]:
        out = []
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                out.append(dict(f.split(":", 1) for f in line.split("\t")[1:]
                                if ":" in f))
        return out

    def _containers(self):
        off = self._skip_first_container()
        while off < len(self._data):
            st = ByteStream(self._data, off)
            length = st.u32le()
            ref_id_probe = st.itf8()
            if length == 15 and ref_id_probe == -1:
                # EOF container
                break
            c = self._read_container(off)
            yield off, c
            off = c["end"]

    def _skip_first_container(self) -> int:
        c = self._read_container(self._first_container)
        return c["end"]

    def _decode_container(self, c: dict) -> List[BamRecord]:
        blocks = c["blocks"]
        ch = CompressionHeader(blocks[0].data)
        recs: List[BamRecord] = []
        # slices begin at landmark offsets; walk blocks sequentially:
        # block 0 is the compression header, then each slice = header block
        # + its data blocks
        i = 1
        while i < len(blocks):
            assert blocks[i].content_type == 2, "expected slice header"
            sh = SliceHeader(blocks[i].data)
            slice_blocks = blocks[i:i + 1 + sh.n_blocks]
            recs.extend(self._decode_slice(ch, slice_blocks, i))
            i += 1 + sh.n_blocks
        return recs

    def __iter__(self):
        for _, c in self._containers():
            for rec in self._decode_container(c):
                yield rec

    def fetch(self, chrom: str, start: int, end: int):
        """Yield records overlapping [start, end) (0-based half-open)."""
        try:
            rid = self.ref_names.index(chrom)
        except ValueError:
            return
        if self._crai:
            offsets = []
            for (seq_id, a_start, a_span, c_off, _s_off, _s_size) in self._crai:
                if seq_id != rid:
                    continue
                if a_start - 1 < end and a_start - 1 + a_span > start:
                    offsets.append(c_off)
            seen = set()
            recs = []
            for off in offsets:
                if off in seen:
                    continue
                seen.add(off)
                c = self._read_container(off)
                recs.extend(self._decode_container(c))
            for rec in sorted(recs, key=lambda r: (r.ref_id, r.pos)):
                if rec.ref_id == rid and rec.pos < end \
                        and rec.end_position() > start:
                    yield rec
        else:
            for rec in self:
                if rec.ref_id == rid and rec.pos < end \
                        and rec.end_position() > start:
                    yield rec

    def _decode_container_native(self, c_off: int):
        """One container -> (BAM-body blob, offsets, lengths) via the
        native decoder; None directs the caller to the python fallback
        (multi-ref beyond the refs cap, unsupported codecs)."""
        from .. import native as _native
        st = ByteStream(self._data, c_off)
        st.u32le()                # container length (blocks region)
        ref_id = st.itf8()
        st.itf8()                 # start
        st.itf8()                 # span
        st.itf8()                 # n_records
        st.ltf8()                 # counter
        st.ltf8()                 # bases
        n_blocks = st.itf8()
        st.itf8_array()           # landmarks
        if self.major >= 3:
            st.read(4)            # CRC32
        body = self._data[st.pos:]
        cache = getattr(self, "_ref_bytes_cache", None)
        if cache is None:
            cache = self._ref_bytes_cache = {}

        def ref_bytes(r2):
            b = cache.get(r2)
            if b is None:
                try:
                    b = self._ref_seq(r2).encode("latin1")
                except RuntimeError:
                    b = b""       # embedded-ref containers need none
                cache[r2] = b
            return b

        if ref_id == -2:
            # multi-ref container: records carry their own ref ids; any
            # chromosome may appear, so hand the decoder every reference
            # (bounded — beyond the cap fall back to the object path)
            if sum(self.ref_lens) > (1 << 28):
                return None
            refs = {r2: ref_bytes(r2) for r2 in range(len(self.ref_names))}
        else:
            refs = {ref_id: ref_bytes(ref_id)} if ref_id >= 0 else {}
        return _native.cram_decode_container_native(
            bytes(body), n_blocks, self.major, refs, self._rg_ids)

    def fetch_raw(self, chrom: str, start: int, end: int):
        """Raw BAM record bodies for the fetch window via the NATIVE
        container decoder (native/cram_decode.cpp): (blob, offsets,
        lengths, ref_id) with the io/bam.py fetch_raw conventions, or
        None when the native entry is unavailable or a container needs
        the python fallback.  Position screening is left to the consumer
        (the native filter cascade applies the same yield condition as
        fetch)."""
        from .. import native as _native
        if not self._crai:
            return None
        try:
            rid = self.ref_names.index(chrom)
        except ValueError:
            return b"", [], [], -1
        offsets = []
        for (seq_id, a_start, a_span, c_off, _s, _z) in self._crai:
            if seq_id != rid:
                continue
            if a_start - 1 < end and a_start - 1 + a_span > start:
                if c_off not in offsets:
                    offsets.append(c_off)
        # per-container decode cache: successive loci routinely hit the
        # same container, so keep the last few decoded (the reference's
        # BamCramReader reuses its iterator for repeated nearby regions,
        # src/bam_io.h:505-569 — same capability, columnar form)
        ccache = getattr(self, "_container_cache", None)
        if ccache is None:
            ccache = self._container_cache = {}
        # decode cache misses concurrently: containers are independent and
        # the native call releases the GIL (ctypes), so a fetch spanning
        # several containers rides the spare cores (the reference gets the
        # same effect from htslib's thread_pool.c, which HipSTR itself
        # never enables)
        misses = [c for c in offsets if c not in ccache]
        if len(misses) > 1:
            import concurrent.futures as _cf
            import os as _os
            with _cf.ThreadPoolExecutor(
                    max_workers=min(len(misses),
                                    max(2, (_os.cpu_count() or 2) - 1))) as ex:
                for c_off, res in zip(misses,
                                      ex.map(self._decode_container_native,
                                             misses)):
                    if res is None:
                        return None
                    if len(ccache) >= 4:
                        ccache.pop(next(iter(ccache)))
                    ccache[c_off] = res
        blob = bytearray()
        offs: List[int] = []
        lens: List[int] = []
        for c_off in offsets:
            got = ccache.get(c_off)
            if got is not None:
                c_blob, c_offs, c_lens = got
                base = len(blob)
                blob.extend(c_blob)
                offs.extend(base + o for o in c_offs)
                lens.extend(c_lens)
                continue
            res = self._decode_container_native(c_off)
            if res is None:
                return None
            if len(ccache) >= 4:
                ccache.pop(next(iter(ccache)))
            ccache[c_off] = res
            c_blob, c_offs, c_lens = res
            base = len(blob)
            blob.extend(c_blob)
            offs.extend(base + o for o in c_offs)
            lens.extend(c_lens)
        if len(offsets) > 1 and offs:
            # global (ref_id, pos) order across containers, as fetch() sorts
            import struct as _struct
            keyed = sorted(
                range(len(offs)),
                key=lambda i: _struct.unpack_from("<ii", blob, offs[i]))
            offs = [offs[i] for i in keyed]
            lens = [lens[i] for i in keyed]
        return bytes(blob), offs, lens, rid

    def close(self):
        pass
