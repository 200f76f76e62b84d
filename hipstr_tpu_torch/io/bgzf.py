"""Copy of hipstr_tpu/io/bgzf.py.

BGZF block-compressed streams (the container under BAM / bgzipped VCF).

Independent implementation of the BGZF spec (SAM format specification §4.1):
concatenated gzip members with a BC extra field carrying the compressed block
size, a 28-byte EOF sentinel, and virtual file offsets packed as
(compressed_offset << 16) | within_block_offset.  Replaces the role htslib's
bgzf.c plays for the reference (reference: lib/htslib/bgzf.c — capability
parity only; this is written from the public spec).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, Optional, Tuple

MAX_BLOCK_SIZE = 65280  # payload bytes per block (leaves room for overhead)

EOF_MARKER = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])


def _compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 25 + 1  # header(12)+extra(6)+payload+crc(4)+isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1f, 0x8b, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0, 0, 0xff,              # mtime, xfl, os
        6,                       # xlen
        0x42, 0x43, 2,           # 'B','C', slen
        bsize - 1)
    return header + payload + struct.pack("<II", zlib.crc32(data),
                                          len(data) & 0xffffffff)


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self._fh: BinaryIO = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._coffset = 0  # compressed bytes written so far

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK_SIZE:
            self._flush_block(MAX_BLOCK_SIZE)

    def _flush_block(self, n: Optional[int] = None) -> None:
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seeks."""

    def __init__(self, path: str):
        self._fh: BinaryIO = open(path, "rb")
        self._block_coffset = 0
        self._block_data = b""
        self._within = 0
        self._next_coffset = 0

    def _read_block_at(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) < 12:
            self._block_data = b""
            return False
        magic1, magic2, method, flags = struct.unpack("<BBBB", header[:4])
        if magic1 != 0x1f or magic2 != 0x8b:
            raise ValueError("Bad BGZF magic")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4])[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("Missing BGZF BC field")
        payload_len = bsize - 12 - xlen - 8
        payload = self._fh.read(payload_len)
        self._fh.read(8)  # crc + isize
        self._block_data = zlib.decompress(payload, -15) if payload else b""
        self._block_coffset = coffset
        self._next_coffset = coffset + bsize
        self._within = 0
        return True

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xffff
        if coffset != self._block_coffset or not self._block_data:
            if not self._read_block_at(coffset):
                raise EOFError("seek past EOF")
        self._within = within

    @property
    def virtual_offset(self) -> int:
        return (self._block_coffset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._within >= len(self._block_data):
                if not self._read_block_at(self._next_coffset):
                    break
                if not self._block_data:
                    continue
            take = min(n, len(self._block_data) - self._within)
            out.extend(self._block_data[self._within:self._within + take])
            self._within += take
            n -= take
        return bytes(out)

    def read_upto(self, voffset_end: int) -> bytes:
        """All bytes from the current virtual offset up to exactly
        `voffset_end`, sliced block-at-a-time (no per-record read calls)."""
        target_coffset = voffset_end >> 16
        target_within = voffset_end & 0xffff
        out = bytearray()
        while True:
            if not self._block_data and not self._read_block_at(
                    self._next_coffset):
                break
            if self._block_coffset == target_coffset:
                out.extend(self._block_data[self._within:target_within])
                self._within = target_within
                break
            if self._block_coffset > target_coffset:
                break
            out.extend(self._block_data[self._within:])
            self._within = len(self._block_data)
            if not self._read_block_at(self._next_coffset):
                break
        return bytes(out)

    def read_all(self) -> bytes:
        # fast path: scan block headers for the decompressed size, then let
        # the native kernel inflate everything in one pass
        try:
            from ..native import bgzf_inflate_native
            self._fh.seek(0, 2)
            fsize = self._fh.tell()
            self._fh.seek(0)
            data = self._fh.read(fsize)
            total = 0
            ip = 0
            ok = True
            while ip + 18 <= len(data):
                if data[ip] != 0x1f or data[ip + 1] != 0x8b:
                    ok = False
                    break
                xlen = data[ip + 10] | (data[ip + 11] << 8)
                bsize = None
                xp = ip + 12
                xend = xp + xlen
                while xp + 4 <= xend:
                    if data[xp] == 0x42 and data[xp + 1] == 0x43:
                        bsize = (data[xp + 4] | (data[xp + 5] << 8)) + 1
                    xp += 4 + (data[xp + 2] | (data[xp + 3] << 8))
                if bsize is None:
                    ok = False
                    break
                isize = int.from_bytes(data[ip + bsize - 4:ip + bsize],
                                       "little")
                total += isize
                ip += bsize
            if ok and total > 0:
                res = bgzf_inflate_native(data, total)
                if res is not None:
                    self._block_coffset = 0
                    self._block_data = b""
                    return res
        except Exception:
            pass
        self.seek_virtual(0)
        out = bytearray()
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                break
            out.extend(chunk)
        return bytes(out)

    def close(self) -> None:
        self._fh.close()


def bgzf_compress_bytes(data: bytes, level: int = 6) -> bytes:
    """Compress a whole byte string into BGZF blocks + EOF marker."""
    out = bytearray()
    for i in range(0, len(data), MAX_BLOCK_SIZE):
        out.extend(_compress_block(data[i:i + MAX_BLOCK_SIZE], level))
    out.extend(EOF_MARKER)
    return bytes(out)
