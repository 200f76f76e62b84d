"""Copy of hipstr_tpu/pipeline/pdf.py.

Alignment visualization → PDF, with a from-scratch minimal PDF writer.

Capability parity with the reference's VizAlnPdf + scripts/html_alns_to_pdf.py
(reference: repo-root VizAlnPdf, scripts/html_alns_to_pdf.py — a reportlab
renderer).  reportlab isn't available here, so this emits PDF 1.4 directly:
one Courier text grid per locus with the same color semantics as the HTML viz
(matches grey, mismatches red, deletions blue, insertions amber background,
repeat block shaded).
"""

from __future__ import annotations

import re
import zlib
from typing import List, Optional, Tuple

# color classes shared with pipeline/viz.py's CSS
_TEXT_COLORS = {
    "m": (0.6, 0.6, 0.6),
    "x": (0.76, 0.13, 0.13),
    "d": (0.2, 0.4, 0.76),
    "ref": (0.13, 0.13, 0.13),
    "samp": (0.07, 0.07, 0.4),
    "coord": (0.4, 0.4, 0.4),
}
_BG_COLORS = {
    "str": (0.87, 0.93, 1.0),
    "i": (1.0, 0.8, 0.4),
}

_SPAN_RE = re.compile(r'<span class="([^"]*)">(.*?)</span>|([^<])', re.S)
_DIV_RE = re.compile(r'<div(?: class="([^"]*)")?>(.*?)</div>', re.S)


def _parse_rows(html: str) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """Rows of (div_class, [(char, span_class), ...]) from the viz HTML."""
    rows = []
    for div_cls, content in _DIV_RE.findall(html):
        if div_cls == "aln":
            continue
        chars: List[Tuple[str, str]] = []
        for span_cls, span_text, plain in _SPAN_RE.findall(content):
            if plain:
                chars.append((plain, ""))
            else:
                for ch in span_text:
                    chars.append((ch, span_cls))
        rows.append((div_cls or "", chars))
    return rows


class MiniPdf:
    """Minimal multi-page PDF writer (Courier text + filled rectangles)."""

    def __init__(self, page_w: float = 1400, page_h: float = 800):
        self.page_w = page_w
        self.page_h = page_h
        self.pages: List[bytes] = []

    def add_page(self, ops: List[str]) -> None:
        self.pages.append("\n".join(ops).encode("latin1"))

    def render(self) -> bytes:
        # objects: 1 catalog, 2 pages, 3 font, then per page: page obj +
        # content obj
        objs: List[bytes] = []
        n_pages = len(self.pages)
        page_ids = [4 + 2 * i for i in range(n_pages)]
        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        objs.append(b"<< /Type /Catalog /Pages 2 0 R >>")
        objs.append(f"<< /Type /Pages /Kids [{kids}] /Count {n_pages} >>"
                    .encode())
        objs.append(b"<< /Type /Font /Subtype /Type1 /BaseFont /Courier >>")
        for i, content in enumerate(self.pages):
            comp = zlib.compress(content)
            objs.append((
                f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {self.page_w} "
                f"{self.page_h}] /Resources << /Font << /F1 3 0 R >> >> "
                f"/Contents {page_ids[i] + 1} 0 R >>").encode())
            objs.append(b"STREAM" + comp)  # marker replaced below

        out = bytearray(b"%PDF-1.4\n")
        offsets = [0]
        for i, obj in enumerate(objs, start=1):
            offsets.append(len(out))
            if obj.startswith(b"STREAM"):
                body = obj[6:]
                out += (f"{i} 0 obj\n<< /Length {len(body)} "
                        f"/Filter /FlateDecode >>\nstream\n").encode()
                out += body
                out += b"\nendstream\nendobj\n"
            else:
                out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
        xref_pos = len(out)
        out += f"xref\n0 {len(objs) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += f"{off:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
                f"startxref\n{xref_pos}\n%%EOF\n").encode()
        return bytes(out)


def _esc(text: str) -> str:
    return text.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def html_to_pdf(html: str, font_size: float = 8.0) -> bytes:
    """Render a viz HTML snippet/page to PDF bytes."""
    rows = _parse_rows(html)
    char_w = font_size * 0.6     # Courier advance = 600/1000 em
    line_h = font_size + 2.0
    margin = 24.0
    max_cols = max((len(r[1]) for r in rows), default=0)
    page_w = max(600.0, margin * 2 + max_cols * char_w)
    pdf = MiniPdf(page_w=page_w)
    rows_per_page = int((pdf.page_h - 2 * margin) // line_h)

    for start in range(0, len(rows), max(rows_per_page, 1)):
        ops: List[str] = []
        chunk = rows[start:start + rows_per_page]
        # backgrounds first
        for li, (div_cls, chars) in enumerate(chunk):
            y = pdf.page_h - margin - (li + 1) * line_h
            run_start, run_bg = None, None
            for ci, (_ch, cls) in enumerate(chars + [(" ", "")]):
                bg = next((b for b in ("i", "str")
                           if b in cls.split()), None)
                if bg != run_bg:
                    if run_bg is not None:
                        r, g, b = _BG_COLORS[run_bg]
                        x0 = margin + run_start * char_w
                        w = (ci - run_start) * char_w
                        ops.append(f"{r:.3f} {g:.3f} {b:.3f} rg "
                                   f"{x0:.1f} {y - 2:.1f} {w:.1f} "
                                   f"{line_h:.1f} re f")
                    run_start, run_bg = ci, bg
        # text
        ops.append("BT")
        ops.append(f"/F1 {font_size} Tf")
        for li, (div_cls, chars) in enumerate(chunk):
            y = pdf.page_h - margin - (li + 1) * line_h + 2
            # group consecutive chars by text color
            ci = 0
            while ci < len(chars):
                cls = chars[ci][1]
                key = next((k for k in ("x", "d", "m") if k in cls.split()),
                           None) or div_cls or "ref"
                color = _TEXT_COLORS.get(key, (0, 0, 0))
                cj = ci
                text = []
                while cj < len(chars):
                    c2 = chars[cj][1]
                    k2 = next((k for k in ("x", "d", "m")
                               if k in c2.split()), None) or div_cls or "ref"
                    if k2 != key:
                        break
                    text.append(chars[cj][0])
                    cj += 1
                r, g, b = color
                x = margin + ci * char_w
                ops.append(f"{r:.3f} {g:.3f} {b:.3f} rg")
                ops.append(f"1 0 0 1 {x:.1f} {y:.1f} Tm ({_esc(''.join(text))}) Tj")
                ci = cj
        ops.append("ET")
        pdf.add_page(ops)
    return pdf.render()


def main(argv=None) -> int:
    """vizaln-pdf: extract a locus from --viz-out and write a PDF
    (reference: VizAlnPdf wrapper around scripts/html_alns_to_pdf.py)."""
    import argparse
    import sys
    from .viz import extract_locus_html
    ap = argparse.ArgumentParser(prog="vizaln-pdf-tpu")
    ap.add_argument("viz_file")
    ap.add_argument("chrom")
    ap.add_argument("start", type=int)
    ap.add_argument("out", help="output PDF path")
    args = ap.parse_args(argv)
    page = extract_locus_html(args.viz_file, args.chrom, args.start)
    if page is None:
        print("Locus not found in viz file", file=sys.stderr)
        return 1
    with open(args.out, "wb") as fh:
        fh.write(html_to_pdf(page))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
