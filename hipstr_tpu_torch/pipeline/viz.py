"""Copy of hipstr_tpu/pipeline/viz.py.

Alignment visualization (HTML).

Capability parity with the reference AlignmentViz/HTMLCreator + VizAln
(reference: src/SeqAlignment/{AlignmentViz,HTMLCreator}.{h,cpp}, VizAln,
scripts/generate_aln_html.py): per-locus, per-sample maximum-likelihood read
alignments rendered as stacked monospace rows against the reference window,
with mismatches, insertions and deletions highlighted and the repeat block
shaded; records are written as indexable bgzipped lines that the vizaln
entry point extracts into standalone HTML pages.
"""

from __future__ import annotations

import html as html_mod
from typing import Dict, List, Optional, Tuple

from ..align.alignment_data import Alignment

_CSS = """
<style>
.aln { font-family: monospace; white-space: pre; font-size: 12px; }
.ref { color: #222; font-weight: bold; }
.samp { color: #116; font-weight: bold; margin-top: 6px; }
.m { color: #999; }
.x { color: #c22; font-weight: bold; }
.i { background: #fc6; }
.d { color: #36c; }
.str { background: #def; }
.coord { color: #666; }
</style>
"""


def _render_read(aln: Alignment, window_start: int, window_end: int,
                 ref_seq: str, str_start: int, str_end: int) -> str:
    """One read row: spaces up to its start, then per-base markup."""
    parts = []
    pad = aln.start - window_start
    parts.append(" " * max(0, pad))
    pos = aln.start
    for ch in aln.alignment:
        if pos >= window_end:
            break
        if ch == "-":
            parts.append('<span class="d">-</span>')
            pos += 1
            continue
        ref_base = ref_seq[pos - window_start] if 0 <= pos - window_start < len(ref_seq) else "N"
        cls = "m" if ch.upper() == ref_base.upper() else "x"
        if str_start <= pos < str_end:
            parts.append(f'<span class="str {cls}">{ch}</span>')
        else:
            parts.append(f'<span class="{cls}">{ch}</span>')
        pos += 1
    return "".join(parts)


def visualize_alignments(alns_by_sample: Dict[str, List[Alignment]],
                         sample_results: Dict[str, str],
                         chrom_seq: str, chrom: str,
                         str_start: int, str_end: int,
                         pad: int = 40) -> str:
    """Build the HTML snippet for one locus."""
    all_alns = [a for alns in alns_by_sample.values() for a in alns]
    if not all_alns:
        return ""
    window_start = max(0, min(a.start for a in all_alns))
    window_end = min(len(chrom_seq), max(a.stop + 1 for a in all_alns))
    ref_seq = chrom_seq[window_start:window_end]

    out = [_CSS, f'<div class="aln">']
    out.append(f'<div class="coord">{chrom}:{window_start + 1}-{window_end}'
               f' (STR {str_start + 1}-{str_end})</div>')
    ref_row = []
    for i, b in enumerate(ref_seq):
        p = window_start + i
        if str_start <= p < str_end:
            ref_row.append(f'<span class="str">{b.upper()}</span>')
        else:
            ref_row.append(b.upper())
    out.append('<div class="ref">' + "".join(ref_row) + "</div>")

    for sample in sorted(alns_by_sample):
        result = sample_results.get(sample, "")
        out.append(f'<div class="samp">{html_mod.escape(sample)}'
                   + (f" ({result})" if result else "") + "</div>")
        for aln in sorted(alns_by_sample[sample], key=lambda a: a.start):
            out.append("<div>" + _render_read(aln, window_start, window_end,
                                              ref_seq, str_start, str_end)
                       + "</div>")
    out.append("</div>")
    return "".join(out)


class VizWriter:
    """Bgzipped, line-indexable viz records: chrom, start, stop, html."""

    def __init__(self, path: str):
        from ..io.bgzf import BgzfWriter
        self._w = BgzfWriter(path)

    def add(self, chrom: str, start: int, stop: int, html: str) -> None:
        # records are line-based; keep the HTML on one line
        flat = html.replace("\n", " ").replace("\t", " ")
        record = f"{chrom}\t{start}\t{stop}\t{flat}\n"
        self._w.write(record.encode())

    def close(self) -> None:
        self._w.close()


def extract_locus_html(viz_path: str, chrom: str, start: int) -> Optional[str]:
    """Pull one locus's record out of a viz file (the vizaln entry point)."""
    from ..io.bgzf import BgzfReader
    data = BgzfReader(viz_path).read_all().decode()
    for line in data.splitlines():
        toks = line.split("\t", 3)
        if len(toks) == 4 and toks[0] == chrom and int(toks[1]) == start:
            return ("<html><head><title>" + f"{chrom}:{start}"
                    + "</title></head><body>" + toks[3] + "</body></html>")
    return None


def main(argv=None) -> int:
    """vizaln: extract a locus from --viz-out and write an HTML page."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="vizaln-tpu")
    ap.add_argument("viz_file")
    ap.add_argument("chrom")
    ap.add_argument("start", type=int)
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)
    page = extract_locus_html(args.viz_file, args.chrom, args.start)
    if page is None:
        print("Locus not found in viz file", file=sys.stderr)
        return 1
    if args.out == "-":
        sys.stdout.write(page)
    else:
        with open(args.out, "w") as fh:
            fh.write(page)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
