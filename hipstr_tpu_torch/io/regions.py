"""Copy of hipstr_tpu/io/regions.py.

STR region records and BED reading.

Capability parity with the reference Region/readRegions (reference:
src/region.{h,cpp}): 1-based inclusive BED columns become 0-based
half-open coordinates, periods must lie in [1, 9], optional name column,
chromosome filter and max-region cap, sorted output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class Region:
    chrom: str
    start: int   # 0-based inclusive
    stop: int    # 0-based exclusive-ish (reference uses stop as last position+1?)
    period: int
    name: str = ""

    def __post_init__(self):
        assert self.stop > self.start

    def __str__(self):
        return f"{self.chrom}:{self.start}-{self.stop}"

    def key(self):
        return (self.chrom, self.start, self.stop)


def read_regions(path: str, max_regions: int = 1000000000,
                 chrom_limit: str = "", shard: "Optional[Tuple[int, int]]" = None
                 ) -> List[Region]:
    """BED reader (reference: src/region.cpp:14-56).

    Columns: chrom, start(1-based), stop(1-based inclusive), period, [score,
    name]; stored as start-1/stop (the reference subtracts 1 from the start
    only, region.cpp:33-43).
    """
    regions: List[Region] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            toks = line.split()
            # required columns: CHROM START STOP PERIOD NCOPIES (+ optional NAME)
            if len(toks) < 5:
                raise ValueError(f"Improperly formatted BED line: {line!r}")
            chrom, start, stop, period = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
            if chrom_limit and chrom != chrom_limit:
                continue
            if not (1 <= period <= 9):
                raise ValueError(f"BED period must be in [1,9]: {line!r}")
            if start <= 0 or stop <= start:
                raise ValueError(f"Invalid BED coordinates: {line!r}")
            name = toks[5] if len(toks) > 5 else ""
            regions.append(Region(chrom, start - 1, stop, period, name))
            if len(regions) >= max_regions:
                break
    regions.sort(key=lambda r: (r.chrom, r.start, r.stop))
    if shard is not None:
        index, count = shard
        assert 0 <= index < count
        regions = regions[index::count]
    return regions
