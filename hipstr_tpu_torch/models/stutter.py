"""Copy of hipstr_tpu/models/stutter.py.

PCR stutter model.

Mixture of in-frame (geometric in repeat units) and out-of-frame (geometric in
base pairs) stutter artifact distributions plus a no-change probability.
Capability parity with the reference StutterModel (reference:
src/stutter_model.{h,cpp}: log_stutter_pmf at src/stutter_model.cpp:29-53,
text serialization at :55-93).  Re-designed for TPU use: the PMF is exposed
both as an exact scalar (host) and as a closed-form vectorized grid evaluation
(``log_pmf_grid``) that device kernels consume as a dense [alleles x diffs]
tensor.
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass, replace

import numpy as np


def _trunc_div(a, b):
    """C++-style integer division (truncation toward zero)."""
    return np.trunc(np.asarray(a, dtype=np.float64) / b).astype(np.int64)


@dataclass(frozen=True)
class StutterModel:
    in_geom: float
    in_up: float
    in_down: float
    out_geom: float
    out_up: float
    out_down: float
    period: int

    def __post_init__(self):
        assert 0.0 < self.in_geom < 1.0, self.in_geom
        assert 0.0 < self.out_geom < 1.0, self.out_geom
        assert self.in_up > 0.0 and self.in_down > 0.0
        assert self.out_up > 0.0 and self.out_down > 0.0
        assert self.in_up + self.in_down + self.out_up + self.out_down < 1.0
        assert 0 < self.period < 10

    # ---- derived log-parameters -------------------------------------------------
    @property
    def log_equal(self):
        return math.log(1.0 - self.in_up - self.in_down - self.out_up - self.out_down)

    def log_pmf(self, sample_bps: int, read_bps: int) -> float:
        """Exact scalar log P(read STR bp | true STR bp)."""
        bp_diff = read_bps - sample_bps
        if bp_diff % self.period != 0:
            # out-of-frame: geometric in effective bp (excluding whole units)
            eff_diff = bp_diff - int(_trunc_div(bp_diff, self.period))
            if eff_diff < 0:
                return (math.log(self.out_down) + math.log(self.out_geom)
                        + math.log(1 - self.out_geom) * (-eff_diff - 1))
            return (math.log(self.out_up) + math.log(self.out_geom)
                    + math.log(1 - self.out_geom) * (eff_diff - 1))
        rep_diff = bp_diff // self.period
        if rep_diff == 0:
            return self.log_equal
        if rep_diff < 0:
            return (math.log(self.in_down) + math.log(self.in_geom)
                    + math.log(1 - self.in_geom) * (-rep_diff - 1))
        return (math.log(self.in_up) + math.log(self.in_geom)
                + math.log(1 - self.in_geom) * (rep_diff - 1))

    def log_pmf_grid(self, sample_bps, read_bps):
        """Vectorized log PMF over broadcastable integer arrays.

        Pure closed form; usable on host (numpy) and as the generator of the
        dense stutter-probability tensors consumed by device kernels.
        """
        sample_bps = np.asarray(sample_bps, dtype=np.int64)
        read_bps = np.asarray(read_bps, dtype=np.int64)
        bp_diff = read_bps - sample_bps
        in_frame = (bp_diff % self.period) == 0

        # out-of-frame branch
        eff_diff = bp_diff - _trunc_div(bp_diff, self.period)
        out_pmf = np.where(
            eff_diff < 0,
            math.log(self.out_down) + math.log(self.out_geom)
            + math.log(1 - self.out_geom) * (-eff_diff - 1),
            math.log(self.out_up) + math.log(self.out_geom)
            + math.log(1 - self.out_geom) * (eff_diff - 1),
        )

        # in-frame branch
        rep_diff = bp_diff // self.period
        in_pmf = np.where(
            rep_diff == 0,
            self.log_equal,
            np.where(
                rep_diff < 0,
                math.log(self.in_down) + math.log(self.in_geom)
                + math.log(1 - self.in_geom) * (-rep_diff - 1),
                math.log(self.in_up) + math.log(self.in_geom)
                + math.log(1 - self.in_geom) * (np.abs(rep_diff) - 1),
            ),
        )
        return np.where(in_frame, in_pmf, out_pmf)

    def artifact_log_probs(self, allele_len: int, max_del: int, max_ins: int):
        """log P(artifact size D) for D in [max_del, max_ins] step period.

        Mirrors RepeatStutterInfo::log_prob_pcr_artifact (reference:
        src/SeqAlignment/RepeatStutterInfo.h:53-61): artifacts yielding a
        negative read size get a large negative score.
        """
        sizes = np.arange(max_del, max_ins + 1, self.period, dtype=np.int64)
        read_sizes = allele_len + sizes
        probs = self.log_pmf_grid(allele_len, read_sizes).astype(np.float64)
        probs = np.where(read_sizes < 0, -10e6, probs)
        return sizes, probs

    def parameters_within_threshold(self, other: "StutterModel", max_diff: float) -> bool:
        return (abs(other.in_geom - self.in_geom) < max_diff
                and abs(other.in_up - self.in_up) < max_diff
                and abs(other.in_down - self.in_down) < max_diff
                and abs(other.out_geom - self.out_geom) < max_diff
                and abs(other.out_up - self.out_up) < max_diff
                and abs(other.out_down - self.out_down) < max_diff)

    def with_period(self, period: int) -> "StutterModel":
        return replace(self, period=period)

    # ---- text (de)serialization: 7 whitespace-separated columns per model -------
    # Column order matches the reference's stutter-model files
    # (src/stutter_model.cpp:55-58): in_geom in_down in_up out_geom out_down
    # out_up period, preceded by chrom/start/end for regional files.
    def to_line(self) -> str:
        return (f"{self.in_geom:g}\t{self.in_down:g}\t{self.in_up:g}\t"
                f"{self.out_geom:g}\t{self.out_down:g}\t{self.out_up:g}\t{self.period}")

    @classmethod
    def from_tokens(cls, toks) -> "StutterModel":
        if len(toks) < 7:
            raise ValueError("Improperly formatted stutter model line")
        in_geom, in_down, in_up, out_geom, out_down, out_up = map(float, toks[:6])
        period = int(toks[6])
        if not (1 <= period <= 9):
            raise ValueError("Stutter model motif length must be in [1, 9]")
        return cls(in_geom, in_up, in_down, out_geom, out_up, out_down, period)

    @classmethod
    def default(cls, period: int) -> "StutterModel":
        """EM initialization model (reference: src/em_stutter_genotyper.cpp:58-61)."""
        return cls(0.9, 0.1, 0.1, 0.8, 0.01, 0.01, period)


def read_stutter_models(fh) -> dict:
    """Read a regional stutter-model file: chrom start end + 7 model columns.

    Returns {(chrom, start, end): StutterModel}.  Reference:
    src/stutter_model.cpp:81-93.
    """
    models = {}
    for line in fh:
        toks = line.split()
        if not toks:
            continue
        chrom, start, end = toks[0], int(toks[1]), int(toks[2])
        models[(chrom, start, end)] = StutterModel.from_tokens(toks[3:])
    return models


def write_stutter_models(models: dict, fh) -> None:
    for (chrom, start, end), model in sorted(models.items()):
        fh.write(f"{chrom}\t{start}\t{end}\t{model.to_line()}\n")
