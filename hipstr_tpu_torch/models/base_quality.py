"""Copy of hipstr_tpu/models/base_quality.py.

Phred+33 base-quality probability tables.

Capability parity with the reference BaseQuality (reference:
src/base_quality.{h,cpp}:15-85): log P(correct) / log P(specific error)
lookups over the Illumina 1.8 quality range '!'..'J', clamped outside it, plus
pooled median-quality strings.  Exposed as flat numpy tables indexed by raw
quality byte so reads can be converted to [read_len] log-prob vectors with one
gather.
"""

from __future__ import annotations

import math

import numpy as np

MIN_BASE_QUALITY = ord("!")  # 33
MAX_BASE_QUALITY = ord("J")  # 74
_MAX_QUAL_INDEX = MAX_BASE_QUALITY - MIN_BASE_QUALITY
_LOG_3 = math.log(3.0)


def _build_tables():
    log_correct = np.empty(_MAX_QUAL_INDEX + 1, dtype=np.float64)
    log_error = np.empty(_MAX_QUAL_INDEX + 1, dtype=np.float64)
    log_correct[0] = -100000.0
    log_error[0] = -_LOG_3
    for i in range(1, _MAX_QUAL_INDEX + 1):
        p_err = 10.0 ** (i / -10.0)
        log_correct[i] = math.log(1.0 - p_err)
        log_error[i] = math.log(p_err / 3.0)

    # 256-entry tables indexed by raw byte, with clamping semantics matching
    # BaseQuality::log_prob_error/correct (src/base_quality.h:44-75).
    by_byte_correct = np.empty(256, dtype=np.float64)
    by_byte_error = np.empty(256, dtype=np.float64)
    for b in range(256):
        idx = min(max(b - MIN_BASE_QUALITY, 0), _MAX_QUAL_INDEX)
        by_byte_correct[b] = log_correct[idx]
        by_byte_error[b] = log_error[idx]
    return by_byte_correct, by_byte_error


_LOG_CORRECT_BY_BYTE, _LOG_ERROR_BY_BYTE = _build_tables()


class BaseQuality:
    """Quality-string -> log-probability conversion."""

    log_correct_table = _LOG_CORRECT_BY_BYTE
    log_error_table = _LOG_ERROR_BY_BYTE

    def log_prob_correct(self, qual_char: str) -> float:
        return float(_LOG_CORRECT_BY_BYTE[ord(qual_char)])

    def log_prob_error(self, qual_char: str) -> float:
        return float(_LOG_ERROR_BY_BYTE[ord(qual_char)])

    def sum_log_prob_correct(self, qualities: str) -> float:
        return float(np.sum(self.quals_to_log_correct(qualities)))

    @staticmethod
    def quals_to_log_correct(qualities: str) -> np.ndarray:
        b = np.frombuffer(qualities.encode("latin1"), dtype=np.uint8)
        return _LOG_CORRECT_BY_BYTE[b]

    @staticmethod
    def quals_to_log_error(qualities: str) -> np.ndarray:
        b = np.frombuffer(qualities.encode("latin1"), dtype=np.uint8)
        return _LOG_ERROR_BY_BYTE[b]

    @staticmethod
    def median_base_qualities(quality_strings) -> str:
        """Per-position median across equal-length quality strings.

        Used when pooling identical read sequences (reference:
        src/base_quality.cpp median_base_qualities + src/read_pooler.cpp).
        The reference takes, per position, the element at index n//2 of the
        sorted characters; replicate that (not an averaged median).
        """
        assert quality_strings, "empty pool"
        lengths = {len(q) for q in quality_strings}
        assert len(lengths) == 1, "pooled quality strings must share length"
        arr = np.stack([
            np.frombuffer(q.encode("latin1"), dtype=np.uint8) for q in quality_strings
        ])
        med = np.sort(arr, axis=0)[arr.shape[0] // 2]
        return med.tobytes().decode("latin1")
