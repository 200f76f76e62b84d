"""Copy of hipstr_tpu/align/haplotype.py.

Host-side haplotype model: blocks, repeat info, combination enumeration.

Capability parity with the reference's HapBlock/RepeatBlock/Haplotype
(reference: src/SeqAlignment/{HapBlock,RepeatBlock,Haplotype}.{h,cpp}), with a
TPU-first re-design: instead of a stateful Gray-code iterator that mutates one
block at a time (the reference's cache-reuse trick, Haplotype.cpp:157-196), we
enumerate all combinations up front with a closed-form reflected Gray code
(same index -> options mapping as the reference, so haplotype indices line up
for output parity) and emit dense per-row metadata tensors that the batched
device HMM consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..models.stutter import StutterModel

# Maximum number of repeat units PCR stutter may add/remove
# (reference: src/SeqAlignment/RepeatStutterInfo.h:10-11).
MAX_STUTTER_REPEAT_INS = 6
MAX_STUTTER_REPEAT_DEL = -6
LARGE_NEGATIVE = -10e6


def _homopolymer_lengths(seq: str) -> Tuple[np.ndarray, np.ndarray]:
    """Left/right same-char run lengths per position.

    Replicates the reference's calc_homopolymer_lengths
    (src/SeqAlignment/HapBlock.cpp:7-30) including its quirk: the run counter
    is not reset between the left scan and the right scan, so when the
    sequence's tail continues a run, the right-lengths absorb the leftover
    counter.  We reproduce that behavior for output parity (lengths are capped
    at MAX_HOMOP_LEN downstream, bounding the impact).
    """
    n = len(seq)
    llens = np.zeros(n, dtype=np.int64)
    rlens = np.zeros(n, dtype=np.int64)
    count = 0
    for j in range(1, n):
        count = count + 1 if seq[j - 1] == seq[j] else 0
        llens[j] = count
    # NOTE: count intentionally not reset (reference parity)
    for j in range(n - 2, -1, -1):
        count = count + 1 if seq[j + 1] == seq[j] else 0
        rlens[j] = count
    return llens, rlens


@dataclass
class RepeatInfo:
    """Stutter bounds + model for a repeat block.

    Reference: src/SeqAlignment/RepeatStutterInfo.h:14-62.
    """

    period: int
    stutter_model: StutterModel
    allele_sizes: List[int] = field(default_factory=list)

    @property
    def max_insertion(self) -> int:
        return MAX_STUTTER_REPEAT_INS * self.period

    @property
    def max_deletion(self) -> int:
        return MAX_STUTTER_REPEAT_DEL * self.period

    def artifact_sizes(self) -> np.ndarray:
        return np.arange(self.max_deletion, self.max_insertion + 1, self.period)

    def log_prob_pcr_artifact(self, seq_index: int, artifact_size: int) -> float:
        read_size = self.allele_sizes[seq_index] + artifact_size
        if artifact_size == 0:
            return self.stutter_model.log_pmf(self.allele_sizes[seq_index], read_size)
        if artifact_size > 0:
            if artifact_size > self.max_insertion:
                return LARGE_NEGATIVE
        else:
            if artifact_size < self.max_deletion or read_size < 0:
                return LARGE_NEGATIVE
        return self.stutter_model.log_pmf(self.allele_sizes[seq_index], read_size)


class HapBlock:
    """One haplotype block: reference sequence + alternates over [start, end).

    Reference: src/SeqAlignment/HapBlock.h:18-148.  Repeat blocks carry a
    RepeatInfo (reference RepeatBlock, src/SeqAlignment/RepeatBlock.h:15-70).
    """

    def __init__(self, start: int, end: int, ref_seq: str,
                 repeat_info: Optional[RepeatInfo] = None):
        self.start = start
        self.end = end
        self.seqs: List[str] = [ref_seq]
        self.repeat_info = repeat_info
        self._lhomop: List[np.ndarray] = []
        self._rhomop: List[np.ndarray] = []
        l, r = _homopolymer_lengths(ref_seq)
        self._lhomop.append(l)
        self._rhomop.append(r)
        if repeat_info is not None:
            repeat_info.allele_sizes.append(len(ref_seq))

    @property
    def is_repeat(self) -> bool:
        return self.repeat_info is not None

    def add_alternate(self, alt: str) -> None:
        self.seqs.append(alt)
        l, r = _homopolymer_lengths(alt)
        self._lhomop.append(l)
        self._rhomop.append(r)
        if self.repeat_info is not None:
            self.repeat_info.allele_sizes.append(len(alt))

    def num_options(self) -> int:
        return len(self.seqs)

    def get_seq(self, index: int) -> str:
        return self.seqs[index]

    def size(self, index: int) -> int:
        return len(self.seqs[index])

    def min_size(self) -> int:
        return min(len(s) for s in self.seqs)

    def max_size(self) -> int:
        return max(len(s) for s in self.seqs)

    def contains(self, seq: str) -> bool:
        return seq in self.seqs

    def index_of(self, seq: str) -> int:
        return self.seqs.index(seq)

    def left_homopolymer_len(self, seq_index: int, base_index: int) -> int:
        arr = self._lhomop[seq_index]
        return 0 if arr.size == 0 else int(arr[base_index])

    def right_homopolymer_len(self, seq_index: int, base_index: int) -> int:
        arr = self._rhomop[seq_index]
        return 0 if arr.size == 0 else int(arr[base_index])

    def reverse(self) -> "HapBlock":
        rinfo = None
        if self.repeat_info is not None:
            rinfo = RepeatInfo(self.repeat_info.period, self.repeat_info.stutter_model)
        rev = HapBlock(self.end - 1, self.start - 1, self.seqs[0][::-1], rinfo)
        for alt in self.seqs[1:]:
            rev.add_alternate(alt[::-1])
        return rev

    def remove_alleles(self, allele_indices) -> "HapBlock":
        bad = set(allele_indices)
        assert 0 not in bad
        rinfo = None
        if self.repeat_info is not None:
            rinfo = RepeatInfo(self.repeat_info.period, self.repeat_info.stutter_model)
        blk = HapBlock(self.start, self.end, self.seqs[0], rinfo)
        for i, alt in enumerate(self.seqs[1:], start=1):
            if i not in bad:
                blk.add_alternate(alt)
        return blk


def gray_digits(h: int, nopts: List[int]) -> List[int]:
    """Closed-form reflected mixed-radix Gray code digit extraction.

    Yields the same haplotype-index -> per-block-option mapping as the
    reference's boustrophedon iterator (Haplotype::next, Haplotype.cpp:157-196
    with factors from init at :123-149): block 0 is the fastest-changing digit
    and each digit sweeps up then down as higher digits advance.
    """
    digits = []
    factor = 1
    for n in nopts:
        q = h // factor
        r = q % n
        p = q // n
        digits.append(r if p % 2 == 0 else n - 1 - r)
        factor *= n
    return digits


class Haplotype:
    """A set of blocks whose option combinations define candidate haplotypes."""

    def __init__(self, blocks: List[HapBlock]):
        self.blocks = blocks
        self.nopts = [b.num_options() for b in blocks]
        self.num_combs = int(np.prod(self.nopts))
        self.max_size = sum(b.max_size() for b in blocks)

    def num_blocks(self) -> int:
        return len(self.blocks)

    def digits(self, h: int) -> List[int]:
        return gray_digits(h, self.nopts)

    def block_options(self, h: int) -> List[int]:
        return self.digits(h)

    def block_seqs(self, h: int) -> List[str]:
        return [b.get_seq(d) for b, d in zip(self.blocks, self.digits(h))]

    def seq(self, h: int) -> str:
        return "".join(self.block_seqs(h))

    def cur_size(self, h: int) -> int:
        return sum(b.size(d) for b, d in zip(self.blocks, self.digits(h)))

    def hap_index_for_options(self, options: List[int]) -> int:
        """Inverse of digits(): find h whose Gray digits equal `options`.

        Unrolls the reflected code from the most-significant block down:
        q_{i} = r_i + n_i * q_{i+1} with r_i reflected when q_{i+1} is odd.
        """
        q = 0
        for i in range(len(self.nopts) - 1, -1, -1):
            n = self.nopts[i]
            d = options[i]
            r = d if q % 2 == 0 else n - 1 - d
            q = r + n * q
        return q

    # ---- homopolymer lengths (cross-block aware) --------------------------------
    # Reference: Haplotype::homopolymer_length + left/right helpers
    # (src/SeqAlignment/Haplotype.cpp:239-287).
    def _left_homopolymer_len(self, digits, c: str, block_index: int) -> int:
        total = 0
        while block_index >= 0:
            seq = self.blocks[block_index].get_seq(digits[block_index])
            if seq:
                if seq[-1] == c:
                    llen = self.blocks[block_index].left_homopolymer_len(
                        digits[block_index], len(seq) - 1)
                    total += 1 + llen
                    if llen != len(seq):
                        break
                else:
                    break
            block_index -= 1
        return total

    def _right_homopolymer_len(self, digits, c: str, block_index: int) -> int:
        total = 0
        while block_index < len(self.blocks):
            seq = self.blocks[block_index].get_seq(digits[block_index])
            if seq:
                if seq[0] == c:
                    rlen = self.blocks[block_index].right_homopolymer_len(
                        digits[block_index], 0)
                    total += 1 + rlen
                    if rlen != len(seq):
                        break
                else:
                    break
            block_index += 1
        return total

    def homopolymer_length(self, h: int, block_index: int, base_index: int) -> int:
        return self.homopolymer_length_digits(self.digits(h), block_index, base_index)

    def homopolymer_array(self, digits, block_index: int) -> np.ndarray:
        """Vectorized homopolymer_length_digits over every base of one
        block (cached per (digits, block) — the hot consumers, device
        packing and native-trace metadata, need the whole column).

        Semantics per element match homopolymer_length_digits: the block's
        precomputed left/right run arrays plus cross-block extension at the
        (few) positions whose run reaches a block edge."""
        cache = getattr(self, "_homop_arr_cache", None)
        if cache is None:
            cache = self._homop_arr_cache = {}
        key = (tuple(digits), block_index)
        out = cache.get(key)
        if out is not None:
            return out
        # content-keyed cache shared across a locus's haplotype rebuilds
        # (attached by the genotyper): the array depends only on the
        # realized block sequences, which survive allele add/remove rounds
        shared = getattr(self, "_homop_content_cache", None)
        ckey = None
        if shared is not None:
            ckey = (tuple(b.get_seq(d) for b, d in zip(self.blocks, digits)),
                    block_index)
            out = shared.get(ckey)
            if out is not None:
                cache[key] = out
                return out
        block = self.blocks[block_index]
        d = digits[block_index]
        seq = block.get_seq(d)
        n = len(seq)
        if n == 0:
            out = cache[key] = np.zeros(0, dtype=np.int64)
            return out
        llen = block._lhomop[d]
        rlen = block._rhomop[d]
        out = llen + rlen + 1
        idx = np.arange(n)
        for i in np.nonzero(idx == llen)[0]:
            out[i] += self._left_homopolymer_len(digits, seq[i],
                                                 block_index - 1)
        for i in np.nonzero(idx + rlen == n - 1)[0]:
            out[i] += self._right_homopolymer_len(digits, seq[i],
                                                  block_index + 1)
        cache[key] = out
        if shared is not None:
            shared[ckey] = out
        return out

    def reversed_view(self) -> "Haplotype":
        """reverse(), cached.  Invalidated when a repeat block's stutter
        model object is swapped (recompute_stutter_models mutates it in
        place on the original blocks)."""
        key = tuple(id(b.repeat_info.stutter_model) if b.repeat_info else None
                    for b in self.blocks)
        cached = getattr(self, "_rev_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rev = self.reverse()
        shared = getattr(self, "_homop_content_cache", None)
        if shared is not None:
            # reversed sequences get distinct content keys in the same map
            rev._homop_content_cache = shared
        self._rev_cache = (key, rev)
        return rev

    def homopolymer_length_digits(self, digits, block_index: int, base_index: int) -> int:
        block = self.blocks[block_index]
        seq = block.get_seq(digits[block_index])
        llen = block.left_homopolymer_len(digits[block_index], base_index)
        rlen = block.right_homopolymer_len(digits[block_index], base_index)
        if base_index - llen == 0:
            llen += self._left_homopolymer_len(digits, seq[base_index], block_index - 1)
        if base_index + rlen == len(seq) - 1:
            rlen += self._right_homopolymer_len(digits, seq[base_index], block_index + 1)
        return llen + rlen + 1

    def reverse(self) -> "Haplotype":
        rev_blocks = [b.reverse() for b in reversed(self.blocks)]
        return Haplotype(rev_blocks)

    def reversed_digits(self, h: int) -> List[int]:
        """Options of the reversed haplotype that pair with fw index h.

        The reference iterates fw and rev haplotypes in lockstep
        (HapAligner.cpp:692); a rev haplotype's block j is fw block n-1-j with
        the same option index.
        """
        return list(reversed(self.digits(h)))
