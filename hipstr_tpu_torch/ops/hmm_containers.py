"""The containers of the stutter-aware HMM's inputs (ops/hmm.py).

They keep the JAX package's field names (hipstr_tpu/ops/hmm.py) and hold
either numpy arrays, as `prepare_locus` (pipeline/locus_pack.py) packs them
in a host worker, or torch tensors, as `locus_to_torch` moves them to a
device.  This module imports no torch: a host worker builds and pickles
these containers without loading it.
"""

from __future__ import annotations

from typing import NamedTuple


class SegmentInputs(NamedTuple):
    """One read segment per pool (left of seed, or reversed right)."""

    codes: torch.Tensor      # [.., P, L] int8 base codes (4 = N/pad)
    quals: torch.Tensor      # [.., P, L] uint8 raw quality bytes (0 = pad)
    last_col: torch.Tensor   # [.., P] int32: segment_len - 1


class HapMeta(NamedTuple):
    """Per-haplotype row metadata for one orientation (fw or rev)."""

    row_char: torch.Tensor       # [.., H, R] int8 hap char codes
    row_m2m: torch.Tensor        # [.., H, R] match->match log prob
    row_m2i: torch.Tensor        # [.., H, R] match->ins
    row_m2d: torch.Tensor        # [.., H, R] match->del
    rep_rev_codes: torch.Tensor  # [.., O, Bmax] repeat alleles, right-to-left
    rep_len: torch.Tensor        # [.., O] int32
    lpmf: torch.Tensor           # [.., O, nD] log P(artifact size)
    hap_opt: torch.Tensor        # [.., H] int32 repeat option per haplotype
    row_active: torch.Tensor     # [.., R] bool; False marks padding rows


class SeedMeta(NamedTuple):
    seed_fw_row: torch.Tensor    # [.., S] fw structural row of the M_l anchor
    seed_rev_row: torch.Tensor   # [.., S] rev structural row of the M_r anchor
    seed_char: torch.Tensor      # [.., H, S] hap char under the seed
    seed_valid: torch.Tensor     # [.., S] bool
    first_char: torch.Tensor     # [.., H]
    last_char: torch.Tensor      # [.., H]
    log_num_seeds: torch.Tensor  # [..]: -log(#flank positions)
    cfg_fw_row: torch.Tensor     # [..] fw row of hap position n-2
    cfg_rev_row: torch.Tensor    # [..] rev row of rev position n-2
