"""Containers, constants and the plain DP rows of the stutter-aware HMM.

Counterpart of hipstr_tpu/ops/hmm.py (reference HapAligner.cpp:26-231).
The containers keep the JAX package's field names; here they hold torch
tensors (or, straight out of `prepare_locus`, numpy arrays).  The row
functions work on [G, H, P, L] state (locus, haplotype, pool, read lane)
with per-(locus, haplotype) row metadata, the layout of the batched
segment forward in ops/hmm2.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hipstr_tpu.models.base_quality import BaseQuality

IMPOSSIBLE = -1.0e9
NEG = -1.0e30
LOG_INS_TO_INS = -1.0
LOG_INS_TO_MATCH = float(np.log1p(-np.exp(-1.0)))
LOG_DEL_TO_DEL = -1.0
LOG_DEL_TO_MATCH = float(np.log1p(-np.exp(-1.0)))


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


def expand_quals(quals: torch.Tensor, dtype: torch.dtype):
    """Raw quality bytes -> (log P(error), log P(correct)) through the
    BaseQuality tables (reference: src/base_quality.h:44-75)."""
    idx = quals.long()
    dev = quals.device
    blw = torch.as_tensor(BaseQuality.log_error_table, dtype=dtype,
                          device=dev)[idx]
    blc = torch.as_tensor(BaseQuality.log_correct_table, dtype=dtype,
                          device=dev)[idx]
    return blw, blc


def shift_right(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x[..., j - 1] along the lane axis, `fill` at lane 0."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def emit(codes, char, blc, blw):
    """[G, H, P, L] emissions: codes [G, P, L] vs per-(locus, hap) char
    [G, H]."""
    eq = codes[:, None] == char[:, :, None, None]
    return torch.where(eq, blc[:, None], blw[:, None])


def flank_row(M, D, em, C, Csh, jj, m2m, m2i, m2d):
    """One flank row (reference HapAligner.cpp:110-156).  State [G,H,P,L];
    C/Csh [G,1,P,L]; jj [L]; m2m/m2i/m2d [G,H,1,1].  The in-row insert
    recurrence is a cumulative max after an affine transform, so the
    previous row's I is never read.  Returns (M, D) of the new row."""
    D_new = torch.maximum(M + LOG_DEL_TO_MATCH, D + LOG_DEL_TO_DEL)
    A = shift_right(M + LOG_INS_TO_MATCH, 0.0)
    A[..., 0] = 0.0
    F = A - Csh - jj * LOG_INS_TO_INS
    I_new = C + jj * LOG_INS_TO_INS + torch.cummax(F, dim=-1).values
    Msh = shift_right(M, NEG)
    Dsh = shift_right(D, NEG)
    Ish = shift_right(I_new, NEG)
    T = torch.maximum(Ish + m2i, torch.maximum(Msh + m2m, Dsh + m2d))
    T[..., 0] = 0.0
    return em + T, D_new


def forced_match_row(M, em):
    """Row right after the repeat block: entered by a match only
    (reference HapAligner.cpp:124-139)."""
    T = shift_right(M, NEG)
    T[..., 0] = 0.0
    return em + T


def stutter_row(M, E_h, lpmf_h, shift, periods):
    """The collapsed repeat-block row (reference HapAligner.cpp:62-108):
    an online log-sum-exp over the nD artifact sizes.

    M [G,H,P,L] previous row; E_h [G,H,nD,P,L] emissions of each
    haplotype's repeat option; lpmf_h [G,H,nD]; shift [G,H] = rep_len +
    D_min (may be negative); periods [G].  The entry of artifact d is
    M[(j - s_d) mod L] with s_d = shift + d * period, and 0.0 (not NEG)
    where j < s_d.  Every term is clamped at IMPOSSIBLE."""
    G, H, P, L = M.shape
    nD = lpmf_h.shape[-1]
    jl = torch.arange(L, device=M.device)
    mx = torch.full_like(M, NEG)
    sm = torch.zeros_like(M)
    for d in range(nD):
        s_d = (shift + d * periods[:, None]).long()[:, :, None, None]
        idx = torch.remainder(jl - s_d, L).expand(G, H, P, L)
        ent = torch.where(jl >= s_d, torch.gather(M, -1, idx), 0.0)
        val = lpmf_h[:, :, d, None, None] + E_h[:, :, d] + ent
        val = torch.clamp(val, min=IMPOSSIBLE)
        new_max = torch.maximum(mx, val)
        sm = sm * torch.exp(mx - new_max) + torch.exp(val - new_max)
        mx = new_max
    return mx + torch.log(sm)
