"""Containers, constants, the plain DP rows and the per-locus forward pass
of the stutter-aware HMM.

Counterpart of hipstr_tpu/ops/hmm.py (reference HapAligner.cpp:26-231).
The containers keep the JAX package's field names; here they hold torch
tensors (or, straight out of `prepare_locus`, numpy arrays).  The row
functions work on [G, H, P, L] state (locus, haplotype, pool, read lane)
with per-(locus, haplotype) row metadata, the layout of the batched
segment forward in ops/hmm2.py; `flank_row` and `forced_match_row` also
take the per-locus [P, H, L] state of `segment_forward`/`hmm_forward`,
which keep the JAX package's per-locus layout.  On the card the per-locus
forward runs K1 (ops/emission.py) and either K3 (fused mode, the
sequential path's: the whole segment) or K4 (flank mode: the flank rows,
with the stutter and forced-match rows in plain torch between its
launches), both in ops/hmm_scan.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.base_quality import BaseQuality

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


CPU_READ_CHUNK = 32     # reads per pass of a plain version on the CPU


def read_chunked(fn, args, read_axes, out_axis: int, **kwargs):
    """fn(*args, **kwargs) over blocks of CPU_READ_CHUNK reads, joined on
    `out_axis`.  Reads are independent in the plain versions this serves
    (no sum, max or scan crosses the read axis), so the result is the
    same to the bit, and on the CPU each block's row state stays in the
    caches: K1 and K2's plain versions on a locus of 1024 pooled reads
    ran 2.5x faster.  `read_axes[i]` is the read axis of args[i], or
    None."""
    P = next(a.shape[ax] for a, ax in zip(args, read_axes) if ax is not None)
    if P <= CPU_READ_CHUNK:
        return fn(*args, **kwargs)
    parts = []
    for p in range(0, P, CPU_READ_CHUNK):
        n = min(CPU_READ_CHUNK, P - p)
        parts.append(fn(*[a if ax is None else a.narrow(ax, p, n)
                          for a, ax in zip(args, read_axes)], **kwargs))
    return torch.cat(parts, dim=out_axis)


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
    C/Csh [G,1,P,L]; jj [L]; m2m/m2i/m2d [G,H,1,1] (or any layout that
    broadcasts against the state with lanes last, such as the per-locus
    [P,H,L] with C [P,1,L] and m2m [1,H,1]).  The in-row insert recurrence
    is a cumulative max after an affine transform, so the previous row's I
    is never read.  Returns (M, I, D) of the new row."""
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
    return em + T, I_new, D_new


def forced_match_row(M, em):
    """Row right after the repeat block: entered by a match only
    (reference HapAligner.cpp:124-139)."""
    T = shift_right(M, NEG)
    T[..., 0] = 0.0
    return em + T


def stutter_row(M, E_h, lpmf_h, shift, periods, clip: bool = False):
    """The collapsed repeat-block row (reference HapAligner.cpp:62-108):
    an online log-sum-exp over the nD artifact sizes.

    M [G,H,P,L] previous row; E_h [G,H,nD,P,L] emissions of each
    haplotype's repeat option; lpmf_h [G,H,nD]; shift [G,H] = rep_len +
    D_min (may be negative); periods [G].  The entry of artifact d is
    M[(j - s_d) mod L] with s_d = shift + d * period (the kernels' entry;
    with `clip`, M[clip(j - s_d, 0, L-1)], the JAX package's XLA row), and
    0.0 (not NEG) where j < s_d.  The two entries agree on every lane a
    read consumes: prepare_locus keeps 6*period lanes of headroom above
    each read's last column.  Every term is clamped at IMPOSSIBLE."""
    G, H, P, L = M.shape
    nD = lpmf_h.shape[-1]
    jl = torch.arange(L, device=M.device)
    mx = torch.full_like(M, NEG)
    sm = torch.zeros_like(M)
    for d in range(nD):
        s_d = (shift + d * periods[:, None]).long()[:, :, None, None]
        idx = (torch.clamp(jl - s_d, 0, L - 1) if clip
               else torch.remainder(jl - s_d, L)).expand(G, H, P, L)
        ent = torch.where(jl >= s_d, torch.gather(M, -1, idx), 0.0)
        val = lpmf_h[:, :, d, None, None] + E_h[:, :, d] + ent
        val = torch.clamp(val, min=IMPOSSIBLE)
        new_max = torch.maximum(mx, val)
        sm = sm * torch.exp(mx - new_max) + torch.exp(val - new_max)
        mx = new_max
    return mx + torch.log(sm)


def emit_locus(codes, char, blc, blw):
    """[P, H, L] emissions of one locus: codes [P, L] vs per-haplotype
    char [H]."""
    eq = codes[:, None] == char[None, :, None]
    return torch.where(eq, blc[:, None], blw[:, None])


def last_col_values(M, last_col):
    """M [P, H, L] at each pool's last read column: [P, H]."""
    P, H, _ = M.shape
    idx = last_col.long()[:, None, None].expand(P, H, 1)
    return torch.gather(M, -1, idx)[..., 0]


def stutter_row_locus(M, meta: HapMeta, E, period: int, clip: bool):
    """`stutter_row` on one locus's [P, H, L] state; E [O, nD, P, L]."""
    hap_opt = meta.hap_opt.long()
    nD = meta.lpmf.shape[-1]
    shift = meta.rep_len.long()[hap_opt] - ((nD - 1) // 2) * period
    periods = torch.full((1,), period, dtype=torch.long, device=M.device)
    out = stutter_row(M.transpose(0, 1)[None], E[hap_opt][None],
                      meta.lpmf.to(M.dtype)[hap_opt][None], shift[None],
                      periods, clip=clip)
    return out[0].transpose(0, 1).contiguous()


def segment_rows(codes, blw, blc, C, Csh, last_col, meta: HapMeta, E,
                 R: int, sr: int, period: int, scan, clip: bool):
    """One orientation of one locus row by row: row 0, the phase-1 flank
    rows through `scan` (a flank scan with the contract of
    ops/hmm_scan.flank_scan), the stutter row (`clip` picks its entry),
    the forced-match row, the phase-3 flank rows through `scan`.  Returns
    Mcol [R, P, H]."""
    P, L = codes.shape
    M = emit_locus(codes, meta.row_char[:, 0], blc, blw) + Csh[:, None]
    I = C[:, None].expand(M.shape).contiguous()
    D = torch.full_like(M, IMPOSSIBLE)
    pieces = [last_col_values(M, last_col)[None]]

    def rows(M, I, D, lo, hi):
        if hi <= lo:
            return M, I, D
        M, I, D, Mcol = scan(codes, blw, blc, C, Csh, last_col,
                             *(x[:, lo:hi].T for x in (
                                 meta.row_char, meta.row_m2m, meta.row_m2i,
                                 meta.row_m2d)),
                             meta.row_active[lo:hi], M, I, D)
        pieces.append(Mcol)
        return M, I, D

    # phase 1: flank rows 1 .. sr-1
    M, I, D = rows(M, I, D, 1, sr)
    # phase 2: the stutter row, then the forced-match row
    M = stutter_row_locus(M, meta, E, period, clip)
    I = D = torch.full_like(M, IMPOSSIBLE)
    pieces.append(last_col_values(M, last_col)[None])
    if sr + 1 < R:
        M = forced_match_row(M, emit_locus(codes, meta.row_char[:, sr + 1],
                                           blc, blw))
        pieces.append(last_col_values(M, last_col)[None])
    # phase 3: remaining flank rows
    rows(M, I, D, sr + 2, R)
    return torch.cat(pieces)


def segment_forward(seg: SegmentInputs, meta: HapMeta, R: int, period: int,
                    sr: int, dtype, mode: str):
    """One orientation of one locus: (Mcol [R, P, H], seg_logsum [P]).

    seg holds codes/quals [P, L] and last_col [P]; meta is one locus's
    HapMeta ([H, R] rows).  E comes from K1 (G = 1).  mode "fused" runs
    the whole segment in one K3 launch; mode "flank" (the JAX package's
    default Pallas mode) scans the flank rows with K4 and keeps the
    stutter row, with its clipped entry, and the forced-match row in plain
    torch.  The mode has no default here: the sequential path's is
    pipeline/hap_aligner.compute_hap_log_likelihoods's.  On CPU tensors
    the kernels' plain versions run instead."""
    # imported here: hmm_scan builds on this module's rows
    from .emission import stutter_emissions
    from .hmm_scan import flank_scan, segment_scan
    if mode not in ("flank", "fused"):
        raise ValueError(f"segment_forward: unknown mode {mode!r}")
    blw, blc = expand_quals(seg.quals, dtype)
    codes = seg.codes.int()
    last_col = seg.last_col.int()
    C = torch.cumsum(blc, dim=-1)
    Csh = shift_right(C, 0.0)
    periods = torch.full((1,), period, dtype=torch.int32, device=codes.device)
    E = stutter_emissions(codes[None], blw[None], blc[None],
                          meta.rep_rev_codes.int()[None],
                          meta.rep_len.int()[None], periods)[0]
    if mode == "fused":
        Mcol = segment_scan(codes, blw, blc, C, Csh, last_col, meta, E, R,
                            sr, period)
    else:
        Mcol = segment_rows(codes, blw, blc, C, Csh, last_col, meta, E, R,
                            sr, period, flank_scan, clip=True)
    seg_logsum = torch.gather(C, -1, seg.last_col.long()[:, None])[:, 0]
    return Mcol, seg_logsum


def hmm_forward(l_seg: SegmentInputs, r_seg: SegmentInputs,
                fw_meta: HapMeta, rev_meta: HapMeta, seed: SeedMeta,
                seed_codes, seed_quals, R_fw: int, R_rev: int, period: int,
                sr_fw: int, sr_rev: int, dtype, mode: str):
    """Full forward pass of one locus: LL [P, H] (reference
    HapAligner::process_read + compute_aln_logprob, HapAligner.cpp:573-709,
    :163-231).  The left segment aligns against the forward haplotype, the
    reversed right segment against the reversed haplotype, and the seed
    base marginalises over anchor positions (ops/hmm2.seed_combine with a
    locus axis of 1).  `mode` is segment_forward's.  Padded haplotype
    columns are computed like real ones; callers slice [:P_real,
    :H_real]."""
    from .hmm2 import seed_combine
    Mcol_fw, l_prob = segment_forward(l_seg, fw_meta, R_fw, period, sr_fw,
                                      dtype, mode)
    Mcol_rev, r_prob = segment_forward(r_seg, rev_meta, R_rev, period,
                                       sr_rev, dtype, mode)
    seed_blw, seed_blc = expand_quals(seed_quals, dtype)
    return seed_combine(Mcol_fw[None], Mcol_rev[None], l_prob[None],
                        r_prob[None], SeedMeta(*[x[None] for x in seed]),
                        seed_codes[None], seed_blw[None], seed_blc[None],
                        dtype)[0]
