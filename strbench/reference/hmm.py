"""The plain reference of the alignment HMM: read x haplotype
log-likelihoods of a batched dispatch, recomputed from the dispatch's packed
inputs in a precision of the caller's choosing.

A frozen copy of the port's plain PyTorch versions as they stood when the
benchmark was defined (hipstr_tpu_torch/ops/hmm.py's rows,
ops/stutter_emission.stutter_emissions_plain, ops/hmm2.segment_forward_plain
and seed_combine; reference HapAligner.cpp:26-231 and
StutterAlignerClass.cpp:55-162) with the base-quality tables of
models/base_quality.py.  It imports nothing of the program: the packed
inputs come in as dicts of numpy arrays keyed by the program's field
names, and everything the kernels derive from them (quality tables,
prefix sums, emissions, row bounds, artifact shifts) is worked out here
again.  The harness runs it in float64 as the reference and in bfloat16 as
the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

IMPOSSIBLE = -1.0e9
NEG = -1.0e30
NEG_INF = -1.0e30
LOG_INS_TO_INS = -1.0
LOG_INS_TO_MATCH = float(np.log1p(-np.exp(-1.0)))
LOG_DEL_TO_DEL = -1.0
LOG_DEL_TO_MATCH = float(np.log1p(-np.exp(-1.0)))
MAX_UNITS = 6


def _quality_tables():
    """log P(correct) and log P(a given error) by raw quality byte, clamped
    to '!'..'J' (reference src/base_quality.h:44-75)."""
    top = ord("J") - ord("!")
    correct = [-100000.0] + [math.log(1.0 - 10.0 ** (i / -10.0))
                             for i in range(1, top + 1)]
    error = [-math.log(3.0)] + [math.log(10.0 ** (i / -10.0) / 3.0)
                                for i in range(1, top + 1)]
    idx = [min(max(b - ord("!"), 0), top) for b in range(256)]
    return (np.array([correct[i] for i in idx]),
            np.array([error[i] for i in idx]))


LOG_CORRECT, LOG_ERROR = _quality_tables()


class Seed(NamedTuple):
    seed_fw_row: torch.Tensor
    seed_rev_row: torch.Tensor
    seed_char: torch.Tensor
    seed_valid: torch.Tensor
    first_char: torch.Tensor
    last_char: torch.Tensor
    log_num_seeds: torch.Tensor
    cfg_fw_row: torch.Tensor
    cfg_rev_row: torch.Tensor


def expand_quals(quals: torch.Tensor, dtype: torch.dtype):
    idx = quals.long()
    dev = quals.device
    blw = torch.as_tensor(LOG_ERROR, dtype=dtype, device=dev)[idx]
    blc = torch.as_tensor(LOG_CORRECT, dtype=dtype, device=dev)[idx]
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


def _shear(X: torch.Tensor) -> torch.Tensor:
    """Y[..., t, j] = X[..., t, j - t], 0 where j < t."""
    B, L = X.shape[-2], X.shape[-1]
    t = torch.arange(B, device=X.device)[:, None]
    j = torch.arange(L, device=X.device)[None, :]
    idx = torch.clamp(j - t, min=0).expand(X.shape)
    return torch.where(j >= t, torch.gather(X, -1, idx), 0.0)


def _roll_lanes(X: torch.Tensor, shift: int) -> torch.Tensor:
    """X[..., j - shift] along the lane axis, 0 where j < shift."""
    if shift == 0:
        return X
    out = torch.zeros_like(X)
    if shift < X.shape[-1]:
        out[..., shift:] = X[..., :-shift]
    return out


def _shift_rows_up(S: torch.Tensor, k: int) -> torch.Tensor:
    """S[..., t + k, :] for t in [0, B), 0 beyond."""
    out = torch.zeros_like(S)
    B = S.shape[-2]
    if k < B:
        out[..., :B - k, :] = S[..., k:, :]
    return out


def _hankel_prefix(M: torch.Tensor) -> torch.Tensor:
    """pref[..., p, j] = sum_{t < p, t <= j} M[..., t, j - t]."""
    csum = torch.cumsum(_shear(M), dim=-2)
    zero = torch.zeros(M.shape[:-2] + (1, M.shape[-1]), dtype=M.dtype,
                       device=M.device)
    return torch.cat([zero, csum], dim=-2)


def _pick_row(M: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """M[..., row, :] with one row index per leading position."""
    idx = row[..., None, None].expand(M.shape[:-2] + (1, M.shape[-1]))
    return torch.gather(M, -2, idx)[..., 0, :]


def _lse_rows(X: torch.Tensor) -> torch.Tensor:
    m = torch.amax(X, dim=-2)
    return m + torch.log(torch.sum(torch.exp(X - m[..., None, :]), dim=-2))


def stutter_emissions_rows(codes, blw, blc, brev, blen, period: int,
                           max_units: int = 6):
    """E [N, 2*max_units+1, L] for N rows: codes/blw/blc [N, L] (one read
    segment each), brev [N, Bmax] repeat-allele codes right to left,
    blen [N] block lengths; one static `period` for all rows."""
    N, L = codes.shape
    Bmax = brev.shape[-1]
    dtype, dev = blc.dtype, blc.device
    blen = blen.long()
    bl3 = blen[:, None, None]
    t_col = torch.arange(Bmax, device=dev)[:, None]           # [B, 1]
    p_col = torch.arange(Bmax + 1, device=dev)[:, None]       # [B+1, 1]
    j_row = torch.arange(L, device=dev)[None, :]              # [1, L]

    # S[n, t, j] = log P(read[j] | block char b_rev[t]); 0 outside the block
    eq = codes[:, None, :] == brev[:, :, None]
    S = torch.where(eq, blc[:, None, :], blw[:, None, :])
    S = torch.where(t_col < bl3, S, 0.0)                      # [N, B, L]

    pref0 = _hankel_prefix(S)                                 # [N, B+1, L]
    E0 = _pick_row(pref0, blen)                               # [N, L]

    # ---- deletions (D = -dp, dp = d*period, d = max_units..1) ----------
    dps = [d * period for d in range(max_units, 0, -1)]
    dps_t = torch.tensor(dps, device=dev)
    SD = torch.stack([torch.where(t_col + dp < bl3, _shift_rows_up(S, dp),
                                  0.0) for dp in dps], dim=1)  # [N, nd, B, L]
    prefD = _hankel_prefix(SD)                                # [N, nd, B+1, L]
    remd = blen[:, None] - dps_t                              # [N, nd]
    rem = torch.clamp(remd, 0, Bmax)
    totalD = _pick_row(prefD, rem)                            # [N, nd, L]
    LLp = pref0[:, None] + (totalD[:, :, None, :] - prefD)
    LLp = torch.where(p_col <= remd[:, :, None, None], LLp, NEG_INF)
    lse_del = _lse_rows(LLp)                                  # [N, nd, L]
    prior_del = -torch.log(torch.clamp(remd + 1, min=1).to(dtype))
    E_del = torch.where((remd >= 0)[..., None],
                        prior_del[..., None] + lse_del, NEG_INF)

    # ---- insertions (D = kp, kp = k*period, k = 1..max_units) ----------
    max_ins = max_units * period
    reps = -(-max_ins // period)
    Speri = torch.cat([S[:, :period, :]] * reps, dim=1)[:, :max_ins]
    colmod = (torch.arange(max_ins, device=dev) % period)[:, None]
    # inserted-base scores with periodic extension; plain log-correct when
    # the periodic index falls outside the block (load_read,
    # StutterAlignerClass.cpp:40-48)
    pair = torch.where(colmod >= bl3, blc[:, None, :], Speri)
    isc = _shear(pair)                                        # [N, mi, L]
    ins_cum = torch.cat([torch.zeros(N, 1, L, dtype=dtype, device=dev),
                         torch.cumsum(isc, dim=1)], dim=1)
    kps = [k * period for k in range(1, max_units + 1)]
    ins0 = torch.stack([ins_cum[:, min(kp, max_ins)] for kp in kps], dim=1)
    rest = torch.stack([_roll_lanes(E0, kp) for kp in kps], dim=1)
    LL0 = ins0 + rest                                         # [N, nk, L]

    # per-unit position-shift deltas (StutterAlignerClass.cpp:73-96 in
    # closed form), frozen near the block end
    gA0 = _shear(_shift_rows_up(S, period))
    gB0 = _shear(S)
    frozen = (t_col + period) >= bl3                          # [N, B, 1]
    G_list = [torch.where(frozen, 0.0, _roll_lanes(gA0, kp)
                          - _roll_lanes(gB0, kp)) for kp in kps]
    deltas = torch.cumsum(torch.stack(G_list, dim=1), dim=1)  # [N, nm, B, L]
    nk = len(kps)
    cum = torch.cat([torch.zeros(N, nk, 1, L, dtype=dtype, device=dev),
                     torch.cumsum(deltas, dim=-2)], dim=-2) + LL0[:, :, None]
    kps_t = torch.tensor(kps, device=dev)[None, :, None]      # [1, nk, 1]
    base_len = torch.minimum(blen[:, None, None] + kps_t, j_row + 1)
    Pstar = torch.minimum(torch.clamp(base_len - kps_t, min=0),
                          blen[:, None, None])                # [N, nk, L]
    cum_at = torch.gather(cum, 2, Pstar[:, :, None, :])       # [N, nk, 1, L]
    LLf = torch.where(p_col <= Pstar[:, :, None, :], cum, cum_at)
    LLf = torch.where(p_col <= blen[:, None, None, None], LLf, NEG_INF)
    lse_ins = _lse_rows(LLf)                                  # [N, nk, L]
    E_ins = -torch.log((blen + 1).to(dtype))[:, None, None] + lse_ins

    return torch.cat([E_del, E0[:, None], E_ins], dim=1)      # [N, nD, L]


def stutter_emissions_plain(codes, blw, blc, brev, blen, periods,
                            max_units: int = 6, max_elems: int = 1 << 25):
    """E [G, O, nD, P, L] for a batch of loci: codes [G, P, L], blw/blc
    [G, P, L], brev [G, O, Bmax], blen [G, O], periods [G] (runtime per
    locus).  Loops over loci (each has its own period) and chunks the
    (option, pool) rows of a locus so the [rows, artifacts, Bmax+1, L]
    intermediates stay near `max_elems` elements."""
    G, P, L = codes.shape
    O, Bmax = brev.shape[1], brev.shape[2]
    nD = 2 * max_units + 1
    out = torch.empty((G, O, nD, P, L), dtype=blc.dtype, device=blc.device)
    rows = torch.arange(O * P, device=codes.device)
    for g, (period, top) in enumerate(zip(periods.tolist(),
                                          blen.amax(dim=1).tolist())):
        # block positions past every option's length only add masked terms:
        # cut the block axis to the longest option (and one period, which
        # the insertion sweep indexes)
        B = min(Bmax, max(int(top), int(period), 1))
        chunk = max(1, max_elems // ((max_units + 1) * (B + 1) * L))
        Eg = torch.empty((O * P, nD, L), dtype=blc.dtype, device=blc.device)
        for r0 in range(0, O * P, chunk):
            r = rows[r0:r0 + chunk]
            o, p = r // P, r % P
            Eg[r0:r0 + chunk] = stutter_emissions_rows(
                codes[g, p], blw[g, p], blc[g, p], brev[g, o, :B], blen[g, o],
                int(period), max_units)
        out[g] = Eg.view(O, P, nD, L).permute(0, 2, 1, 3)
    return out


def row_bounds(row_active, R: int, sr: int, h_real, periods):
    """[G, 4] int32 (start1, end3, h_real, period): phase-1 bucket padding
    sits at rows 1..start1-1, phase-3 padding at rows end3..R-1."""
    idx = torch.arange(R, device=row_active.device)[None, :]
    act = row_active.bool()
    mask1 = act & (idx >= 1) & (idx < sr)
    start1 = torch.clamp(torch.where(mask1, idx, R).amin(dim=1), max=sr)
    mask3 = act & (idx >= sr + 2)
    end3 = torch.clamp(torch.where(mask3, idx + 1, 0).amax(dim=1),
                       min=sr + 2)
    return torch.stack([start1, end3, h_real.long(), periods.long()],
                       dim=1).int().contiguous()


def segment_forward_plain(codes, blw, blc, C, Csh, last_col, row_char,
                          m2m, m2i, m2d, E, hap_opt, shift, lpmf_h, bounds,
                          R: int, sr: int):
    """Plain PyTorch segment forward: Mcol [G, H, R, P].  Arguments as for
    the kernel (see `segment_forward`)."""
    G, P, L = codes.shape
    H = row_char.shape[1]
    dtype, dev = blc.dtype, blc.device
    start1, end3, h_real, periods = bounds.long().unbind(1)
    jj = torch.arange(L, dtype=dtype, device=dev)
    C4, Csh4 = C[:, None], Csh[:, None]
    lc = last_col.long()[:, None, :, None].expand(G, H, P, 1)
    Mcol = torch.full((G, H, R, P), NEG, dtype=dtype, device=dev)

    def col(M):
        return torch.gather(M, -1, lc)[..., 0]

    def rc(x, r):
        return x[:, :, r, None, None]

    M = emit(codes, row_char[:, :, 0], blc, blw) + Csh4
    D = torch.full((G, H, P, L), IMPOSSIBLE, dtype=dtype, device=dev)
    Mcol[:, :, 0] = col(M)

    def rows(M, D, lo, hi, on_fn):
        for r in range(lo, hi):
            on = on_fn(r)                                       # [G] bool
            if not bool(on.any()):
                continue
            em = emit(codes, row_char[:, :, r], blc, blw)
            Mn, _, Dn = flank_row(M, D, em, C4, Csh4, jj, rc(m2m, r),
                                  rc(m2i, r), rc(m2d, r))
            sel = on[:, None, None, None]
            M = torch.where(sel, Mn, M)
            D = torch.where(sel, Dn, D)
            Mcol[:, :, r] = torch.where(on[:, None, None], col(M), NEG)
        return M, D

    # phase 1: flank rows start1 .. sr-1
    M, D = rows(M, D, 1, sr, lambda r: r >= start1)
    # phase 2: the stutter row, then the forced-match row
    E_h = E[torch.arange(G, device=dev)[:, None], hap_opt.long()]
    M = stutter_row(M, E_h, lpmf_h, shift, periods)
    D = torch.full_like(M, IMPOSSIBLE)
    Mcol[:, :, sr] = col(M)
    if sr + 1 < R:
        M = forced_match_row(M, emit(codes, row_char[:, :, sr + 1], blc, blw))
        Mcol[:, :, sr + 1] = col(M)
    # phase 3: remaining flank rows up to end3
    rows(M, D, sr + 2, R, lambda r: r < end3)
    pad_h = torch.arange(H, device=dev)[None, :] >= h_real[:, None]
    Mcol[pad_h] = NEG
    return Mcol


def seed_combine(Mcol_fw, Mcol_rev, l_prob, r_prob, seed: SeedMeta,
                 seed_codes, seed_blw, seed_blc, dtype):
    """Seed-anchor marginalisation for a batch of loci (the tail of
    ops/hmm.hmm_forward; reference HapAligner.cpp:163-231).  Mcol_* are
    [G, R, P, H]; returns LL [G, P, H]."""
    G = Mcol_fw.shape[0]
    gi = torch.arange(G, device=Mcol_fw.device)
    seed_codes = seed_codes.long()
    seed_blc, seed_blw = seed_blc.to(dtype), seed_blw.to(dtype)
    prior = seed.log_num_seeds.to(dtype)

    eq = seed_codes[:, :, None, None] == seed.seed_char.long()[:, None]
    sc_seed = torch.where(eq, seed_blc[:, :, None, None],
                          seed_blw[:, :, None, None])              # [G,P,H,S]
    Ml = Mcol_fw[gi[:, None], seed.seed_fw_row.long()].permute(0, 2, 3, 1)
    Mr = Mcol_rev[gi[:, None], seed.seed_rev_row.long()].permute(0, 2, 3, 1)
    vals = prior[:, None, None, None] + sc_seed + Ml + Mr
    vals = torch.where(seed.seed_valid.bool()[:, None, None, :], vals, NEG)

    p3 = prior[:, None, None]
    eqA = seed_codes[:, :, None] == seed.first_char.long()[:, None, :]
    scA = torch.where(eqA, seed_blc[:, :, None], seed_blw[:, :, None])
    cfgA = p3 + scA + l_prob[:, :, None] + Mcol_rev[gi, seed.cfg_rev_row.long()]
    eqB = seed_codes[:, :, None] == seed.last_char.long()[:, None, :]
    scB = torch.where(eqB, seed_blc[:, :, None], seed_blw[:, :, None])
    cfgB = p3 + scB + r_prob[:, :, None] + Mcol_fw[gi, seed.cfg_fw_row.long()]

    allv = torch.cat([vals, cfgA[..., None], cfgB[..., None]], dim=-1)
    m = torch.amax(allv, dim=-1)
    return m + torch.log(torch.sum(torch.exp(allv - m[..., None]), dim=-1))


def _t(x, device, dtype=None):
    a = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a.copy())
    if a.dtype.kind == "f" and dtype is not None:
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)


def orientation(seg: dict, meta: dict, R: int, sr: int, h_real, periods,
                dtype, device):
    """One orientation of a batch of loci: (Mcol [G, R, P, H], the reads'
    summed log P(correct) [G, P])."""
    codes = _t(seg["codes"], device).long()
    quals = _t(seg["quals"], device)
    last_col = _t(seg["last_col"], device).long()
    G, P, L = codes.shape
    blw, blc = expand_quals(quals, dtype)
    C = torch.cumsum(blc, dim=-1)
    Csh = torch.cat([torch.zeros((G, P, 1), dtype=dtype, device=device),
                     C[..., :-1]], dim=-1)
    m = {k: _t(v, device, dtype) for k, v in meta.items()}
    E = stutter_emissions_plain(codes, blw, blc, m["rep_rev_codes"].long(),
                                m["rep_len"].long(), periods, MAX_UNITS)
    H = m["row_char"].shape[1]
    nD = m["lpmf"].shape[-1]
    hap_opt = m["hap_opt"].long()
    d_min = -((nD - 1) // 2) * periods.long()
    lpmf_h = torch.gather(m["lpmf"], 1, hap_opt[:, :, None].expand(G, H, nD))
    shift = torch.gather(m["rep_len"].long(), 1, hap_opt) + d_min[:, None]
    bounds = row_bounds(m["row_active"], R, sr, h_real, periods)
    Mcol = segment_forward_plain(
        codes, blw, blc, C, Csh, last_col, m["row_char"].long(),
        m["row_m2m"], m["row_m2i"], m["row_m2d"], E, hap_opt, shift, lpmf_h,
        bounds, R=R, sr=sr)
    seg_logsum = torch.gather(C, -1, last_col[..., None])[..., 0]
    return Mcol.permute(0, 2, 3, 1), seg_logsum


def forward(arrays: dict, statics: tuple, h_real, periods, dtype,
            device) -> torch.Tensor:
    """LL [G, P, H] of a dispatch's loci from their packed inputs
    (`arrays`: l_seg, r_seg, fw_meta, rev_meta, seed as dicts of numpy
    arrays, seed_codes, seed_quals); statics (R_f, R_r, sr_f, sr_r, ...);
    h_real and periods [G]."""
    R_f, R_r, sr_f, sr_r = statics[:4]
    h_real = torch.as_tensor(np.asarray(h_real), device=device)
    periods = torch.as_tensor(np.asarray(periods), device=device)
    Mfw, l_prob = orientation(arrays["l_seg"], arrays["fw_meta"], R_f, sr_f,
                              h_real, periods, dtype, device)
    Mrev, r_prob = orientation(arrays["r_seg"], arrays["rev_meta"], R_r,
                               sr_r, h_real, periods, dtype, device)
    seed = Seed(**{k: _t(v, device, dtype)
                   for k, v in arrays["seed"].items()})
    blw, blc = expand_quals(_t(arrays["seed_quals"], device), dtype)
    return seed_combine(Mfw, Mrev, l_prob, r_prob, seed,
                        _t(arrays["seed_codes"], device), blw, blc, dtype)
