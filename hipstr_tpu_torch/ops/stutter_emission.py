"""Dense stutter-block emission tensors, plain PyTorch.

Counterpart of hipstr_tpu/ops/stutter_emission.py: a transcription of the
gather-free `stutter_emissions_tpu` (reference:
src/SeqAlignment/StutterAlignerClass.cpp:55-162), batched over rows of
(repeat option, read pool).  It is the plain version of the emission
kernel (ops/emission.py, csrc/emission.cu): the CPU path uses it, and the
card compares the kernel against it.

For every read lane j and artifact size D = k * period, k in [-6, 6]
(deletions first), E[.., k, j] is the log-likelihood of the read suffix
ending at j against the repeat block carrying that artifact, marginalised
over the artifact's position.  Intermediates are [rows, artifacts, Bmax+1,
L]; `stutter_emissions_plain` chunks the rows so they stay near
`max_elems` elements.

`stutter_emissions` (per read, numpy) is a copy of the gather form of
hipstr_tpu/ops/stutter_emission.py, which the host HMM oracle
(align/hmm_reference.py) calls; its helpers carry an `_np` suffix here.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1.0e30


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


# ---- numpy, per read: the host HMM oracle's emissions ----------------

def _score_matrix_np(xp, read_codes, blw, blc, block_rev_codes, block_len, Bmax):
    """S[t, k] = log P(read[t] | block char b_rev[k]); 0 outside the block."""
    eq = read_codes[:, None] == block_rev_codes[None, :Bmax]
    S = xp.where(eq, blc[:, None], blw[:, None])
    kmask = xp.arange(Bmax)[None, :] < block_len
    return xp.where(kmask, S, 0.0)


def _hankel_prefix_np(xp, S, Bmax):
    """pref[..., j, p] = sum_{t<p, t<=j} S[..., j-t, t] for p in [0, Bmax].

    Anti-diagonal prefix sums over the last two axes: gather S into
    X[..., j, t] = S[..., j-t, t] (zero when j < t), then cumulative-sum.
    """
    L = S.shape[-2]
    j_idx = xp.arange(L)[:, None]
    t_idx = xp.arange(Bmax)[None, :]
    rows = j_idx - t_idx                       # [L, Bmax]
    valid = rows >= 0
    rows_b = xp.broadcast_to(rows, S.shape[:-2] + rows.shape)
    X = xp.take_along_axis(S, xp.clip(rows_b, 0, L - 1), axis=-2)
    X = xp.where(valid, X, 0.0)
    csum = xp.cumsum(X, axis=-1)
    zero = xp.zeros(S.shape[:-1] + (1,), dtype=S.dtype)
    return xp.concatenate([zero, csum], axis=-1)  # [..., L, Bmax+1]


def _logsumexp_np(xp, x, axis):
    m = xp.max(x, axis=axis, keepdims=True)
    m = xp.where(xp.isfinite(m), m, 0.0)
    return xp.squeeze(m, axis=axis) + xp.log(xp.sum(xp.exp(x - m), axis=axis))


def stutter_emissions(xp, read_codes, blw, blc, block_rev_codes, block_len,
                      period, max_units=6):
    """Emission tensor E[L, nD] over artifact sizes D = k*period,
    k in [-max_units, max_units] (deletions first, ascending).

    Entries with block_len + D < 0 are NEG_INF (impossible artifact).
    `block_len` may be a traced scalar; `period`, `max_units`, and the padded
    length of `block_rev_codes` (Bmax) are static.
    """
    L = read_codes.shape[0]
    Bmax = block_rev_codes.shape[0]
    dtype = blc.dtype

    blen = xp.asarray(block_len, dtype=np.int32)
    S = _score_matrix_np(xp, read_codes, blw, blc, block_rev_codes, blen, Bmax)
    pref0 = _hankel_prefix_np(xp, S, Bmax)        # [L, Bmax+1]
    p_axis = xp.arange(Bmax + 1)
    j_axis = xp.arange(L)

    def fdt(v):
        return xp.asarray(v).astype(dtype)

    # ---- no-artifact: E0[j] = pref0[j, block_len] ---------------------------
    E0 = xp.take_along_axis(
        pref0, xp.broadcast_to(blen, (L, 1)).astype(np.int32), axis=1)[:, 0]

    # ---- deletions (D = -dp, dp = d*period, d = max_units..1) ---------------
    nd = max_units
    dps = xp.asarray(np.arange(max_units, 0, -1) * period)        # [nd]
    colidx = xp.arange(Bmax)[None, :] + dps[:, None]              # [nd, Bmax]
    col_ok = (colidx < blen) & (colidx < Bmax)
    SD = xp.take_along_axis(
        xp.broadcast_to(S[None], (nd, L, Bmax)),
        xp.broadcast_to(xp.clip(colidx, 0, Bmax - 1)[:, None, :],
                        (nd, L, Bmax)), axis=-1)
    SD = xp.where(col_ok[:, None, :], SD, 0.0)                    # [nd, L, Bmax]
    prefD = _hankel_prefix_np(xp, SD, Bmax)                          # [nd, L, Bmax+1]
    rem = xp.clip(blen - dps, 0, Bmax)                            # [nd]
    totalD = xp.take_along_axis(
        prefD, xp.broadcast_to(rem[:, None, None], (nd, L, 1)
                               ).astype(np.int32), axis=-1)[..., 0]  # [nd, L]
    LLp = pref0[None] + (totalD[..., None] - prefD)               # [nd, L, Bmax+1]
    pmask = p_axis[None, None, :] <= (blen - dps)[:, None, None]
    LLp = xp.where(pmask, LLp, NEG_INF)
    lse_del = _logsumexp_np(xp, LLp, axis=-1)                        # [nd, L]
    prior_del = -xp.log(fdt(xp.maximum(blen - dps + 1, 1)))       # [nd]
    E_del = xp.where((blen - dps >= 0)[:, None],
                     prior_del[:, None] + lse_del, NEG_INF)       # [nd, L]

    # ---- insertions (D = kp, kp = k*period, k = 1..max_units) ---------------
    max_ins = max_units * period
    t_idx = xp.arange(max_ins)[None, :]
    rows = j_axis[:, None] - t_idx                                # [L, max_ins]
    rvalid = rows >= 0
    rclip = xp.clip(rows, 0, L - 1)
    colmod = xp.asarray(np.arange(max_ins) % period, dtype=np.int32)
    # inserted-base scores: periodic extension b_rev[t % period]; plain
    # log-correct when the periodic index falls outside the block
    # (load_read, StutterAlignerClass.cpp:40-48)
    Speri = xp.take_along_axis(
        S, xp.broadcast_to(colmod[None, :], (L, max_ins)), axis=1)
    isc = xp.take_along_axis(Speri, rclip, axis=0)
    blc_sh = xp.take_along_axis(
        xp.broadcast_to(blc[:, None], (L, max_ins)), rclip, axis=0)
    isc = xp.where(colmod[None, :] >= blen, blc_sh, isc)
    isc = xp.where(rvalid, isc, 0.0)
    ins_cum = xp.concatenate(
        [xp.zeros((L, 1), dtype=dtype), xp.cumsum(isc, axis=1)], axis=1)

    kps = np.arange(1, max_units + 1) * period                    # static [nk]
    ins0 = ins_cum[:, np.minimum(kps, max_ins)]                   # [L, nk]
    # match remainder after the insertion: E0[j - kp] when j >= kp
    rest_rows = j_axis[None, :] - xp.asarray(kps)[:, None]        # [nk, L]
    rest = xp.take_along_axis(
        xp.broadcast_to(E0[None, :], (len(kps), L)),
        xp.clip(rest_rows, 0, L - 1), axis=1)
    rest = xp.where(rest_rows >= 0, rest, 0.0)                    # [nk, L]
    LL0 = ins0.T + rest                                           # [nk, L]

    # per-unit position-shift deltas (the incremental update of
    # StutterAlignerClass.cpp:73-96 in closed form), stacked over units m
    q_idx = xp.arange(1, Bmax + 1)[None, :]                       # [1, Q]
    SA = _shifted_cols_np(xp, S, period, Bmax)    # SA[t, q-1] = S[t, q-1+period]
    SB = S                                     # SB[t, q-1] = S[t, q-1]
    m_sh = xp.asarray(np.arange(1, max_units + 1) * period)       # [nm]
    rows_m = (j_axis[None, :, None] - (q_idx[None] - 1)
              - m_sh[:, None, None])                              # [nm, L, Q]
    rv = rows_m >= 0
    rc = xp.clip(rows_m, 0, L - 1)
    gA = xp.take_along_axis(xp.broadcast_to(SA[None], rc.shape), rc, axis=1)
    gB = xp.take_along_axis(xp.broadcast_to(SB[None], rc.shape), rc, axis=1)
    G = gA - gB
    frozen = (q_idx - 1 + period) >= blen                         # [1, Q]
    G = xp.where(frozen[None] | ~rv, 0.0, G)
    deltas = xp.cumsum(G, axis=0)                                 # [nm, L, Q]

    cum = xp.concatenate(
        [xp.zeros((len(kps), L, 1), dtype=dtype),
         xp.cumsum(deltas, axis=-1)], axis=-1) + LL0[..., None]   # [nk, L, Bmax+1]
    # configs beyond P*(j,k) repeat the value at P*
    base_len = xp.minimum(blen + xp.asarray(kps)[:, None], j_axis[None, :] + 1)
    Pstar = xp.clip(base_len - xp.asarray(kps)[:, None], 0, blen)  # [nk, L]
    pc = xp.minimum(xp.broadcast_to(p_axis[None, None, :],
                                    (len(kps), L, Bmax + 1)),
                    Pstar[..., None]).astype(np.int32)
    LLfinal = xp.take_along_axis(cum, pc, axis=-1)
    pmask_i = p_axis[None, None, :] <= blen
    LLfinal = xp.where(pmask_i, LLfinal, NEG_INF)
    lse_ins = _logsumexp_np(xp, LLfinal, axis=-1)                    # [nk, L]
    E_ins = -xp.log(fdt(blen + 1)) + lse_ins

    return xp.concatenate(
        [xp.swapaxes(E_del, 0, 1), E0[:, None], xp.swapaxes(E_ins, 0, 1)],
        axis=1)  # [L, 2*max_units+1]


def _shifted_cols_np(xp, S, period, Bmax):
    """SA[t, q] = S[t, q + period] for q in [0, Bmax), zero beyond."""
    L = S.shape[0]
    if period < Bmax:
        pad = xp.zeros((L, period), dtype=S.dtype)
        return xp.concatenate([S[:, period:], pad], axis=1)[:, :Bmax]
    return xp.zeros((L, Bmax), dtype=S.dtype)
