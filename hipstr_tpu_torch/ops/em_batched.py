"""Batched PCR-stutter EM: many loci per device call.

Counterpart of hipstr_tpu/ops/em_batched.py.  The per-locus host EM
(ops/em.py) re-implements EMStutterGenotyper (reference:
src/em_stutter_genotyper.cpp:170-226) in numpy; on the card the executor
trains the stutter models of a whole wave of loci at once instead.  Every
iteration runs the E-step (stutter-PMF alignment probs -> genotype
posteriors) and the M-step (allele frequencies and the six stutter
parameters from expected artifact counts, with the reference's
pseudocounts, em_stutter_genotyper.cpp:63-127) for all loci in dense
[G, R, A] tensors, and a per-locus `active` mask freezes loci that have
converged (the LL-dip, LL-delta and parameter-delta rules of the reference
train loop).

The JAX package's `lax.while_loop` is a host loop over the same state here.
It reads `active.any()` on the host only every SYNC_EVERY iterations: a
frozen locus changes nothing (every update is masked by `active`), so the
extra iterations are exact, and `max_iter` still bounds the loop.  The
per-sample and per-allele sums are one-hot contractions, not scatter-adds,
so the result does not depend on the order atomics land in.

Padding contract: padded reads carry weight 0 and sample_index pointing at
a real slot (they add zeros); padded alleles carry NEG priors and NEG
alignment probs (they underflow out of every logsumexp); padded samples
have no reads and are masked out of the total-LL / prior reductions.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .em_problem import EMProblem  # noqa: F401  (re-exported)

NEG = -1.0e30
TOLERANCE = 1e-10
PSEUDO_GEOM = math.log(1.1)   # the reference's geometric-denominator seed
LOG_ONE_HALF = math.log(0.5)
MAX_PARAM_DIFF = 1e-4
LL0 = -1.0e37                 # the starting LL; finite in float32
# host reads of `active.any()`: one every SYNC_EVERY iterations
SYNC_EVERY = 4


# --------------------------------------------------------------------------
# host-side problem packing (copies of the JAX package's numpy code)
# --------------------------------------------------------------------------

def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024,
                             2048, 4096, 10240)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pack_problems(problems: List[EMProblem]):
    """Stack problems into padded arrays; returns (arrays dict, (Rm, Am, Sm)).

    The JAX package's `pad_g` (pad the locus axis to one TPU compile shape)
    is not carried over: the locus axis is the real number of problems."""
    G = len(problems)
    Rm = _bucket(max(p.allele_index.size for p in problems))
    Am = _bucket(max(p.bps.size for p in problems), (2, 4, 8, 16, 32, 64,
                                                     128, 256))
    Sm = _bucket(max(p.num_samples for p in problems), (1, 2, 4, 8, 16, 32,
                                                        64, 128, 256, 512))
    d = dict(
        bps=np.zeros((G, Am), np.int32),
        allele_mask=np.zeros((G, Am), bool),
        allele_index=np.zeros((G, Rm), np.int32),
        sample_index=np.zeros((G, Rm), np.int32),
        read_mask=np.zeros((G, Rm), bool),
        log_p1=np.zeros((G, Rm), np.float64),
        log_p2=np.zeros((G, Rm), np.float64),
        sample_mask=np.zeros((G, Sm), bool),
        inv_rps=np.zeros((G, Sm), np.float64),   # 1 / reads-per-sample
        period=np.zeros((G,), np.int32),
        haploid=np.zeros((G,), bool),
    )
    for g, p in enumerate(problems):
        A, R, S = p.bps.size, p.allele_index.size, p.num_samples
        d["bps"][g, :A] = p.bps
        d["allele_mask"][g, :A] = True
        d["allele_index"][g, :R] = p.allele_index
        d["sample_index"][g, :R] = p.sample_index
        d["read_mask"][g, :R] = True
        d["log_p1"][g, :R] = p.log_p1
        d["log_p2"][g, :R] = p.log_p2
        d["sample_mask"][g, :S] = True
        with np.errstate(divide="ignore"):
            d["inv_rps"][g, :S] = np.where(p.reads_per_sample > 0,
                                           1.0 / np.maximum(
                                               p.reads_per_sample, 1), 0.0)
        d["period"][g] = p.period
        d["haploid"][g] = p.haploid
    return d, (Rm, Am, Sm)


# --------------------------------------------------------------------------
# the train loop on torch tensors
# --------------------------------------------------------------------------

def _masked_lse(x, mask, dim: int):
    """logsumexp of x over `dim` where `mask` (None: everywhere); NEG where
    the mask is empty."""
    if mask is not None:
        x = torch.where(mask, x, NEG)
    m = torch.amax(x, dim=dim, keepdim=True)
    m = torch.where(m > NEG / 2, m, 0.0)
    out = m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))
    if mask is None:
        return out
    return torch.where(mask.any(dim=dim), out, NEG)


def _log_pmf(diff, params: dict, period):
    """Vectorized stutter log-PMF (reference: src/stutter_model.cpp:29-53).

    diff [...]: read_bp - allele_bp as floats; params: dict of [G, 1, 1]
    logs; period broadcastable to diff.  The modulo and the repeat count
    floor, the out-of-frame step truncates (as in the JAX package)."""
    in_frame = torch.remainder(diff, period) == 0
    eff = diff - torch.trunc(diff / period)
    out_pmf = torch.where(
        eff < 0,
        params["l_out_down"] + params["l_out_geom"]
        + params["l1m_out_geom"] * (-eff - 1),
        params["l_out_up"] + params["l_out_geom"]
        + params["l1m_out_geom"] * (eff - 1))
    rep = torch.div(diff, period, rounding_mode="floor")
    in_pmf = torch.where(
        rep == 0,
        params["l_equal"],
        torch.where(rep < 0,
                    params["l_in_down"] + params["l_in_geom"]
                    + params["l1m_in_geom"] * (-rep - 1),
                    params["l_in_up"] + params["l_in_geom"]
                    + params["l1m_in_geom"] * (rep - 1)))
    return torch.where(in_frame, in_pmf, out_pmf)


def _param_logs(params):
    """params [G, 6] = (in_geom, in_up, in_down, out_geom, out_up, out_down)
    -> broadcastable log terms [G, 1, 1]."""
    pg, pu, pd, og, ou, od = (params[:, k][:, None, None] for k in range(6))
    return dict(
        l_in_geom=torch.log(pg), l1m_in_geom=torch.log1p(-pg),
        l_in_up=torch.log(pu), l_in_down=torch.log(pd),
        l_out_geom=torch.log(og), l1m_out_geom=torch.log1p(-og),
        l_out_up=torch.log(ou), l_out_down=torch.log(od),
        l_equal=torch.log1p(-(pu + pd + ou + od)))


def _segment_sum(values, index, n: int):
    """sum of values [G, R, ...] into n segments by index [G, R]: a one-hot
    [G, n, R] contraction (deterministic on CUDA)."""
    G, R = index.shape
    onehot = torch.nn.functional.one_hot(index.long(), n).to(values.dtype)
    flat = values.reshape(G, R, -1)
    return torch.bmm(onehot.transpose(1, 2), flat).reshape(
        (G, n) + values.shape[2:])


def em_train_batch(arrays: dict, Sm: int, device: torch.device,
                   dtype: torch.dtype, max_iter: int = 100,
                   min_LL_abs_change: float = 0.01,
                   min_LL_frac_change: float = 0.001) -> dict:
    """Batched EM train loop on `device` in `dtype`; returns a dict of
    tensors on the device: params [G, 6], converged [G], iters [G],
    total_LL [G], log_gt_priors [G, Am].

    Math identical to ops/em.EMStutterGenotyper.train (reference:
    src/em_stutter_genotyper.cpp:170-226) per locus, with per-locus
    convergence freezing.  `arrays` is pack_problems' dict."""
    def put(name, to=None):
        t = torch.from_numpy(arrays[name]).to(device)
        return t if to is None else t.to(to)

    bps = put("bps", torch.int64)
    allele_mask = put("allele_mask")
    allele_index = put("allele_index", torch.int64)
    sample_index = put("sample_index", torch.int64)
    read_mask = put("read_mask")
    log_p1 = put("log_p1", dtype)
    log_p2 = put("log_p2", dtype)
    sample_mask = put("sample_mask")
    inv_rps = put("inv_rps", dtype)
    period = put("period", torch.int64)
    haploid = put("haploid")

    G, Am = bps.shape
    Rm = allele_index.shape[1]
    read_bp = torch.gather(bps, 1, allele_index)                  # [G, R]
    diff_ra = (read_bp[:, :, None] - bps[:, None, :]).to(dtype)   # [G,R,A]
    per = period[:, None, None].to(dtype)
    pair_mask = read_mask[:, :, None] & allele_mask[:, None, :]  # [G, R, A]

    # ---- init priors: pseudocount 1 + sum_r 1/reads_per_sample ----------
    w_read = torch.gather(inv_rps, 1, sample_index)               # [G, R]
    w_read = torch.where(read_mask, w_read, 0.0)
    counts = 1.0 + _segment_sum(w_read[:, :, None], allele_index, Am)[..., 0]
    counts = torch.where(allele_mask, counts, 0.0)
    n_all = torch.sum(counts, dim=1, keepdim=True)
    log_gt_priors0 = torch.where(allele_mask,
                                 torch.log(counts) - torch.log(n_all), NEG)
    params0 = torch.tensor([[0.9, 0.1, 0.1, 0.8, 0.01, 0.01]], dtype=dtype,
                           device=device).repeat(G, 1)

    # ---- loop invariants of the E- and M-steps --------------------------
    diag = torch.eye(Am, dtype=torch.bool, device=device)[None]
    gmask = allele_mask[:, :, None] & allele_mask[:, None, :]
    post_smask = sample_mask[:, :, None, None]
    sample_rows = sample_index[:, :, None, None].expand(G, Rm, Am, Am)
    m0 = pair_mask[:, :, :, None] & allele_mask[:, None, None, :]
    m1 = m0.transpose(2, 3)
    in_frame = torch.remainder(diff_ra, per) == 0
    eff_out = diff_ra - torch.trunc(diff_ra / per)
    eff_in = torch.floor(diff_ra / per)
    log_abs_out = torch.log(torch.clamp(torch.abs(eff_out), min=1.0))
    log_abs_in = torch.log(torch.clamp(torch.abs(eff_in), min=1.0))
    cats = dict(
        in_eq=(in_frame & (diff_ra == 0) & pair_mask, None),
        in_up=(in_frame & (diff_ra > 0) & pair_mask, None),
        in_down=(in_frame & (diff_ra < 0) & pair_mask, None),
        in_diffs=(in_frame & (diff_ra != 0) & pair_mask, log_abs_in),
        out_up=(~in_frame & (diff_ra > 0) & pair_mask, None),
        out_down=(~in_frame & (diff_ra < 0) & pair_mask, None),
        out_diffs=(~in_frame & pair_mask, log_abs_out))
    # each category's pseudocount entries, summed with its read weights
    one = torch.zeros((G, 1), dtype=dtype, device=device)
    geom = torch.tensor([[0.0, PSEUDO_GEOM]], dtype=dtype,
                        device=device).expand(G, 2)

    def e_step(params, log_gt_priors):
        aln = _log_pmf(diff_ra, _param_logs(params), per)         # [G, R, A]
        aln = torch.where(pair_mask, aln, NEG)
        # genotype priors from allele freqs (em_stutter_genotyper.cpp:129-144)
        pri = log_gt_priors[:, :, None] + log_gt_priors[:, None, :]
        pri = torch.where(haploid[:, None, None],
                          torch.where(diag, log_gt_priors[:, :, None], NEG),
                          pri)
        # per-read genotype contributions
        t1 = LOG_ONE_HALF + log_p1[:, :, None] + aln               # [G, R, A]
        t2 = LOG_ONE_HALF + log_p2[:, :, None] + aln
        a = t1[:, :, :, None]
        b = t2[:, :, None, :]
        mx = torch.maximum(a, b)
        lse = mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))
        contrib = torch.where(read_mask[:, :, None, None], lse, 0.0)
        sums = _segment_sum(contrib, sample_index, Sm)             # [G,S,A,A]
        unnorm = pri[:, None] + sums
        unnorm = torch.where(gmask[:, None], unnorm, NEG)
        flat = unnorm.reshape(G, Sm, Am * Am)
        m = torch.amax(flat, dim=2)
        totals = m + torch.log(torch.sum(torch.exp(flat - m[:, :, None]),
                                         dim=2))
        log_post = unnorm - totals[:, :, None, None]
        totals = torch.where(sample_mask, totals, 0.0)
        return t1, t2, log_post, torch.sum(totals, dim=1)

    def m_step(t1, t2, log_post):
        # new allele freqs
        post_m = torch.where(post_smask, log_post, NEG)
        first = _masked_lse(_masked_lse(post_m, None, 3), None, 1)
        second = _masked_lse(_masked_lse(post_m, None, 2), None, 1)
        cnt = torch.logaddexp(first, second)                       # [G, A]
        cnt = torch.where(allele_mask, cnt, NEG)
        tot = _masked_lse(cnt, allele_mask, 1)
        new_priors = torch.where(allele_mask, cnt - tot[:, None], NEG)

        # per-read phase posteriors folded into genotype weights:
        # W0[r, a] = lse_b post[s_r, a, b] + ph1[r, a, b]
        a = t1[:, :, :, None]
        b = t2[:, :, None, :]
        tot_ph = torch.logaddexp(a, b)
        post_r = torch.gather(log_post, 1, sample_rows)           # [G,R,A,A]
        W0 = _masked_lse(post_r + (a - tot_ph), m0, 3)            # [G, R, A]
        W1 = _masked_lse(post_r + (b - tot_ph), m1, 2)            # [G, R, A]

        def cat(name, seeds):
            """logsumexp of the pseudocount entries `seeds` [G, k] and of
            W0, W1 (+extra) over the category mask, in one sum: the host
            EM's order (ops/em.py), so a model of pseudocounts alone is
            bit-equal to the host's."""
            mask, extra = cats[name]
            v0 = W0 if extra is None else W0 + extra
            v1 = W1 if extra is None else W1 + extra
            both = torch.stack([torch.where(mask, v0, NEG),
                                torch.where(mask, v1, NEG)], 1)   # [G,2,R,A]
            return _masked_lse(torch.cat([seeds, both.reshape(G, -1)], 1),
                               None, 1)

        in_eq = cat("in_eq", one)
        in_up = cat("in_up", one)
        in_down = cat("in_down", one)
        in_diffs = cat("in_diffs", geom)
        out_up = cat("out_up", one)
        out_down = cat("out_down", one)
        out_diffs = cat("out_diffs", geom)

        in_tot = torch.logaddexp(in_up, in_down)
        out_tot = torch.logaddexp(out_up, out_down)
        in_pgeom = torch.clamp(torch.exp(in_tot - in_diffs), max=0.999)
        out_pgeom = torch.clamp(torch.exp(out_tot - out_diffs), max=0.999)
        log_total = torch.logaddexp(
            _masked_lse(torch.stack([in_up, in_down, in_eq], 1), None, 1),
            out_tot)
        new_params = torch.stack(
            [in_pgeom,
             torch.exp(in_up - log_total), torch.exp(in_down - log_total),
             out_pgeom,
             torch.exp(out_up - log_total), torch.exp(out_down - log_total)],
            dim=1)
        return new_priors, new_params

    active = torch.ones(G, dtype=torch.bool, device=device)
    LL = torch.full((G,), LL0, dtype=dtype, device=device)
    params, priors = params0, log_gt_priors0
    converged = torch.zeros(G, dtype=torch.bool, device=device)
    iters = torch.zeros(G, dtype=torch.int32, device=device)
    it = 1
    while it <= max_iter:
        t1, t2, log_post, new_LL = e_step(params, priors)

        # rule 1 (em_stutter_genotyper.cpp:195-199): LL dipped -> converged,
        # keep the PREVIOUS params
        dip = new_LL < LL + TOLERANCE
        conv1 = active & dip

        new_priors, new_params = m_step(t1, t2, log_post)

        abs_change = new_LL - LL
        frac_change = -(new_LL - LL) / LL
        small = (abs_change < min_LL_abs_change) & \
                (frac_change < min_LL_frac_change)
        p_same = torch.all(torch.abs(new_params - params) < MAX_PARAM_DIFF,
                           dim=1)
        conv2 = active & ~dip & (small | p_same)

        upd = active & ~dip
        params = torch.where(upd[:, None], new_params, params)
        priors = torch.where(upd[:, None], new_priors, priors)
        LL = torch.where(upd, new_LL, LL)
        # a dipped locus reports the DIPPED LL (host parity: _result(new_LL))
        LL = torch.where(conv1, new_LL, LL)
        iters = iters.masked_fill(active, it)
        converged = converged | conv1 | conv2
        active = active & ~(conv1 | conv2)
        if it % SYNC_EVERY == 0 and not bool(active.any()):
            break
        it += 1
    return dict(params=params, converged=converged, iters=iters,
                total_LL=LL, log_gt_priors=priors)
