"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference (strbench/reference) recomputed in
float64, each number beside its limit (strbench/limits/<cell>.json).

- em_start: sampled EM problems whose reads' length changes do not fit
  the generator's truth for any locus of their period (`em_start_bad`):
  the EM's inputs as the program derived them from the BAM.  Exact:
  limit 0.
- em_gap: the widest gap of a learned stutter parameter between the
  program's EM (each wave's models on the card) and the reference EM on
  the same reads (1 where the convergence flags differ).
- ll_gap: the widest gap of a read x haplotype log-likelihood (K1, K2 and
  the seed combination) between the program's dispatch and the reference
  forward on the dispatch's packed inputs, relative to max(1, |reference|).
- post_gap: the widest gap between the program's fused posteriors (with
  the ordered per-sample sum) and the reference's, from the reference's
  own LLs: of a genotype's posterior probability, or of a sample's total
  log-likelihood relative to max(1, |reference|) (the probabilities of a
  confident call saturate; the totals carry the sums' precision).
- record_gb: of the loci sampled from the seed (strbench/capture) whose
  records settled in the window, the samples whose record does not hold
  the reference's call: its GB (the called alleles' lengths less the
  reference allele's, in either phase) not the reference's, its GT not
  the alleles its GB names, or the record on another locus's contig.
  Exact: limit 0.
- record_q_gap: over the same samples, the widest gap of the record's Q
  or PQ from the reference's (unrounded; the record prints two decimals).
  The reference takes the locus's last dispatch's packed inputs, works
  out its LLs and fused posteriors anew (over the alleles the record
  keeps, where the last round dropped some after the dispatch) and calls
  the genotype (strbench/reference/genotypes.py).

With `control`, the reference computed in bfloat16 stands in the
program's place (the nearest precision below the configuration's float32).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np
import torch

from .reference import em as ref_em
from .reference import genotypes as ref_gt
from .reference import hmm as ref_hmm
from .reference import posteriors as ref_post

CONTROL_DTYPE = torch.bfloat16


def _fits(got: dict, want: dict) -> bool:
    return all(n <= want.get(str(d), 0) for d, n in got.items())


def em_start_bad(problems, truth: dict) -> int:
    """Problems that fit no truth locus of their period: the union of their
    reads' length changes a sub-multiset of the locus's, with at least a
    quarter of its reads (duplicates are removed), and each of their
    samples' a sub-multiset of one of the locus's samples (the EM's sample
    order is its own)."""
    by_period: Dict[int, list] = {}
    for chrom, per in truth["loci"].items():
        union = {}
        for c in per.values():
            for d, n in c.items():
                union[d] = union.get(d, 0) + n
        by_period.setdefault(truth["period"][chrom], []).append((union, per))
    bad = 0
    for prob in problems:
        diffs = np.asarray(prob.bps)[np.asarray(prob.allele_index)]
        sidx = np.asarray(prob.sample_index)
        per_sample, union = {}, {}
        for s, d in zip(sidx.tolist(), diffs.tolist()):
            c = per_sample.setdefault(s, {})
            c[d] = c.get(d, 0) + 1
            union[d] = union.get(d, 0) + 1

        def fits(locus):
            want_union, want = locus
            if 4 * len(diffs) < sum(want_union.values()) or not _fits(
                    union, want_union):
                return False
            return all(any(_fits(c, w) for w in want.values())
                       for c in per_sample.values())
        if not any(fits(l) for l in by_period.get(int(prob.period), [])):
            bad += 1
    return bad


def em_ref(prob, dtype):
    return ref_em.train(bool(prob.haploid), int(prob.period), prob.bps,
                        prob.allele_index, prob.sample_index, prob.log_p1,
                        prob.log_p2, int(prob.num_samples),
                        prob.reads_per_sample, dtype=dtype)


def em_gap(kept, control: bool = False) -> Optional[float]:
    """kept: [(EMProblem, program params [6], converged)]."""
    if not kept:
        return None
    worst = 0.0
    for prob, params, conv in kept:
        ref, ref_conv, _ = em_ref(prob, torch.float64)
        if control:
            params, conv, _ = em_ref(prob, CONTROL_DTYPE)
        if bool(conv) != bool(ref_conv):
            return 1.0
        worst = max(worst, max(abs(float(a) - b) for a, b in
                               zip(params, ref)))
    return worst


def _inputs(arrays, i):
    """Locus i of a kept dispatch's stacked packed inputs, as the
    reference takes them."""
    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return np.asarray(x)[i:i + 1]
    names = ("l_seg", "r_seg", "fw_meta", "rev_meta", "seed", "seed_codes",
             "seed_quals")
    return {n: take(arrays[k]) for k, n in enumerate(names)}


def hmm_gaps(kept, device, control: bool = False):
    """(ll_gap, post_gap) over the kept dispatches' loci; post_gap is None
    when no kept dispatch fused its posteriors."""
    ll_worst, post_worst = None, None
    for d in kept:
        fused = len(d["out"]) == 3
        for i in range(len(d["order"])):
            inp = _inputs(d["arrays"], i)
            hr, pr = d["h_real"][i], d["P_real"][i]
            ref = ref_hmm.forward(inp, d["statics"], [hr], [d["periods"][i]],
                                  torch.float64, device)[0]
            if control:
                prog = ref_hmm.forward(inp, d["statics"], [hr],
                                       [d["periods"][i]], CONTROL_DTYPE,
                                       device)[0]
            else:
                prog = d["out"][0][i].to(device)
            a = prog[:pr, :hr].double()
            b = ref[:pr, :hr].double()
            gap = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            if not np.isfinite(gap):
                gap = float("inf")
            ll_worst = gap if ll_worst is None else max(ll_worst, gap)
            if not fused:
                continue
            pm = {k: np.asarray(v)[i] for k, v in d["arrays"][7].items()}
            lp_ref, tot_ref, present = ref_post.sample_posteriors(
                ref, pm, torch.float64)
            S, A = lp_ref.shape[:2]
            if control:
                lp, tot, _ = ref_post.sample_posteriors(prog, pm,
                                                        CONTROL_DTYPE)
            else:
                lp = d["out"][1][i].to(device)[:S, :A, :A]
                tot = d["out"][2][i].to(device)[:S]
            prob_gap = (torch.exp(lp.double()) - torch.exp(lp_ref))[present]
            tot_gap = ((tot.double() - tot_ref).abs()
                       / tot_ref.abs().clamp(min=1.0))[present]
            gap = max([float(prob_gap.abs().max()), float(tot_gap.max())]
                      if present.any() else [0.0])
            if not np.isfinite(gap):
                gap = float("inf")
            post_worst = gap if post_worst is None else max(post_worst, gap)
    return ll_worst, post_worst


def _one(arrays) -> dict:
    """One locus's packed inputs, as the reference takes a dispatch's."""
    def lead(x):
        if isinstance(x, dict):
            return {k: lead(v) for k, v in x.items()}
        return np.asarray(x)[None]
    names = ("l_seg", "r_seg", "fw_meta", "rev_meta", "seed", "seed_codes",
             "seed_quals")
    return {n: lead(arrays[k]) for k, n in enumerate(names)}


def _record_alleles(pm: dict, meta: dict, h_real: int, text: str):
    """(the posterior inputs over the record's last round, each of its
    haplotypes' repeat allele, each repeat allele's length less the
    reference's), or None where two of the dispatch's repeat alleles that
    the record could name share a length.  The last round is taken to
    hold every dispatched haplotype whose repeat allele the record keeps:
    after the last dispatch the genotyper drops alleles and adds the
    assembled flank alleles that the dispatch already aligned (the
    speculative superset), on the host, without another dispatch."""
    opt = np.asarray(meta["hap_opt"])[:h_real]
    rep_len = np.asarray(meta["rep_len"])
    if opt.max() >= len(rep_len):
        return None
    bp = rep_len - rep_len[0]
    fields = text.split("\t")
    alleles = [fields[3]] + (fields[4].split(",")
                             if fields[4] != "." else [])
    want = sorted(len(a) - len(alleles[0]) for a in alleles)
    keep = [o for o in np.unique(opt) if bp[o] in want]
    if sorted(bp[keep].tolist()) != want:
        return None
    cols = np.asarray([h for h in range(h_real) if opt[h] in keep])
    return dict(pm, col_index=cols, n_alleles=len(cols)), opt[cols], bp


def record_gaps(hooks, truth: dict, device, limit: int,
                control: bool = False):
    """(record_gb, record_q_gap, samples compared, loci compared) over
    `limit` of the sampled loci whose records settled in the window, taken
    in an order drawn from the seed, each whose last round the reference
    can follow (a fused dispatch whose haplotypes hold the record's
    alleles, each of its own length).  The Q and PQ gap is None where no
    sample was compared."""
    window = [(idx, rec) for t, idx, rec in hooks.settles
              if hooks.t_open < t <= hooks.t_close
              and idx in hooks.last_round and rec is not None]
    window.sort()
    random.Random(hooks.seed + 2).shuffle(window)
    bad, q_gap, n, loci = 0, None, 0, 0
    for idx, text in window:
        if loci >= limit:
            break
        if text.split("\t", 1)[0] != hooks.chrom_of.get(idx):
            bad += 1
            continue
        last = hooks.last_round[idx]
        if len(last["arrays"]) < 8:
            continue                 # an unfused round: host posteriors
        pm = {k: np.asarray(v) for k, v in last["arrays"][7].items()}
        got = _record_alleles(pm, last["arrays"][2], last["statics"][6],
                              text)
        if got is None:
            continue
        pm, hap_allele, bp = got
        loci += 1
        st = last["statics"]
        inp = _one(last["arrays"])
        calls = []
        for dtype in ((torch.float64, CONTROL_DTYPE) if control
                      else (torch.float64,)):
            LL = ref_hmm.forward(inp, st, [st[6]], [st[4]], dtype,
                                 device)[0]
            lp, _, present = ref_post.sample_posteriors(LL, pm, dtype)
            calls.append(ref_gt.called(lp.double().cpu().numpy(),
                                       hap_allele, bp))
            if len(calls) == 1:
                ref_ll = LL.double().cpu().numpy()
                present = present.cpu().numpy()
        ref = calls[0]
        if control:
            prog = [(c[0], round(c[1], 2), round(c[2], 2), c[0])
                    for c in calls[1]]
        else:
            # the record's columns by name; the reference's samples by the
            # genotyper's own order, named from the reads
            use = (pm["weights"] != 0) & pm["read_ok"]
            cols = np.asarray(pm["col_index"])
            best = np.argmax(ref_ll[pm["pool_row"][use]][:, cols], axis=1)
            order = ref_gt.sample_order(
                bp[hap_allele[best]], pm["sample"][use], truth["loci"][
                    hooks.chrom_of[idx]], list(hooks.pipeline.samples))
            fields = dict(zip(hooks.pipeline.samples,
                              ref_gt.record_fields(text)))
            prog = [fields[name] for name in order]
        for s, (gb, q, pq) in enumerate(ref):
            if not present[s] or s >= len(prog) or prog[s] is None:
                continue             # no call: a sample-level filter
            rec = prog[s]
            n += 1
            if sorted(rec[0]) != sorted(gb) or rec[0] != rec[3]:
                bad += 1
                continue
            gap = max(abs(rec[1] - q), abs(rec[2] - pq))
            q_gap = gap if q_gap is None else max(q_gap, gap)
    return bad, q_gap, n, loci


def numbers(hooks, truth: dict, device, control: bool = False,
            record_sample: int = 16) -> dict:
    """Every number compared, by name (None: nothing to compare)."""
    em_kept = [x for x in hooks.em.items if x is not None]
    ll, post = hmm_gaps(hooks.kept_dispatches(), device, control)
    gb, q_gap, n, loci = record_gaps(hooks, truth, device, record_sample,
                                     control)
    return dict(em_start=em_start_bad([p for p, _, _ in em_kept], truth),
                em_gap=em_gap(em_kept, control), ll_gap=ll, post_gap=post,
                record_gb=gb if n else None, record_q_gap=q_gap,
                record_samples=n, record_loci=loci)


def verdict(nums: dict, limits: dict, failed: int, attempted: int):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, none missing that the cell's limits name, no locus failed (no
    locus of the window settled without its record) and some locus
    attempted."""
    rows, ok = [], failed == 0 and attempted > 0
    for name, limit in limits.items():
        v = nums.get(name)
        rows.append((name, v, limit))
        if v is None or not v <= limit:
            ok = False
    rows.append(("failed_loci", failed, 0))
    return ok, rows
