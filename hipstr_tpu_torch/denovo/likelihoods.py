"""Dense de novo mutation likelihoods (log10 space), the port's
counterpart of hipstr_tpu/denovo/likelihoods.py.

Capability parity with the reference scanners' likelihood sums (reference:
src/denovos/denovo_scanner.cpp:155-273 for the phased family scan,
src/denovos/trio_denovo_scanner.cpp for the unphased trio scan,
src/denovos/mutation_model.h, src/denovos/denovo_allele_priors.{h,cpp}).

Each scenario is a dense tensor contraction over the [A^4 (x A mutation)]
genotype grid: exact (no pruning) and batchable.  The per-job functions
down to `trio_unphased_lls` are copies of the JAX package's, run with
`xp = numpy` on the host (the scanners' `device_batch=0` path).  The JAX
package runs the same functions under jit(vmap) for its device batches;
here `trio_unphased_lls_batched` and `phased_family_lls_batched` are the
same contractions written in torch over a leading job axis N, in float64
on an explicit device.  They are plain torch ops, not a hand-written
kernel: the JAX package's are XLA ops, not Pallas kernels.
"""

from __future__ import annotations

import math
import time
from typing import List, Sequence

import numpy as np
import torch

NEG = -1.0e30
# The largest intermediate one batched dispatch may build: a stack of
# mutation parts, 8 x [Ap^5] float64 per job for the trio scan and
# 2 x [Ap^5] per job and child for the family scan.  A group of jobs is
# split into dispatches under it (a dispatch holds about four such tensors
# at its peak); a job larger than the budget runs alone.  Jobs are
# independent, so the split does not change any result.
DISPATCH_BYTES = 1 << 30
# one entry per batched dispatch since the last clear():
# dict(scan="trio" | "family", jobs, Ap, C, bytes of its largest
# intermediate, s: host seconds from the upload to the results on the
# host, which waits for the device)
DISPATCHES: List[dict] = []


def _lse10(xp, x, axis=None):
    m = xp.max(x, axis=axis, keepdims=True)
    m = xp.where(xp.isfinite(m), m, 0.0)
    out = m + xp.log10(xp.sum(xp.power(10.0, x - m), axis=axis, keepdims=True))
    if axis is None:
        return xp.squeeze(out)
    return xp.squeeze(out, axis=axis)


def _lse_ref(xp, x, axis=None):
    """Reference-parity aggregation: the reference's streaming accumulator
    (src/mathops.cpp:72-84, update/finish_streaming_log_sum_exp) applies
    NATURAL exp/log to the log10-space scenario terms, so the 'log10'
    values it reports are really max + ln(sum(e^(x - max))).  Replicated
    here verbatim so golden comparisons against the DenovoFinder binary
    match; pass exact_lse=True to the kernels for true log10 semantics."""
    m = xp.max(x, axis=axis, keepdims=True)
    m = xp.where(xp.isfinite(m), m, 0.0)
    out = m + xp.log(xp.sum(xp.exp(x - m), axis=axis, keepdims=True))
    if axis is None:
        return xp.squeeze(out)
    return xp.squeeze(out, axis=axis)


def uniform_log10_freqs(num_alleles: int) -> np.ndarray:
    return np.full(num_alleles, -math.log10(num_alleles))


def population_log10_freqs(num_alleles: int, founder_genotypes) -> np.ndarray:
    """Pseudocount-1 founder allele frequencies (reference:
    denovo_allele_priors.cpp:7-34).  founder_genotypes: iterable of
    (gt_a, gt_b) for non-missing founders."""
    counts = np.ones(num_alleles)
    total = float(num_alleles)
    for a, b in founder_genotypes:
        counts[a] += 1
        counts[b] += 1
        total += 2
    return np.log10(counts / total)


def expand_phased_gls(gl: Sequence[float], num_alleles: int) -> np.ndarray:
    """PHASEDGL vector (index a*A+b) -> [A, A] matrix."""
    return np.asarray(gl, dtype=np.float64).reshape(num_alleles, num_alleles)


def expand_unphased_gls(gl: Sequence[float], num_alleles: int) -> np.ndarray:
    """GL vector (VCF diploid order) -> symmetric [A, A] matrix."""
    out = np.empty((num_alleles, num_alleles))
    for i in range(num_alleles):
        for j in range(i + 1):
            v = gl[i * (i + 1) // 2 + j]
            out[i, j] = v
            out[j, i] = v
    return out


def _child_axes(mat_idx: int, pat_idx: int):
    """(ci_axis, cj_axis) of the [mat_i, mat_j, pat_i, pat_j] grid that the
    child's two haplotypes come from, for the reference encoding 0..3 =
    1+1, 1+2, 2+1, 2+2 (child hap + parent hap)."""
    # maternal: idx 0 -> ci = mat_i (axis 0); 1 -> ci = mat_j (axis 1);
    #           2 -> cj = mat_i; 3 -> cj = mat_j
    if mat_idx in (0, 1):
        ci_axis = 0 if mat_idx == 0 else 1
        assert pat_idx in (2, 3)
        cj_axis = 2 if pat_idx == 2 else 3
    else:
        cj_axis = 0 if mat_idx == 2 else 1
        assert pat_idx in (0, 1)
        ci_axis = 2 if pat_idx == 0 else 3
    return ci_axis, cj_axis


def _axis_index(iota, axis: int, ndim: int = 4):
    """iota reshaped to lie along `axis` of an ndim grid."""
    return iota.reshape([iota.shape[0] if d == axis else 1
                         for d in range(ndim)])


def _child_tensor(xp, glc, mat_idx: int, pat_idx: int, A: int):
    """GL_child over the [mat_i, mat_j, pat_i, pat_j] grid given the child's
    inheritance pattern, plus the (ci_axis, cj_axis) it was built from."""
    ci_axis, cj_axis = _child_axes(mat_idx, pat_idx)
    iota = xp.arange(A)
    return (glc[_axis_index(iota, ci_axis), _axis_index(iota, cj_axis)],
            ci_axis, cj_axis)


def phased_family_lls(xp, gl_mother, gl_father, gl_children,
                      maternal_indices: List[int], paternal_indices: List[int],
                      log10_freqs, log10_mut_prior: float,
                      exact_lse: bool = False):
    """Returns (ll_no_mutation, ll_one_denovo[C], ll_one_other[C]).

    gl_* are [A, A] phased-GL matrices; children's transmission patterns come
    from SNP-haplotype inheritance (reference: denovo_scanner.cpp:155-273).
    By default the final reductions use the reference's hybrid natural-log
    aggregation (see _lse_ref); exact_lse=True gives true log10 LSE.
    """
    _lse = _lse10 if exact_lse else _lse_ref
    A = gl_mother.shape[0]
    f = xp.asarray(log10_freqs)
    M = f[:, None] + f[None, :] + gl_mother           # [A, A]
    P = f[:, None] + f[None, :] + gl_father
    base = M[:, :, None, None] + P[None, None, :, :]  # [A,A,A,A]

    child_t = []
    for c in range(len(maternal_indices)):
        t, ci_axis, cj_axis = _child_tensor(xp, gl_children[c],
                                            maternal_indices[c],
                                            paternal_indices[c], A)
        child_t.append((t, ci_axis, cj_axis))

    nomut = base
    for t, _, _ in child_t:
        nomut = nomut + t
    ll_no_mutation = _lse(xp, nomut)

    iota = xp.arange(A)
    grid = [xp.reshape(iota, [A if d == i else 1 for i in range(4)])
            for d in range(4)]
    # denovo mask over [A,A,A,A,m]: m differs from all four genotype alleles
    m_ax = xp.reshape(iota, (1, 1, 1, 1, A))
    denovo_mask = ((m_ax != grid[0][..., None]) & (m_ax != grid[1][..., None])
                   & (m_ax != grid[2][..., None]) & (m_ax != grid[3][..., None]))

    ll_denovo, ll_other = [], []
    for t, ci_axis, cj_axis in child_t:
        config = nomut - t  # base + other children
        glc = gl_children[len(ll_denovo)]
        ci_val = grid[ci_axis]
        cj_val = grid[cj_axis]

        # mutate haplotype 1 (ci -> m): GLC[m, cj]
        idx_cj = _axis_index(iota, cj_axis)
        t1 = (config[..., None] + glc[m_ax, idx_cj[..., None]]
              + log10_mut_prior)
        t1 = xp.where(m_ax == ci_val[..., None], NEG, t1)

        # mutate haplotype 2 (cj -> m): GLC[ci, m]
        idx_ci = _axis_index(iota, ci_axis)
        t2 = (config[..., None] + glc[idx_ci[..., None], m_ax]
              + log10_mut_prior)
        t2 = xp.where(m_ax == cj_val[..., None], NEG, t2)

        both = xp.stack([t1, t2])
        dmask = xp.stack([denovo_mask, denovo_mask])
        ll_denovo.append(_lse(xp, xp.where(dmask, both, NEG)))
        ll_other.append(_lse(xp, xp.where(dmask, NEG, both)))
    return ll_no_mutation, xp.stack(ll_denovo), xp.stack(ll_other)


def trio_unphased_lls(xp, gl_mother, gl_father, gl_child, log10_freqs,
                      log10_mut_prior: float, exact_lse: bool = False):
    """Returns (ll_no_mutation, ll_one_denovo, ll_one_other) for one trio
    with unphased [A, A] symmetric GL matrices (reference:
    trio_denovo_scanner.cpp:81-180).  Final reductions default to the
    reference's hybrid natural-log aggregation (see _lse_ref)."""
    _lse = _lse10 if exact_lse else _lse_ref
    A = gl_mother.shape[0]
    f = xp.asarray(log10_freqs)
    LOG2 = math.log10(2.0)
    LOG_ONE_FOURTH = -math.log10(4.0)

    iota = xp.arange(A)
    het = iota[:, None] != iota[None, :]
    pri = f[:, None] + f[None, :] + xp.where(het, LOG2, 0.0)
    # only genotypes with j <= i are enumerated
    lower = iota[:, None] >= iota[None, :]
    M = xp.where(lower, pri + gl_mother, NEG)
    P = xp.where(lower, pri + gl_father, NEG)
    config = (M[:, :, None, None] + P[None, None, :, :]
              + LOG_ONE_FOURTH)  # [mat_i, mat_j, pat_i, pat_j]

    grid = [xp.reshape(iota, [A if d == i else 1 for i in range(4)])
            for d in range(4)]
    m_ax = xp.reshape(iota, (1, 1, 1, 1, A))
    denovo_mask = ((m_ax != grid[0][..., None]) & (m_ax != grid[1][..., None])
                   & (m_ax != grid[2][..., None]) & (m_ax != grid[3][..., None]))

    nomut_parts = []
    den_parts, oth_parts = [], []
    for mat_axis in (0, 1):
        for pat_axis in (2, 3):
            ia = _axis_index(iota, mat_axis)
            ib = _axis_index(iota, pat_axis)
            nomut_parts.append(config + gl_child[ia, ib])

            # maternal-allele mutations: GLC[m, pat_allele]
            t1 = (config[..., None] + gl_child[m_ax, ib[..., None]]
                  + log10_mut_prior)
            t1 = xp.where(m_ax == grid[mat_axis][..., None], NEG, t1)
            # paternal-allele mutations: GLC[mat_allele, m]
            t2 = (config[..., None] + gl_child[ia[..., None], m_ax]
                  + log10_mut_prior)
            t2 = xp.where(m_ax == grid[pat_axis][..., None], NEG, t2)
            for t in (t1, t2):
                den_parts.append(xp.where(denovo_mask, t, NEG))
                oth_parts.append(xp.where(denovo_mask, NEG, t))

    ll_nomut = _lse(xp, xp.stack(nomut_parts))
    ll_denovo = _lse(xp, xp.stack(den_parts))
    ll_other = _lse(xp, xp.stack(oth_parts))
    return ll_nomut, ll_denovo, ll_other


# --------------------------------------------------------------------------
# batched jobs in torch
#
# The JAX package vmaps the functions above over padded job stacks; here
# the same contractions carry a leading job axis N.  Jobs are padded to a
# shared allele bucket with NEG GLs/freqs: padded configurations underflow
# out of every log-sum-exp exactly, so a job's result does not depend on
# its bucket, and matches the per-job numpy path in float64 up to the
# rounding of the final reductions.
# --------------------------------------------------------------------------

def bucket_alleles(A: int) -> int:
    for b in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128):
        if A <= b:
            return b
    return A


def pad_gl(gl: np.ndarray, Ap: int) -> np.ndarray:
    A = gl.shape[0]
    if A == Ap:
        return gl
    out = np.full((Ap, Ap), NEG, dtype=gl.dtype)
    out[:A, :A] = gl
    return out


def pad_freqs(f: np.ndarray, Ap: int) -> np.ndarray:
    A = f.shape[0]
    if A == Ap:
        return f
    out = np.full(Ap, NEG, dtype=f.dtype)
    out[:A] = f
    return out


def _lse_jobs(x, exact_lse: bool):
    """_lse_ref (or _lse10) of each job's entries: x [N, ...] -> [N]."""
    flat = x.reshape(x.shape[0], -1)
    m = flat.amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    if exact_lse:
        s = torch.log10(torch.pow(10.0, flat - m).sum(dim=1, keepdim=True))
    else:
        s = torch.log(torch.exp(flat - m).sum(dim=1, keepdim=True))
    return (m + s)[:, 0]


def _job_grid(A: int, device):
    """(iota, grid of the four genotype axes, mutation axis, denovo mask)
    over [mat_i, mat_j, pat_i, pat_j, m]."""
    iota = torch.arange(A, device=device)
    grid = [_axis_index(iota, d) for d in range(4)]
    m_ax = iota.reshape(1, 1, 1, 1, A)
    denovo_mask = ((m_ax != grid[0][..., None]) & (m_ax != grid[1][..., None])
                   & (m_ax != grid[2][..., None])
                   & (m_ax != grid[3][..., None]))
    return iota, grid, m_ax, denovo_mask


def _trio_jobs(gm, gf, gc, f, mp, exact_lse):
    """trio_unphased_lls over jobs: gm, gf, gc [N, A, A], f [N, A],
    mp [N] -> three [N] tensors."""
    N, A = f.shape
    iota, grid, m_ax, denovo_mask = _job_grid(A, f.device)
    het = iota[:, None] != iota[None, :]
    # where(het, LOG2, 0.0) in float64 (a where of two Python scalars
    # would be float32)
    pri = f[:, :, None] + f[:, None, :] + het.to(f.dtype) * math.log10(2.0)
    lower = iota[:, None] >= iota[None, :]
    M = torch.where(lower, pri + gm, NEG)
    P = torch.where(lower, pri + gf, NEG)
    config = (M[:, :, :, None, None] + P[:, None, None, :, :]
              + -math.log10(4.0))                        # [N, A, A, A, A]
    mp = mp.reshape(N, 1, 1, 1, 1, 1)

    nomut_parts, den_parts, oth_parts = [], [], []
    for mat_axis in (0, 1):
        for pat_axis in (2, 3):
            ia, ib = grid[mat_axis], grid[pat_axis]
            nomut_parts.append(config + gc[:, ia, ib])
            t1 = config[..., None] + gc[:, m_ax, ib[..., None]] + mp
            t1 = torch.where(m_ax == grid[mat_axis][..., None], NEG, t1)
            t2 = config[..., None] + gc[:, ia[..., None], m_ax] + mp
            t2 = torch.where(m_ax == grid[pat_axis][..., None], NEG, t2)
            for t in (t1, t2):
                den_parts.append(torch.where(denovo_mask, t, NEG))
                oth_parts.append(torch.where(denovo_mask, NEG, t))
    return tuple(_lse_jobs(torch.stack(parts, dim=1), exact_lse)
                 for parts in (nomut_parts, den_parts, oth_parts))


def _family_jobs(gm, gf, gcs, mat, pat, f, mp, exact_lse):
    """phased_family_lls over jobs sharing one transmission pattern: gm, gf
    [N, A, A], gcs [N, C, A, A], f [N, A], mp [N] -> nomut [N], denovo and
    other [N, C]."""
    N, A = f.shape
    iota, grid, m_ax, denovo_mask = _job_grid(A, f.device)
    M = f[:, :, None] + f[:, None, :] + gm
    P = f[:, :, None] + f[:, None, :] + gf
    base = M[:, :, :, None, None] + P[:, None, None, :, :]
    child_t = []
    for c in range(len(mat)):
        ci_axis, cj_axis = _child_axes(mat[c], pat[c])
        child_t.append((gcs[:, c][:, grid[ci_axis], grid[cj_axis]],
                        ci_axis, cj_axis))
    nomut = base
    for t, _, _ in child_t:
        nomut = nomut + t
    mp = mp.reshape(N, 1, 1, 1, 1, 1)

    ll_denovo, ll_other = [], []
    for c, (t, ci_axis, cj_axis) in enumerate(child_t):
        config = nomut - t
        glc = gcs[:, c]
        idx_ci, idx_cj = grid[ci_axis], grid[cj_axis]
        t1 = config[..., None] + glc[:, m_ax, idx_cj[..., None]] + mp
        t1 = torch.where(m_ax == idx_ci[..., None], NEG, t1)
        t2 = config[..., None] + glc[:, idx_ci[..., None], m_ax] + mp
        t2 = torch.where(m_ax == idx_cj[..., None], NEG, t2)
        both = torch.stack([t1, t2], dim=1)
        ll_denovo.append(_lse_jobs(torch.where(denovo_mask, both, NEG),
                                   exact_lse))
        ll_other.append(_lse_jobs(torch.where(denovo_mask, NEG, both),
                                  exact_lse))
    return (_lse_jobs(nomut, exact_lse), torch.stack(ll_denovo, dim=1),
            torch.stack(ll_other, dim=1))


def dispatch_ranges(n_jobs: int, job_bytes: int, budget: int):
    """[lo, hi) job ranges whose largest intermediate (job_bytes per job)
    stays within `budget`; a job over the budget gets a range of its own."""
    per = max(1, budget // job_bytes)
    return [(lo, min(n_jobs, lo + per)) for lo in range(0, n_jobs, per)]


def _run_batched(scan, fn, arrays, job_bytes, C, device, budget, **kw):
    """fn over `arrays` (numpy, leading job axis) in dispatches under the
    budget, on `device` in float64; numpy results, one per output."""
    n, Ap = arrays[-1].shape[0], arrays[0].shape[1]
    outs = []
    for lo, hi in dispatch_ranges(n, job_bytes, budget):
        t0 = time.perf_counter()
        res = fn(*(torch.as_tensor(a[lo:hi], dtype=torch.float64,
                                   device=device) for a in arrays), **kw)
        outs.append([r.cpu().numpy() for r in res])
        DISPATCHES.append(dict(scan=scan, jobs=hi - lo, Ap=Ap, C=C,
                               bytes=(hi - lo) * job_bytes,
                               s=time.perf_counter() - t0))
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def trio_unphased_lls_batched(gms, gfs, gcs, freqs, mut_priors, device,
                              exact_lse: bool = False,
                              budget: int = DISPATCH_BYTES):
    """Stacked padded [N, Ap, Ap] GLs (+ [N, Ap] freqs, [N] priors) ->
    (nomut [N], denovo [N], other [N]) as numpy, computed on `device`."""
    Ap = gms.shape[1]
    return _run_batched("trio", _trio_jobs, (gms, gfs, gcs, freqs,
                                             mut_priors),
                        8 * Ap ** 5 * 8, 1, device, budget,
                        exact_lse=exact_lse)


def phased_family_lls_batched(gms, gfs, gcs, mat: tuple, pat: tuple, freqs,
                              mut_priors, device, exact_lse: bool = False,
                              budget: int = DISPATCH_BYTES):
    """Families sharing a transmission pattern: stacked padded [N, Ap, Ap]
    parent GLs, [N, C, Ap, Ap] child GLs -> (nomut [N], denovo [N, C],
    other [N, C]) as numpy, computed on `device`."""
    Ap = gms.shape[1]
    return _run_batched("family", lambda gm, gf, gc, f, mp, **kw:
                        _family_jobs(gm, gf, gc, tuple(mat), tuple(pat), f,
                                     mp, **kw),
                        (gms, gfs, gcs, freqs, mut_priors),
                        2 * Ap ** 5 * 8, len(mat), device, budget,
                        exact_lse=exact_lse)
