"""Parity of the port's per-locus forward DP against the JAX package.

* the plain version of K4 (`flank_scan_plain`) against
  `flank_scan_pallas` in interpret mode, over phase 1 and then phase 3 of
  one orientation: M, I, D and Mcol within 1e-9 (tests/test_pallas_hmm.py's
  flank tolerance: the same recurrence, elementwise);
* the plain version of K3 (`segment_scan_plain`) against
  `segment_scan_pallas` in interpret mode: Mcol of all R rows within 1e-8
  (the stutter row's terms are summed in another order);
* the port's per-locus `hmm_forward`, in flank and fused mode, against the
  JAX package's XLA `hmm_forward`: LL within 1e-8;
* the wrappers' device dispatch, the K4/K3 launch geometry (every (p, h)
  chain run by one warp, within a block's shared memory) and what the
  wrappers refuse before any launch, and the build key of the kernels.

Inputs are one locus per period, built as tests/test_pallas_hmm.py builds
them (6 reads x 60 bases), packed by the JAX package's prepare_locus and
brought across with locus_to_torch; float64 throughout.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipstr_tpu.ops.hmm import hmm_forward as jax_hmm_forward
from hipstr_tpu.ops.pallas_hmm import flank_scan_pallas, segment_scan_pallas
from hipstr_tpu.pipeline.hap_aligner import prepare_locus
from hipstr_tpu_torch import kernels
from hipstr_tpu_torch.ops.emission import stutter_emissions
from hipstr_tpu_torch.ops.hmm import (IMPOSSIBLE, HapMeta, emit_locus,
                                      expand_quals, hmm_forward, shift_right)
from hipstr_tpu_torch.ops.hmm2 import SMEM_BLOCK
from hipstr_tpu_torch.ops.hmm_scan import (SCAN_KERNELS, flank_scan,
                                           flank_scan_kernel,
                                           flank_scan_plain, scan_chain,
                                           scan_geometry, segment_scan,
                                           segment_scan_kernel,
                                           segment_scan_plain)
from hipstr_tpu_torch.pipeline.hap_aligner import locus_to_torch
from tests.test_hmm_kernel import _mk_haplotype, _reads_from_hap
from test_torch_slice import one_torch_thread  # noqa: F401

PERIODS = [1, 2, 3, 4, 7, 9]
F64 = torch.float64
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _locus(period):
    """One locus (two repeat alternates, one flank alternate), packed by
    the JAX package."""
    rng = np.random.default_rng(40 + period)
    hap = _mk_haplotype(rng, period, 7 if period < 3 else 4, n_rep_alts=2,
                        n_flank_alts=1)
    seqs, quals, seeds = _reads_from_hap(rng, hap, 6, 60)
    return prepare_locus(hap, seqs, quals, seeds, "float64")


def _segment(period, orient):
    """The kernels' inputs for one orientation (0 forward, 1 reverse)."""
    arrays, statics = _locus(period)
    t = locus_to_torch(arrays, CPU, F64)
    seg, meta = t[orient], t[2 + orient]
    blw, blc = expand_quals(seg.quals, F64)
    C = torch.cumsum(blc, dim=-1)
    reads = (seg.codes.int(), blw, blc, C, shift_right(C, 0.0),
             seg.last_col.int())
    return reads, meta, statics[orient], statics[2 + orient]


def _row0(reads, meta):
    codes, blw, blc, C, Csh, _ = reads
    M = emit_locus(codes, meta.row_char[:, 0], blc, blw) + Csh[:, None]
    return M, C[:, None].expand(M.shape).contiguous(), \
        torch.full_like(M, IMPOSSIBLE)


def _rows(meta, lo, hi):
    return [x[:, lo:hi].T.contiguous() for x in
            (meta.row_char, meta.row_m2m, meta.row_m2i, meta.row_m2d)] + \
        [meta.row_active[lo:hi]]


def _emissions(reads, meta, period):
    codes, blw, blc = reads[:3]
    return stutter_emissions(codes[None], blw[None], blc[None],
                             meta.rep_rev_codes.int()[None],
                             meta.rep_len.int()[None],
                             torch.tensor([period], dtype=torch.int32))[0]


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("period", PERIODS)
def test_flank_scan_plain_matches_pallas(period):
    reads, meta, R, sr = _segment(period, 0)
    state = _row0(reads, meta)
    for lo, hi in ((1, sr), (sr + 2, R)):       # phase 1, then phase 3
        rows = _rows(meta, lo, hi)
        got = flank_scan_plain(*reads, *rows, *state)
        want = flank_scan_pallas(*map(_j, reads), *map(_j, rows),
                                 *map(_j, state), dtype=jnp.float64,
                                 interpret=True)
        for name, g, w in zip("MIDC", got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9, err_msg=name)
        state = got[:3]


@pytest.mark.parametrize("period", PERIODS)
def test_segment_scan_plain_matches_pallas(period):
    reads, meta, R, sr = _segment(period, 1)
    E = _emissions(reads, meta, period)
    got = segment_scan_plain(*reads, meta, E, R, sr, period)
    jmeta = jax.tree.map(_j, meta)
    want = segment_scan_pallas(*map(_j, reads), jmeta,
                               _j(E.permute(2, 0, 3, 1)), R, sr, period,
                               dtype=jnp.float64, interpret=True)
    assert got.shape == (R,) + tuple(want.shape[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-8)


@functools.lru_cache(maxsize=None)
def _jax_ll(period):
    arrays, statics = _locus(period)
    R_f, R_r, sr_f, sr_r, per = statics[:5]
    args = jax.tree.map(jnp.asarray, tuple(arrays[:7]))
    return np.asarray(jax.jit(
        lambda *a: jax_hmm_forward(*a, R_f, R_r, per, sr_f, sr_r,
                                   jnp.float64))(*args))


@pytest.mark.parametrize("mode", ["flank", "fused"])
@pytest.mark.parametrize("period", PERIODS)
def test_hmm_forward_matches_xla(monkeypatch, period, mode):
    monkeypatch.delenv("HIPSTR_TPU_PALLAS", raising=False)
    arrays, statics = _locus(period)
    R_f, R_r, sr_f, sr_r, per, P_real, H_real = statics[:7]
    got = hmm_forward(*locus_to_torch(arrays, CPU, F64), R_f, R_r, per,
                      sr_f, sr_r, F64, mode=mode).numpy()
    want = _jax_ll(period)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:P_real, :H_real],
                               want[:P_real, :H_real], rtol=1e-8, atol=1e-8)


def _wrapper_args(kernel):
    reads, meta, R, sr = _segment(2, 0)
    if kernel == "flank_scan":
        return (flank_scan, flank_scan_plain,
                (*reads, *_rows(meta, 1, sr), *_row0(reads, meta)))
    return (segment_scan, segment_scan_plain,
            (*reads, meta, _emissions(reads, meta, 2), R, sr, 2))


@pytest.mark.parametrize("kernel", ["flank_scan", "segment_scan"])
def test_cpu_wrapper_takes_plain_version_without_launching(kernel):
    wrapper, plain, args = _wrapper_args(kernel)
    before = dict(kernels.LAUNCHES)
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["flank_scan", "segment_scan"])
def test_non_cpu_tensor_never_takes_plain_version(kernel):
    """Only a CPU tensor takes the plain path: any other device launches
    the kernel or raises."""
    wrapper, _, args = _wrapper_args(kernel)

    def meta(x):
        if isinstance(x, torch.Tensor):
            return x.to("meta")
        if isinstance(x, tuple):
            return type(x)(*map(meta, x))
        return x

    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*map(meta, args))


@pytest.mark.parametrize("kernel", SCAN_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", kernels.WARP_LANES)
def test_scan_geometry_covers_every_chain_once(L, dtype, kernel):
    """K4's and K3's launch (csrc/flank_scan.cu, csrc/segment_scan.cu):
    every (p, h) chain is run by exactly one warp, within 1024 threads and
    227 KB of shared memory a block, from the shortest rows to the longest
    bucket (224 flank rows for K4, R = 450 for K3)."""
    deepest = 224 if kernel == "flank_scan" else 450
    for P, H, rows in ((1, 1, 2), (7, 5, 50), (64, 16, 130),
                       (16, 100, deepest)):
        geom = scan_geometry(P, H, L, rows, dtype, kernel)
        assert geom.threads == 32 * geom.warps <= 1024
        assert geom.smem <= SMEM_BLOCK
        assert geom.lanes_per_thread * 32 == L
        assert geom.shared_lanes == (dtype == torch.float64 and L > 256)
        seen = [scan_chain(geom, (x, y), w, H)
                for x in range(geom.grid[0]) for y in range(geom.grid[1])
                for w in range(geom.warps)]
        chains = [c for c in seen if c is not None]
        assert len(chains) == len(set(chains)) == P * H
        assert set(chains) == {(p, h) for p in range(P) for h in range(H)}


def _kernel_args(kernel, L=128, dtype=F64, nD=13):
    """Zero arguments of a K4 or K3 wrapper at lanes L (CPU tensors: a
    wrapper must refuse them before it reaches any kernel)."""
    P, H, R, sr, O = 2, 3, 6, 2, 2

    def f(*shape):
        return torch.zeros(shape, dtype=dtype)

    def i(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    reads = (i(P, L), f(P, L), f(P, L), f(P, L), f(P, L), i(P))
    if kernel == "flank_scan":
        return (*reads, i(R, H), f(R, H), f(R, H), f(R, H),
                torch.ones(R, dtype=torch.bool), f(P, H, L), f(P, H, L),
                f(P, H, L))
    meta = HapMeta(row_char=i(H, R), row_m2m=f(H, R), row_m2i=f(H, R),
                   row_m2d=f(H, R), rep_rev_codes=i(O, 4), rep_len=i(O),
                   lpmf=f(O, nD), hap_opt=i(H),
                   row_active=torch.ones(R, dtype=torch.bool))
    return (*reads, meta, f(O, nD, P, L), R, sr, 2)


_REFUSED = [(dict(L=96), "L=96"), (dict(L=1024), "L=1024"),
            (dict(dtype=torch.float16), "dtype")]


@pytest.mark.parametrize("kernel,bad,match", [
    (k, bad, match) for k in SCAN_KERNELS for bad, match in _REFUSED]
    + [("segment_scan", dict(nD=11), "11 artifact sizes")],
    ids=[f"{k}-{i}" for k in SCAN_KERNELS for i in ("L96", "L1024",
                                                     "float16")]
    + ["segment_scan-nD11"])
def test_scan_wrappers_refuse_what_the_kernels_do_not_take(kernel, bad,
                                                           match):
    """The geometry refuses an L outside the six buckets and a dtype other
    than float32/float64; the K4/K3 wrappers refuse them, and K3 a count of
    artifact sizes other than 13, before any build or launch."""
    if "nD" not in bad:
        with pytest.raises(ValueError, match=match):
            scan_geometry(4, 8, bad.get("L", 128), 20,
                          bad.get("dtype", F64), kernel)
    wrapper = (flank_scan_kernel if kernel == "flank_scan"
               else segment_scan_kernel)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        wrapper(*_kernel_args(kernel, **bad))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    dict(P=0), dict(H=0), dict(rows=10000, L=512, dtype=torch.float64)],
    ids=["no-pools", "no-haplotypes", "rows-past-shared-memory"])
@pytest.mark.parametrize("kernel", SCAN_KERNELS)
def test_scan_geometry_refuses_empty_and_oversized_launches(kernel, bad):
    args = dict(P=4, H=8, L=128, rows=20, dtype=F64, kernel=kernel)
    args.update(bad)
    with pytest.raises(ValueError, match=kernel):
        scan_geometry(**args)


def test_build_key_hashes_the_shared_header(monkeypatch, tmp_path):
    """Editing the one shared header, csrc/dp_warp.cuh (which K2, K4 and K3
    include), moves every kernel library to a new path, so a stale build is
    never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["dp_warp.cuh"]
    before = {n: kernels.library_path(n) for n in kernels.LAUNCHES}
    assert kernels.library_path("segment") == before["segment"]
    hdr = csrc / "dp_warp.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: kernels.library_path(n) for n in kernels.LAUNCHES}
    assert all(before[n] != after[n] for n in kernels.LAUNCHES)
    for name in ("segment", "flank_scan", "segment_scan"):
        assert '#include "dp_warp.cuh"' in (csrc / f"{name}.cu").read_text()


def test_check_aligned_refuses_a_misaligned_view():
    """The warp kernels move a thread's lanes in 8- and 16-byte pieces: a
    view that starts off a 16-byte boundary is refused before any launch
    (a misaligned vector access would end the CUDA context)."""
    base = torch.zeros(64, dtype=torch.float32)
    kernels.check_aligned("whole", base)
    kernels.check_aligned("row", base.view(4, 16)[1])
    with pytest.raises(ValueError, match="16-byte"):
        kernels.check_aligned("shifted", base[1:])
