"""The port's de novo slice against the JAX package.

* the numpy host functions of hipstr_tpu_torch.denovo.likelihoods equal the
  JAX package's exactly, and the brute-force loops of tests/test_denovo.py;
* the batched torch jobs on the CPU match the JAX per-job numpy path and
  its jit(vmap) batches to 1e-12 (A in 2, 3, 5, 7, 12, every transmission
  pattern, one and two children), and a dispatch budget that splits a
  group changes nothing;
* the scanners (host path and batched) write the JAX scanners' text; the
  port's moving haplotype tracker holds the same haplotypes as the JAX
  package's, which rebuilds every window;
* `python -m hipstr_tpu_torch.denovo_finder --device cpu` writes the JAX
  DenovoFinder's VCF body on the de novo golden suite's trio, and
  `--device cuda` without a card exits non-zero with no VCF;
* PhasingChecker and annotate-denovo write the JAX entry points' outputs;
* the anchors tests/data/torch_port_denovo_{str,trio,family}_f64.vcf are
  current: the JAX genotyper's float64 VCF of the trio (the port's CPU run
  writes it too) and the JAX DenovoFinder's trio and family scans of it.
  `python tests/test_torch_denovo.py` rewrites them from the JAX package.
"""

import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from hipstr_tpu.denovo import likelihoods as jl
from hipstr_tpu.denovo import scanner as jscanner
from hipstr_tpu.io.bgzf import BgzfReader
from hipstr_tpu.io.vcf_read import VCFReader as JaxVCFReader
from hipstr_tpu.phasing.haplotype_tracker import \
    HaplotypeTracker as JaxTracker
from hipstr_tpu.phasing.pedigree import \
    extract_pedigree_nuclear_families as jax_families
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.denovo import likelihoods as tl
from hipstr_tpu_torch.denovo.scanner import DenovoScanner, TrioDenovoScanner
from hipstr_tpu_torch.io.vcf_read import VCFReader
from hipstr_tpu_torch.phasing.haplotype_tracker import HaplotypeTracker
from hipstr_tpu_torch.phasing.pedigree import \
    extract_pedigree_nuclear_families
from hipstr_tpu_torch.utils.simdata import (DENOVO_GENOTYPE_ARGS,
                                            write_denovo_cohort,
                                            write_phased_snps,
                                            write_trio_denovo)

from test_denovo import brute_phased, brute_trio
from test_torch_slice import (ONE_THREAD, ROOT, _body,  # noqa: F401
                              one_torch_thread, run_jax_cli)

DATA = os.path.join(ROOT, "tests", "data")
STR_ANCHOR = os.path.join(DATA, "torch_port_denovo_str_f64.vcf")
SCAN_ANCHORS = {scan: os.path.join(DATA, f"torch_port_denovo_{scan}_f64.vcf")
                for scan in ("trio", "family")}
CPU = torch.device("cpu")
# (maternal index, paternal index) of one child: every pattern
PATTERNS = [(m, p) for m in range(4) for p in ((2, 3) if m < 2 else (0, 1))]
# two-child families: each pattern with another
PAIRS = [(PATTERNS[i], PATTERNS[(i + 3) % 8]) for i in range(8)]
ALLELES = (2, 3, 5, 7, 12)
TOL = 1e-12     # batched vs per-job: the final reductions round differently


def _sym(rng, A):
    m = rng.uniform(-8, 0, (A, A))
    return (m + m.T) / 2


def _trio_jobs(rng, A, n=3):
    return [(_sym(rng, A), _sym(rng, A), _sym(rng, A)) for _ in range(n)]


def _family_jobs(rng, A, C, n=3):
    return [(rng.uniform(-8, 0, (A, A)), rng.uniform(-8, 0, (A, A)),
             [rng.uniform(-8, 0, (A, A)) for _ in range(C)])
            for _ in range(n)]


def _freqs(rng, A):
    """Population priors from random founder genotypes."""
    return jl.population_log10_freqs(
        A, [tuple(rng.integers(0, A, 2)) for _ in range(4)])


def _stack_trio(jobs, f, mp, Ap):
    return (np.stack([tl.pad_gl(j[0], Ap) for j in jobs]),
            np.stack([tl.pad_gl(j[1], Ap) for j in jobs]),
            np.stack([tl.pad_gl(j[2], Ap) for j in jobs]),
            np.stack([tl.pad_freqs(f, Ap)] * len(jobs)),
            np.full(len(jobs), mp))


def _stack_family(fams, f, mp, Ap):
    return (np.stack([tl.pad_gl(x[0], Ap) for x in fams]),
            np.stack([tl.pad_gl(x[1], Ap) for x in fams]),
            np.stack([[tl.pad_gl(g, Ap) for g in x[2]] for x in fams]),
            np.stack([tl.pad_freqs(f, Ap)] * len(fams)),
            np.full(len(fams), mp))


# ------------------------------------------------------ host functions
@pytest.mark.parametrize("A", ALLELES)
def test_host_functions_equal_jax(A):
    rng = np.random.default_rng(100 + A)
    f = _freqs(rng, A)
    founders = [tuple(rng.integers(0, A, 2)) for _ in range(5)]
    assert np.array_equal(tl.population_log10_freqs(A, founders),
                          jl.population_log10_freqs(A, founders))
    assert np.array_equal(tl.uniform_log10_freqs(A),
                          jl.uniform_log10_freqs(A))
    gl = list(rng.uniform(-9, 0, A * (A + 1) // 2))
    assert np.array_equal(tl.expand_unphased_gls(gl, A),
                          jl.expand_unphased_gls(gl, A))
    pgl = list(rng.uniform(-9, 0, A * A))
    assert np.array_equal(tl.expand_phased_gls(pgl, A),
                          jl.expand_phased_gls(pgl, A))
    Ap = tl.bucket_alleles(A + 1)
    assert Ap == jl.bucket_alleles(A + 1)
    m = _sym(rng, A)
    assert np.array_equal(tl.pad_gl(m, Ap), jl.pad_gl(m, Ap))
    assert np.array_equal(tl.pad_freqs(f, Ap), jl.pad_freqs(f, Ap))
    for exact in (False, True):
        for gm, gf, gc in _trio_jobs(rng, A, 2):
            got = tl.trio_unphased_lls(np, gm, gf, gc, f, -1.1, exact)
            want = jl.trio_unphased_lls(np, gm, gf, gc, f, -1.1, exact)
            assert [float(x) for x in got] == [float(x) for x in want]
        for pats in [[p] for p in PATTERNS] + [list(p) for p in PAIRS]:
            mat, pat = [p[0] for p in pats], [p[1] for p in pats]
            gm, gf, gcs = _family_jobs(rng, A, len(pats), 1)[0]
            got = tl.phased_family_lls(np, gm, gf, gcs, mat, pat, f, -0.9,
                                       exact)
            want = jl.phased_family_lls(np, gm, gf, gcs, mat, pat, f, -0.9,
                                        exact)
            assert float(got[0]) == float(want[0])
            assert np.array_equal(got[1], want[1])
            assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trio_host_function_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    A = 4
    freqs = tl.uniform_log10_freqs(A)
    mats = [_sym(rng, A) for _ in range(3)]
    got = tl.trio_unphased_lls(np, *mats, freqs, -1.0)
    want = brute_trio(*mats, freqs, -1.0)
    assert np.allclose([float(x) for x in got], want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mat_idx,pat_idx", [([m], [p]) for m, p in PATTERNS]
                         + [([0, 2], [3, 1]), ([1, 3], [2, 0])])
def test_family_host_function_matches_brute_force(mat_idx, pat_idx):
    rng = np.random.default_rng(7 + mat_idx[0])
    A = 3
    freqs = tl.uniform_log10_freqs(A)
    gm, gf, gcs = _family_jobs(rng, A, len(mat_idx), 1)[0]
    n, d, o = tl.phased_family_lls(np, gm, gf, gcs, mat_idx, pat_idx,
                                   freqs, -1.0)
    bn, bd, bo = brute_phased(gm, gf, gcs, mat_idx, pat_idx, freqs, -1.0)
    assert np.isclose(float(n), bn, rtol=0, atol=1e-9)
    assert np.allclose(d, bd, rtol=0, atol=1e-9)
    assert np.allclose(o, bo, rtol=0, atol=1e-9)


# ------------------------------------------------------ batched jobs
@pytest.mark.parametrize("A", ALLELES)
def test_batched_jobs_match_jax_per_job(A):
    """The torch batches on the CPU against the JAX per-job numpy path:
    the trio scan (both aggregations) and every transmission pattern of
    one and two children."""
    rng = np.random.default_rng(200 + A)
    Ap = tl.bucket_alleles(A)
    f = _freqs(rng, A)
    jobs = _trio_jobs(rng, A)
    for exact in (False, True):
        got = tl.trio_unphased_lls_batched(*_stack_trio(jobs, f, -1.25, Ap),
                                           CPU, exact_lse=exact)
        for i, (gm, gf, gc) in enumerate(jobs):
            want = jl.trio_unphased_lls(np, gm, gf, gc, f, -1.25, exact)
            for k in range(3):
                assert abs(got[k][i] - float(want[k])) <= TOL
    for pats in [[p] for p in PATTERNS] + [list(p) for p in PAIRS]:
        mat, pat = tuple(p[0] for p in pats), tuple(p[1] for p in pats)
        fams = _family_jobs(rng, A, len(pats))
        gm, gf, gc, fr, mp = _stack_family(fams, f, -0.9, Ap)
        got = tl.phased_family_lls_batched(gm, gf, gc, mat, pat, fr, mp,
                                           CPU)
        for i, (gm, gf, gcs) in enumerate(fams):
            want = jl.phased_family_lls(np, gm, gf, gcs, list(mat),
                                        list(pat), f, -0.9)
            assert abs(got[0][i] - float(want[0])) <= TOL
            assert np.allclose(got[1][i], want[1], rtol=0, atol=TOL)
            assert np.allclose(got[2][i], want[2], rtol=0, atol=TOL)


@pytest.mark.parametrize("A", ALLELES)
def test_batched_jobs_match_jax_batches(A):
    """The torch batches against the JAX package's jit(vmap) batches on
    the CPU, for the trio scan and one pattern of one and two children."""
    rng = np.random.default_rng(300 + A)
    Ap = tl.bucket_alleles(A)
    f = tl.uniform_log10_freqs(A)
    args = _stack_trio(_trio_jobs(rng, A), f, -1.25, Ap)
    for g, w in zip(tl.trio_unphased_lls_batched(*args, CPU),
                    jl.trio_unphased_lls_batched(*args)):
        assert np.allclose(g, w, rtol=0, atol=TOL)
    for mat, pat in (((1,), (3,)), ((2, 0), (1, 3))):
        gm, gf, gc, fr, mp = _stack_family(
            _family_jobs(rng, A, len(mat)), f, -0.9, Ap)
        got = tl.phased_family_lls_batched(gm, gf, gc, mat, pat, fr, mp,
                                           CPU)
        want = jl.phased_family_lls_batched(gm, gf, gc, mat, pat, fr, mp)
        for g, w in zip(got, want):
            assert np.allclose(g, w, rtol=0, atol=TOL)


def test_dispatch_budget_splits_without_changing_results():
    rng = np.random.default_rng(5)
    A, Ap = 5, 6
    f = tl.uniform_log10_freqs(A)
    args = _stack_trio(_trio_jobs(rng, A, 7), f, -1.25, Ap)
    tl.DISPATCHES.clear()
    one = tl.trio_unphased_lls_batched(*args, CPU)
    job = 8 * Ap ** 5 * 8
    split = tl.trio_unphased_lls_batched(*args, CPU, budget=3 * job)
    alone = tl.trio_unphased_lls_batched(*args, CPU, budget=1)
    assert [d["jobs"] for d in tl.DISPATCHES] == [7, 3, 3, 1] + [1] * 7
    assert max(d["bytes"] for d in tl.DISPATCHES[1:4]) <= 3 * job
    for a, b, c in zip(one, split, alone):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    fam = _stack_family(_family_jobs(rng, A, 2, 5), f, -0.9, Ap)
    whole = tl.phased_family_lls_batched(*fam[:3], (0, 2), (3, 1), *fam[3:],
                                         CPU)
    parts = tl.phased_family_lls_batched(*fam[:3], (0, 2), (3, 1), *fam[3:],
                                         CPU, budget=2 * 2 * Ap ** 5 * 8)
    for a, b in zip(whole, parts):
        assert np.array_equal(a, b)
    assert tl.dispatch_ranges(5, 10, 25) == [(0, 2), (2, 4), (4, 5)]


# ------------------------------------------------------ scanners
@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A small synthetic cohort: 14 records (2-12 alleles), 4 families
    (trios and quads), 2 chromosomes of phased SNPs."""
    d = str(tmp_path_factory.mktemp("denovo_cohort"))
    return write_denovo_cohort(d, records=14, families=4, chroms=2)


def _jax_scan(scan, fam, str_vcf, snp_vcf, use_pop=True):
    families = jax_families(fam, set(JaxVCFReader(str_vcf).samples))
    buf = io.StringIO()
    if scan == "trio":
        jscanner.TrioDenovoScanner(families, buf, use_pop).scan(
            JaxVCFReader(str_vcf))
    else:
        jscanner.DenovoScanner(families, buf, use_pop).scan(
            JaxVCFReader(snp_vcf), JaxVCFReader(str_vcf))
    return buf.getvalue()


def _port_scan(scan, fam, str_vcf, snp_vcf, device_batch, use_pop=True):
    families = extract_pedigree_nuclear_families(
        fam, set(VCFReader(str_vcf).samples))
    buf = io.StringIO()
    if scan == "trio":
        TrioDenovoScanner(families, buf, use_pop, CPU).scan(
            VCFReader(str_vcf), device_batch=device_batch)
    else:
        DenovoScanner(families, buf, use_pop, CPU).scan(
            VCFReader(snp_vcf), VCFReader(str_vcf),
            device_batch=device_batch)
    return buf.getvalue()


@pytest.mark.parametrize("device_batch", [0, 3])
@pytest.mark.parametrize("scan", ["trio", "family"])
def test_scanners_write_the_jax_text(cohort, scan, device_batch):
    want = _jax_scan(scan, *cohort)
    got = _port_scan(scan, *cohort, device_batch)
    assert got == want
    rows = got.splitlines()
    assert len(rows) == 14
    assert all(c != "." for row in rows for c in row.split("\t")[9:])


def test_scanner_batches_need_a_device(cohort):
    fam, str_vcf, _ = cohort
    families = extract_pedigree_nuclear_families(
        fam, set(VCFReader(str_vcf).samples))
    with pytest.raises(ValueError, match="device"):
        TrioDenovoScanner(families, io.StringIO()).scan(
            VCFReader(str_vcf), device_batch=4)


def test_moving_tracker_holds_the_jax_haplotypes(cohort):
    """Forward steps inside the window, a jump past it, a step back and a
    new chromosome: the same SNPs and haplotypes as a rebuilt window."""
    fam, str_vcf, snp_vcf = cohort
    samples = set(VCFReader(str_vcf).samples)
    port = HaplotypeTracker(extract_pedigree_nuclear_families(fam, samples),
                            VCFReader(snp_vcf), 50000)
    ref = JaxTracker(jax_families(fam, samples), JaxVCFReader(snp_vcf),
                     50000)
    steps = [("chr1", p) for p in (1000, 1000, 30000, 60000, 61000, 200000,
                                   150000, 260000)] + [("chr2", 5000),
                                                       ("chr2", 90000)]
    for chrom, pos in steps:
        port.advance(chrom, pos)
        ref.advance(chrom, pos)
        assert port.positions == ref.positions
        for s in ref._h1:
            assert np.array_equal(port._h1[s], ref._h1[s])
            assert np.array_equal(port._h2[s], ref._h2[s])
        for f in port.families:
            got = port.infer_haplotype_inheritance(f, 10, 20)
            want = ref.infer_haplotype_inheritance(
                next(g for g in ref.families if g.family_id == f.family_id),
                10, 20)
            assert got == want


# ------------------------------------------------------ the trio chain
def _jax_module(module, args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _port_module(module, args):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """The de novo golden suite's trio with its phased SNPs."""
    d = str(tmp_path_factory.mktemp("denovo_trio"))
    locs = write_trio_denovo(d)
    return d, write_phased_snps(d, [l.chrom for l in locs])


def _genotype_args(d, out):
    return (["--bams", f"{d}/sim.bam", "--fasta", f"{d}/sim.fa", "--regions",
             f"{d}/regions.bed", "--str-vcf", out, "--dtype", "float64",
             "--silent"] + DENOVO_GENOTYPE_ARGS)


def _finder_args(d, snps, scan, out, *extra):
    args = ["--fam", f"{d}/trio.fam", "--str-vcf", STR_ANCHOR,
            "--denovo-vcf", out, *extra]
    return args + (["--snp-vcf", snps] if scan == "family" else [])


def test_denovo_str_anchor_is_current(trio):
    d, _ = trio
    run_jax_cli(_genotype_args(d, f"{d}/jax_str.vcf"))
    assert _body(f"{d}/jax_str.vcf") == _body(STR_ANCHOR)


def test_port_writes_the_denovo_str_anchor(trio):
    d, _ = trio
    _, counters = cli.run(_genotype_args(d, f"{d}/port_str.vcf")
                          + ["--device", "cpu", "--host-workers", "1"])
    assert counters.genotype_fail == 0
    assert _body(f"{d}/port_str.vcf") == _body(STR_ANCHOR)


@pytest.mark.parametrize("scan", ["trio", "family"])
def test_denovo_scan_anchor_is_current(trio, scan):
    d, snps = trio
    out = f"{d}/jax_{scan}.vcf"
    _jax_module("hipstr_tpu.denovo_finder",
                _finder_args(d, snps, scan, out))
    assert _body(out) == _body(SCAN_ANCHORS[scan]) and _body(out)


@pytest.mark.parametrize("scan,extra", [
    ("trio", []), ("family", []), ("trio", ["--device-batch", "3"]),
    ("family", ["--device-batch", "3"]), ("trio", ["--uniform-prior"]),
    ("family", ["--uniform-prior"])],
    ids=["trio", "family", "trio-batched", "family-batched", "trio-uniform",
         "family-uniform"])
def test_port_denovo_finder_writes_the_jax_body(trio, scan, extra):
    d, snps = trio
    tag = "-".join([scan] + extra).replace("--", "")
    out = f"{d}/port_{tag}.vcf"
    proc = _port_module("hipstr_tpu_torch.denovo_finder",
                        _finder_args(d, snps, scan, out, "--device", "cpu",
                                     *extra))
    assert proc.returncode == 0, proc.stderr[-3000:]
    if "--uniform-prior" in extra:
        want = f"{d}/jax_{tag}.vcf"
        _jax_module("hipstr_tpu.denovo_finder",
                    _finder_args(d, snps, scan, want, "--uniform-prior"))
        assert _body(out) == _body(want)
    else:
        assert _body(out) == _body(SCAN_ANCHORS[scan])


def test_denovo_finder_on_cuda_without_a_card_writes_nothing(trio):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    d, snps = trio
    out = f"{d}/nocard.vcf"
    proc = _port_module("hipstr_tpu_torch.denovo_finder",
                        _finder_args(d, snps, "trio", out, "--device",
                                     "cuda"))
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and not os.path.exists(out)


# ------------------------------------------------------ host entry points
def _write_phasing_inputs(out):
    """The inputs of tests/test_phasing.py::test_phasing_checker_cli."""
    samples = ["MOM", "DAD", "KID"]
    rng = random.Random(3)
    lines = ["##fileformat=VCFv4.1", "##contig=<ID=chr1,length=10000000>",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(samples)]
    pos = 1000
    for _ in range(300):
        pos += rng.randint(100, 2000)
        mom = (rng.randint(0, 1), rng.randint(0, 1))
        dad = (rng.randint(0, 1), rng.randint(0, 1))
        kid = (mom[0], dad[0])
        gts = "\t".join(f"{a}|{b}" for a, b in (mom, dad, kid))
        lines.append(f"chr1\t{pos}\t.\tA\tC\t.\t.\t.\tGT\t{gts}")
    with open(f"{out}/snps.vcf", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(f"{out}/trio.fam", "w") as fh:
        fh.write("FAM1\tKID\tDAD\tMOM\t0\t0\n")
    with open(f"{out}/regions.bed", "w") as fh:
        fh.write("chr1\t200000\t200020\t4\t5.0\tX\n")
        fh.write("chr1\t400000\t400020\t4\t5.0\tY\n")


@pytest.mark.parametrize("suffix", [".gz", ".txt"])
def test_phasing_checker_writes_the_jax_output(tmp_path, suffix):
    from hipstr_tpu import phasing_checker as jax_checker
    from hipstr_tpu_torch import phasing_checker
    d = str(tmp_path)
    _write_phasing_inputs(d)
    outs = {}
    for name, main in (("jax", jax_checker.main),
                       ("port", phasing_checker.main)):
        out = f"{d}/{name}_dists{suffix}"
        assert main(["--fam", f"{d}/trio.fam", "--snp-vcf", f"{d}/snps.vcf",
                     "--regions", f"{d}/regions.bed", "--out", out]) == 0
        outs[name] = (BgzfReader(out).read_all().decode() if suffix == ".gz"
                      else open(out).read())
    assert outs["port"] == outs["jax"]
    assert len(outs["port"].strip().splitlines()) == 3


@pytest.mark.parametrize("keep", [[], ["--keep-gls"]],
                         ids=["drop-gls", "keep-gls"])
def test_annotate_denovo_writes_the_jax_output(trio, tmp_path, keep):
    from hipstr_tpu.scripts import annotate_denovo as jax_annotate
    from hipstr_tpu_torch.scripts import annotate_denovo
    d = str(tmp_path)
    families = extract_pedigree_nuclear_families(
        f"{trio[0]}/trio.fam", set(VCFReader(STR_ANCHOR).samples))
    with open(f"{d}/lls.vcf", "w") as fh:
        scanner = TrioDenovoScanner(families, fh, True, CPU)
        scanner.write_vcf_header("denovo")
        scanner.scan(VCFReader(STR_ANCHOR), device_batch=2)
    outs = {}
    for name, main in (("jax", jax_annotate.main),
                       ("port", annotate_denovo.main)):
        out = f"{d}/{name}.vcf"
        assert main(["--vcf", STR_ANCHOR, "--denovo-ll-vcf", f"{d}/lls.vcf",
                     "--out", out] + keep) == 0
        outs[name] = open(out).read()
    assert outs["port"] == outs["jax"]
    assert "NOMUT" in _body(f"{d}/port.vcf")[0]


def write_anchors():
    """Rewrite the three de novo anchors from the JAX package: its
    genotyper's float64 VCF of the trio (without the ##command line, which
    names paths), and its DenovoFinder's trio and family scans of that."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        locs = write_trio_denovo(d)
        snps = write_phased_snps(d, [l.chrom for l in locs])
        run_jax_cli(_genotype_args(d, f"{d}/str.vcf"))
        with open(STR_ANCHOR, "w") as fh:
            fh.writelines(l for l in open(f"{d}/str.vcf")
                          if not l.startswith(("##command", "##reference")))
        for scan, path in SCAN_ANCHORS.items():
            _jax_module("hipstr_tpu.denovo_finder",
                        _finder_args(d, snps, scan, f"{d}/{scan}.vcf"))
            with open(path, "w") as fh:
                fh.writelines(_body(f"{d}/{scan}.vcf"))


if __name__ == "__main__":
    write_anchors()
