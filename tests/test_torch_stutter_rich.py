"""The default path without a stutter model on reads whose CIGARs carry
their stutter, held to a frozen float64 anchor from the JAX CLI.

utils.simdata.stutter_rich_loci(**STUTTER_RICH_ANCHOR): 12 loci (periods
1-6, two each) x 3 samples x 50 reads of 100 bp with a phased SNP each;
every read's repeat-length change is an I or D in its CIGAR, so every
locus's stutter EM sees several allele sizes and runs its loop.
(a) the generator is deterministic, and through the port's
    processor.stutter_em_inputs and host EM every locus has A >= 3 and
    >= 3 EM iterations (a dataset of all-M CIGARs has A = 1 and stops at
    iteration 2);
(b) the EM problems of the set: the port's em_train_batch in float64 on
    the CPU against the JAX package's (rtol 1e-10) and against the host EM
    (converged flags and iterations equal, parameters within rtol 1e-8),
    reading `active` every SYNC_EVERY passes and every pass;
(c) the port's CLI on the CPU in float64, sequential (--batch-loci 0: the
    host EM, K1 and K3's plain versions): the anchor's records and models
    of the loci it runs, byte for byte.
test_torch_stutter_rich_b.py runs the batched path with the card's device
EM and fused posteriors forced on the CPU, in float64 and float32.

tests/data/torch_port_stutter_rich_f64.vcf and
torch_port_stutter_rich_models_f64.txt are the JAX CLI's float64 run on
the CPU (batched, host EM, host posteriors) over all 12 loci, and
chip_smoke.py phase 7e holds the card's runs to all of them.  A port locus
of period 3-6 costs 10-25 s here (K1's plain version), so the CLI runs on
the CPU take the four loci of periods 1-2 (CPU_LOCI); each locus's record
and model depend on its own reads only.

`PYTHONPATH=.:tests python tests/test_torch_stutter_rich.py` rewrites both
files from the JAX CLI.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from hipstr_tpu.ops import em_batched as jax_em
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.io.regions import read_regions
from hipstr_tpu_torch.ops import em_batched
from hipstr_tpu_torch.ops.em import EMStutterGenotyper
from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline, Logger,
                                                 PipelineOptions)
from hipstr_tpu_torch.utils.simdata import (STUTTER_RICH_ANCHOR,
                                            stutter_rich_args,
                                            stutter_rich_loci,
                                            write_stutter_rich)

from test_torch_slice import ROOT, _body, one_torch_thread  # noqa: F401
from test_torch_slice import run_jax_cli

DATA = os.path.join(ROOT, "tests", "data")
ANCHOR_VCF = os.path.join(DATA, "torch_port_stutter_rich_f64.vcf")
ANCHOR_MODELS = os.path.join(DATA, "torch_port_stutter_rich_models_f64.txt")
CPU = torch.device("cpu")
# the loci of periods 1-2, the ones the CPU's CLI runs take
CPU_LOCI = (0, 1, 6, 7)


def write_anchor_set(d: str) -> str:
    write_stutter_rich(d, stutter_rich_loci(**STUTTER_RICH_ANCHOR))
    with open(f"{d}/regions.bed") as fh:
        lines = fh.readlines()
    with open(f"{d}/cpu.bed", "w") as fh:
        fh.writelines(lines[i] for i in CPU_LOCI)
    return d


@pytest.fixture(scope="module")
def anchor_dir(tmp_path_factory):
    return write_anchor_set(str(tmp_path_factory.mktemp("stutter_rich")))


def cpu_chroms():
    locs = stutter_rich_loci(**STUTTER_RICH_ANCHOR)
    return {locs[i].chrom for i in CPU_LOCI}


def anchor_records(chroms):
    return [l for l in _body(ANCHOR_VCF) if l.split("\t", 1)[0] in chroms]


def anchor_models(chroms):
    return [l for l in open(ANCHOR_MODELS)
            if l.split("\t", 1)[0] in chroms]


def run_cpu_loci(d: str, name: str, extra) -> tuple:
    """The port's CLI on CPU_LOCI: (pipeline, counters, VCF body, models
    lines)."""
    vcf, models = f"{d}/{name}.vcf", f"{d}/{name}_models.txt"
    pipeline, counters = cli.run(
        stutter_rich_args(d, vcf, f"{d}/cpu.bed")
        + ["--device", "cpu", "--stutter-out", models] + extra)
    assert counters.genotype_fail == 0
    assert counters.genotype_success == len(CPU_LOCI)
    return pipeline, counters, _body(vcf), open(models).readlines()


def em_inputs(d: str):
    """Host-EM inputs (haploid, period, bps, log_p1, log_p2) of every
    locus, as processor.stutter_em_inputs stages them."""
    p = GenotyperPipeline(
        [f"{d}/sim.bam"], f"{d}/sim.fa",
        PipelineOptions(min_reads=15, use_unpaired=True,
                        snp_vcf=f"{d}/snps.vcf.gz"), Logger(quiet=True))
    out = []
    for region in read_regions(f"{d}/regions.bed", 1 << 30):
        prep = p.prepare_reads(region, p.fasta.get_sequence(region.chrom))
        inputs = p.stutter_em_inputs(prep.alns_by_rg, prep.log_p1s,
                                     prep.log_p2s, region)
        out.append((prep.haploid, region.period, *inputs))
    return out


@pytest.fixture(scope="module")
def raws(anchor_dir):
    return em_inputs(anchor_dir)


def test_anchor_covers_periods_1_to_6():
    want = _body(ANCHOR_VCF)
    assert len(want) == STUTTER_RICH_ANCHOR["n_loci"]
    periods = [int(l.split("PERIOD=")[1].split(";")[0]) for l in want]
    assert sorted(periods) == sorted(list(range(1, 7)) * 2)
    assert len(anchor_models(cpu_chroms())) == len(CPU_LOCI)


def test_generator_is_deterministic_and_writes_indel_cigars():
    a = stutter_rich_loci(**STUTTER_RICH_ANCHOR)
    assert a == stutter_rich_loci(**STUTTER_RICH_ANCHOR)
    for locus in a:
        ops = {op for rd in locus.reads for _, op in rd["cigar"]}
        assert ops == {"M", "I", "D"}, (locus.chrom, ops)


def test_every_locus_runs_the_em_loop(raws):
    """A >= 3 allele sizes and >= 3 EM iterations at every locus."""
    assert len(raws) == STUTTER_RICH_ANCHOR["n_loci"]
    for raw in raws:
        host = EMStutterGenotyper(*raw, 0)
        res = host.train()
        assert host.A >= 3, raw[1]
        assert res.num_iterations >= 3, raw[1]
        assert res.converged


def _train(raws):
    arrays, (_, _, Sm) = em_batched.pack_problems(
        [em_batched.EMProblem.build(*raw) for raw in raws])
    out = em_batched.em_train_batch(arrays, Sm, CPU, torch.float64)
    return arrays, Sm, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("sync_every", [4, 1])
def test_em_train_batch_matches_jax_and_host_em(raws, sync_every,
                                                monkeypatch):
    monkeypatch.setattr(em_batched, "SYNC_EVERY", sync_every)
    arrays, Sm, got = _train(raws)
    want = jax_em.em_train_batch(arrays, Sm, dtype_name="float64")
    np.testing.assert_allclose(got["params"], np.asarray(want["params"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["total_LL"], np.asarray(want["total_LL"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(want["converged"]))
    np.testing.assert_array_equal(got["iters"], np.asarray(want["iters"]))
    for g, raw in enumerate(raws):
        res = EMStutterGenotyper(*raw, 0).train()
        sm = res.stutter_model
        assert bool(got["converged"][g]) == res.converged
        assert int(got["iters"][g]) == res.num_iterations
        np.testing.assert_allclose(
            got["params"][g], [sm.in_geom, sm.in_up, sm.in_down,
                               sm.out_geom, sm.out_up, sm.out_down],
            rtol=1e-8, atol=1e-10)


def test_sequential_writes_the_anchor(anchor_dir):
    """--batch-loci 0 in float64: the host EM, K1 and K3's plain
    versions."""
    chroms = cpu_chroms()
    _, _, body, models = run_cpu_loci(
        anchor_dir, "sequential", ["--dtype", "float64", "--batch-loci",
                                   "0"])
    assert body == anchor_records(chroms)
    assert models == anchor_models(chroms)


def write_anchor() -> None:
    """Rewrite the anchor VCF body and models file from the JAX CLI."""
    with tempfile.TemporaryDirectory() as d:
        write_anchor_set(d)
        run_jax_cli(stutter_rich_args(d, f"{d}/jax.vcf")
                    + ["--dtype", "float64", "--stutter-out",
                       f"{d}/models.txt"])
        with open(ANCHOR_VCF, "w") as fh:
            fh.writelines(_body(f"{d}/jax.vcf"))
        with open(f"{d}/models.txt") as src, open(ANCHOR_MODELS, "w") as fh:
            fh.write(src.read())


if __name__ == "__main__":
    write_anchor()
    sys.exit(0)
