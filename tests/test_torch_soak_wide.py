"""The user's default run on the soak's phased-SNP loci: no stutter model,
wide unfused first rounds at periods 1-4, held to frozen float64 anchors
from the JAX CLI.

utils.simdata.SOAK_WIDE is the soak's own 4-locus prefix (tools.soak's
dataset, soak_locus(i, 20, 30) for i = 0..3: periods 1-4, 20 samples x 30
reads, a phased SNP 20 bp from each repeat).  Each locus's first round is
its speculative superset of 60-80 haplotypes, so it lands at H_pad 64 or
128, past the fused posteriors' cutoff (32): the host computes its
posteriors from the fetched LLs.
Both anchors cover periods 1-4, and the default model's first two records
are those of tests/data/torch_port_soak_f64.vcf.
(a) every locus's first-round buckets, from the genotyper's first
    haplotype set and prepare_locus (no alignment): H_pad 64 or 128, both
    present, as `buckets` printed them;
(b) the port's host EM (ops/em.py) on the four loci's EM problems writes
    the anchor's models file, text for text;
(c) the port's CLI in float64 on the CPU, batched without a model on the
    card's code path (the device EM and the fused posteriors forced on
    the CPU, their plain versions), on chrS3 alone (period 4, a first
    round at H_pad 128): its record byte-identical to the anchor's.
The other loci and modes cost ~50 s a locus here (1024-read pools
through K1's and K2's plain versions), so the card holds them:
chip_smoke.py phase 13d runs both anchors batched, pooled and sequential
in float64 and batched in float32.

`PYTHONPATH=.:tests python tests/test_torch_soak_wide.py buckets` runs
the port on the four loci on the CPU in float64 (the card's code path
forced) and prints each locus's H_real, H_pad, P, L and O for each
device round, and whether the round's posteriors were fused.
`... test_torch_soak_wide.py [em|model ...]` rewrites the anchors from
the JAX CLI on the CPU in float64 (about 200 s each, ~7 GB):
tests/data/torch_port_soak_em_f64.vcf with
torch_port_soak_em_models_f64.txt (no stutter model: the host EM), and
torch_port_soak4_f64.vcf (the default model, as tools/soak.py:run sets
it up).  They are written by its sequential run (--batch-loci 0): its
batched run wrote the same bodies, but on these loci it failed in 3 of 5
runs, one a SIGSEGV (likely the JAX package's ML-trace prefetch race,
which the port repaired).
"""

import io
import os
import sys
import tempfile

import pytest

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.io.regions import read_regions
from hipstr_tpu_torch.models.stutter import write_stutter_models
from hipstr_tpu_torch.ops.em import EMStutterGenotyper
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.tools import soak
from hipstr_tpu_torch.utils.simdata import (SOAK_MODEL_ARGS, SOAK_WIDE,
                                            soak_em_args)

from chip_smoke import DispatchLog, em_problems, locus_buckets
from test_torch_cohort import first_round_items, jax_cli
from test_torch_golden_a import card_em_rule
from test_torch_slice import ROOT, _body, one_torch_thread  # noqa: F401

DATA = os.path.join(ROOT, "tests", "data")
EM_VCF = os.path.join(DATA, "torch_port_soak_em_f64.vcf")
EM_MODELS = os.path.join(DATA, "torch_port_soak_em_models_f64.txt")
MODEL_VCF = os.path.join(DATA, "torch_port_soak4_f64.vcf")
SOAK_VCF = os.path.join(DATA, "torch_port_soak_f64.vcf")
# name -> (anchor VCF body, models file or None, the JAX CLI's extra
# flags)
ANCHORS = {"em": (EM_VCF, EM_MODELS, ["--batch-loci", "0"]),
           "model": (MODEL_VCF, None, SOAK_MODEL_ARGS
                     + ["--batch-loci", "0"])}
N = SOAK_WIDE["n_loci"]
F64_CPU = ["--dtype", "float64", "--device", "cpu"]


def write_dataset(d: str) -> str:
    soak.generate(d, N, SOAK_WIDE["n_samples"], SOAK_WIDE["reads"],
                  log=lambda msg: None)
    return d


@pytest.fixture(scope="module")
def soak_dir(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("soak_wide")))


def first_rounds(d: str):
    """The port's batched run on the CPU (float64, the card's code path)
    up to its first dispatch: every locus's LocusWorkItem as prepare_locus
    packed it from the genotyper's first haplotype set, in BED order."""
    return first_round_items(soak_em_args(d, f"{d}/staged.vcf") + F64_CPU
                             + ["--host-workers", "1"])


def test_anchors_cover_periods_1_to_4():
    """Both anchors: chrS0-chrS3 at periods 1-4; the default model's first
    two records are tests/data/torch_port_soak_f64.vcf's (the JAX
    package's run_batched, as tools/soak.py:run calls it)."""
    em, model = _body(EM_VCF), _body(MODEL_VCF)
    for body in (em, model):
        assert [l.split("\t")[0] for l in body] == [f"chrS{i}"
                                                    for i in range(N)]
        assert [int(l.split("PERIOD=")[1].split(";")[0])
                for l in body] == [1, 2, 3, 4]
    assert model[:2] == _body(SOAK_VCF)
    assert len(open(EM_MODELS).readlines()) == N


def test_first_rounds_are_wide_and_unfused(soak_dir):
    """Every locus's first round past the fused posteriors' cutoff (H_pad
    32), at H_pad 64 or 128, both present: the speculative superset of
    60-80 haplotypes (`buckets`: H_real 60, 80, 80, 80)."""
    items = first_rounds(soak_dir)
    assert [it.region.chrom for it in items] == [f"chrS{i}"
                                                 for i in range(N)]
    h_pad = [locus_buckets(it.arrays, it.statics)["H_pad"] for it in items]
    assert set(h_pad) == {64, 128}, h_pad
    for it, h in zip(items, h_pad):
        assert 32 < h and h // 2 < it.statics[6] <= h, (it.region, h)
        assert it.statics[7] is None     # no posterior meta: not fused


def test_host_em_writes_the_models_anchor(soak_dir):
    """No alignment: the four loci's EM problems as the CLI stages them,
    the port's host EM, written as --stutter-out writes them."""
    regions = read_regions(f"{soak_dir}/regions.bed", N)
    models = {}
    for region, (_, raw) in zip(regions, em_problems(
            soak_dir, N, f"{soak_dir}/snps.vcf")):
        em = EMStutterGenotyper(*raw, 0)
        res = em.train()
        assert res.converged
        models[(region.chrom, region.start, region.stop)] = \
            res.stutter_model
    text = io.StringIO()
    write_stutter_models(models, text)
    assert text.getvalue() == open(EM_MODELS).read()


def test_card_path_writes_the_period_4_record(soak_dir, monkeypatch):
    """chrS3 alone (period 4: one device round, unfused at H_pad 128; the
    speculative column gather serves its later allele rounds) through the
    port's CLI without a model, the card's batched code path forced on the
    CPU: one device EM wave, the anchor's record."""
    d = soak_dir
    monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
    monkeypatch.setattr(executor, "device_post_enabled", lambda dev: True)
    with open(f"{d}/regions.bed") as src, open(f"{d}/chrS3.bed", "w") as fh:
        fh.write(src.readlines()[3])
    bed = f"{d}/chrS3.bed"
    pipeline, counters = cli.run(
        soak_em_args(d, f"{d}/chrS3.vcf", bed) + F64_CPU
        + ["--host-workers", "1"])
    assert pipeline.last_run_stats["em_waves"] == 1
    assert (counters.genotype_success, counters.genotype_fail) == (1, 0)
    want = [l for l in _body(EM_VCF) if l.startswith("chrS3\t")]
    assert _body(f"{d}/chrS3.vcf") == want


def print_buckets() -> None:
    """Each locus's device rounds on the CPU (the card's code path, float64,
    one locus a dispatch): H_real, H_pad, P, L, O, fused or not."""
    with tempfile.TemporaryDirectory() as d, \
            pytest.MonkeyPatch.context() as mp, DispatchLog() as dl:
        write_dataset(d)
        mp.setattr(executor, "device_em_enabled", card_em_rule)
        mp.setattr(executor, "device_post_enabled", lambda dev: True)
        cli.run(soak_em_args(d, f"{d}/out.vcf") + F64_CPU
                + ["--host-workers", "1", "--batch-loci", "1"])
    rounds = {}
    for order, h_real, fused, b in dl.locus_rounds:
        rounds.setdefault(order, []).append(
            dict(H_real=h_real, **{k: b[k] for k in ("H_pad", "P", "L",
                                                      "O")},
                 fused=fused))
    for order in sorted(rounds):
        for i, r in enumerate(rounds[order]):
            print(f"chrS{order} round {i}: {r}")


def write_anchor(name: str) -> None:
    """Rewrite one anchor from the JAX CLI on the CPU in float64."""
    vcf, models, extra = ANCHORS[name]
    with tempfile.TemporaryDirectory() as d:
        write_dataset(d)
        out = ["--stutter-out", f"{d}/models.txt"] if models else []
        jax_cli(soak_em_args(d, f"{d}/jax.vcf") + out + extra)
        with open(vcf, "w") as fh:
            fh.writelines(_body(f"{d}/jax.vcf"))
        if models:
            with open(f"{d}/models.txt") as src, open(models, "w") as fh:
                fh.write(src.read())


if __name__ == "__main__":
    if sys.argv[1:] == ["buckets"]:
        print_buckets()
        sys.exit(0)
    for name in sys.argv[1:] or list(ANCHORS):
        write_anchor(name)
    sys.exit(0)
