"""The default path at cohort width: joint calls of 100 and 160 samples
without a stutter model, on stutter-rich reads with a phased SNP, held to
frozen float64 anchors from the JAX CLI.

utils.simdata.COHORT_ANCHOR is 6 loci (periods 1-6) x 100 samples x 20
reads of 100 bp, COHORT_WIDE 2 loci x 160 x 12, and COHORT_OVER the
COHORT_WIDE loci at 250 samples, whose pools overflow the largest P bucket
(1024): the JAX CLI fails both loci at packing, and so must the port.
(a) the anchors cover 100 and 160 samples and periods 1-6, the generator
    is deterministic, and every locus's pool and sample buckets are the
    ones the sets were chosen for;
(b) every anchor locus's stutter EM sees more than one allele size, and
    the port's host EM iterates as the JAX package's host EM does;
(c) the EM problems of both sets: the port's em_train_batch in float64 on
    the CPU against the JAX package's (rtol 1e-10) and its host EM
    (converged flags and iterations equal, parameters within rtol 1e-8);
(d) the fused posteriors at each COHORT_ANCHOR locus's real posterior
    meta (100 samples, up to 2000 reads) with seeded LLs: the port's
    batched_pool_posteriors against the JAX package's (rtol 1e-10), and
    the fields they print equal to those of the JAX package's host
    posteriors;
(e) COHORT_OVER fails both loci at the port's packing with the JAX
    package's messages.
No cohort locus goes through the port's CLI on the CPU: K1's plain
version costs minutes at P 512 and above.  chip_smoke.py phase 7f holds
the card's runs (batched, pooled, sequential, f64 and f32) to the anchors.

`PYTHONPATH=.:tests python tests/test_torch_cohort.py buckets` prints
each anchor locus's first-round buckets; `... test_torch_cohort.py
[cohort|cohort160|over ...]` rewrites the anchors from the JAX CLI on
the CPU in float64 (about 8, 2 and 1 minutes; the first peaks near 50 GB
of host memory): tests/data/torch_port_cohort_f64.vcf and
torch_port_cohort_models_f64.txt, torch_port_cohort160_f64.vcf and
torch_port_cohort160_models_f64.txt, and torch_port_cohort_over.json (the
summary counts, the error lines and the record count of the COHORT_OVER
run).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipstr_tpu.ops import em_batched as jax_em
from hipstr_tpu.ops import posteriors as jax_posteriors
from hipstr_tpu.ops.em import EMStutterGenotyper as JaxHostEM
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.ops import em_batched
from hipstr_tpu_torch.ops import posteriors
from hipstr_tpu_torch.ops.em import EMStutterGenotyper
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.pipeline.locus_host import LocusHost
from hipstr_tpu_torch.utils.simdata import (COHORT_ANCHOR, COHORT_OVER,
                                            COHORT_WIDE, stutter_rich_args,
                                            stutter_rich_loci,
                                            write_stutter_rich)

from chip_smoke import (locus_buckets, over_args, posterior_fields,
                        run_outcome)
from test_torch_slice import ROOT, _body, one_torch_thread  # noqa: F401
from test_torch_stutter_rich import em_inputs

DATA = os.path.join(ROOT, "tests", "data")
# name -> (the set, anchor VCF body, anchor models file, the JAX CLI's
# extra flags).  The JAX CLI's CPU dispatch of all six 100-sample loci at
# once took over 40 GB and was killed, so that anchor is written two loci
# a dispatch; each locus's record depends on its own reads only.
ANCHORS = {
    "cohort": (COHORT_ANCHOR, os.path.join(DATA, "torch_port_cohort_f64.vcf"),
               os.path.join(DATA, "torch_port_cohort_models_f64.txt"),
               ["--batch-loci", "2"]),
    "cohort160": (COHORT_WIDE,
                  os.path.join(DATA, "torch_port_cohort160_f64.vcf"),
                  os.path.join(DATA, "torch_port_cohort160_models_f64.txt"),
                  []),
}
OVER_JSON = os.path.join(DATA, "torch_port_cohort_over.json")
CPU = torch.device("cpu")
# the buckets (prepare_locus) every first-round locus of a set lands in
SET_BUCKETS = {"cohort": dict(P=1024, RD=4096, Sm=128),
               "cohort160": dict(P=1024, RD=4096, Sm=512)}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Each anchor set written to its own directory: name -> path."""
    out = {}
    for name, (spec, *_) in ANCHORS.items():
        d = str(tmp_path_factory.mktemp(name))
        write_stutter_rich(d, stutter_rich_loci(**spec))
        out[name] = d
    return out


class Staged(Exception):
    """Raised in place of the first batched dispatch."""


def first_round_items(argv):
    """The port's batched run through the CLI (`argv`, on the CPU; the
    fused posteriors' posterior meta packed) up to its first dispatch:
    every locus's LocusWorkItem as prepare_locus packed it for the first
    round, in BED order, each given the `region` and `genotyper` that
    pipeline/locus_host.py staged it from."""
    items, loci = [], {}
    stage = LocusHost._stage

    def recording_stage(host, idx, region, g, chrom_seq):
        loci[idx] = (region, g)
        stage(host, idx, region, g, chrom_seq)

    def grab(aligner):
        for group in aligner.groups.values():
            items.extend(group)
        raise Staged

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LocusHost, "_stage", recording_stage)
        mp.setattr(executor.BatchedAligner, "dispatch_all", grab)
        mp.setattr(executor, "device_post_enabled", lambda dev: True)
        with pytest.raises(Staged):
            cli.run(argv)
    for it in items:
        it.region, it.genotyper = loci[it.order]
    return sorted(items, key=lambda it: it.order)


def staged_items(d: str):
    """first_round_items of the cohort set in `d`, float64 in one process.
    The stutter models come from the host EM, as on the CPU's default
    path."""
    return first_round_items(stutter_rich_args(d, f"{d}/staged.vcf")
                             + ["--device", "cpu", "--dtype", "float64",
                                "--host-workers", "1"])


@pytest.fixture(scope="module")
def staged(sets):
    return {name: staged_items(d) for name, d in sets.items()}


@pytest.fixture(scope="module")
def raws(sets):
    return {name: em_inputs(d) for name, d in sets.items()}


@pytest.fixture(scope="module")
def jax_host_em(raws):
    """The JAX package's host EM trained on every locus of each set."""
    return {name: [JaxHostEM(*raw, 0).train() for raw in rs]
            for name, rs in raws.items()}


def test_anchors_cover_100_and_160_samples_and_periods_1_to_6():
    for name, (spec, vcf, models, _) in ANCHORS.items():
        body = _body(vcf)
        assert len(body) == spec["n_loci"], name
        assert {len(l.split("\t")) - 9 for l in body} == {spec["n_samples"]}
        periods = [int(l.split("PERIOD=")[1].split(";")[0]) for l in body]
        assert periods == [1 + i % 6 for i in range(spec["n_loci"])]
        assert len(open(models).readlines()) == spec["n_loci"]
    assert sorted(int(l.split("PERIOD=")[1].split(";")[0])
                  for l in _body(ANCHORS["cohort"][1])) == list(range(1, 7))


@pytest.mark.parametrize("name", ["cohort", "cohort160", "over"])
def test_generator_is_deterministic(name):
    spec = COHORT_OVER if name == "over" else ANCHORS[name][0]
    a = stutter_rich_loci(**spec)
    assert a == stutter_rich_loci(**spec)
    for locus in a:
        assert len(locus.sample_names) == spec["n_samples"]
        assert len(locus.reads) == spec["n_samples"] * spec[
            "reads_per_sample"]


@pytest.mark.parametrize("name", list(ANCHORS))
def test_every_locus_lands_in_the_cohort_buckets(staged, name):
    """First round: every locus staged, its pool in P 1024, its reads in
    RD 4096 and its samples in Sm 128 (100) or 512 (160)."""
    items = staged[name]
    assert len(items) == ANCHORS[name][0]["n_loci"]
    for it in items:
        b = locus_buckets(it.arrays, it.statics)
        assert {k: b[k] for k in SET_BUCKETS[name]} == SET_BUCKETS[name]


@pytest.mark.parametrize("name", list(ANCHORS))
def test_em_loop_runs_as_the_jax_host_em(raws, jax_host_em, name):
    """Every locus's EM sees several allele sizes, and the port's host EM
    iterates as the JAX package's host EM does."""
    port, jax = Counter(), Counter()
    for raw, ref in zip(raws[name], jax_host_em[name]):
        ours = EMStutterGenotyper(*raw, 0)
        res = ours.train()
        assert ours.A > 1, raw[1]
        assert res.converged == ref.converged
        port[res.num_iterations] += 1
        jax[ref.num_iterations] += 1
    assert port == jax
    assert min(port) >= 3


@pytest.mark.parametrize("name", list(ANCHORS))
def test_em_train_batch_matches_jax_and_host_em(raws, jax_host_em, name):
    arrays, (_, _, Sm) = em_batched.pack_problems(
        [em_batched.EMProblem.build(*raw) for raw in raws[name]])
    got = {k: v.numpy() for k, v in em_batched.em_train_batch(
        arrays, Sm, CPU, torch.float64).items()}
    want = jax_em.em_train_batch(arrays, Sm, dtype_name="float64")
    np.testing.assert_allclose(got["params"], np.asarray(want["params"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["total_LL"], np.asarray(want["total_LL"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(want["converged"]))
    np.testing.assert_array_equal(got["iters"], np.asarray(want["iters"]))
    for g, host in enumerate(jax_host_em[name]):
        sm = host.stutter_model
        assert bool(got["converged"][g]) == host.converged
        assert int(got["iters"][g]) == host.num_iterations
        np.testing.assert_allclose(
            got["params"][g], [sm.in_geom, sm.in_up, sm.in_down,
                               sm.out_geom, sm.out_up, sm.out_down],
            rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("locus", range(COHORT_ANCHOR["n_loci"]))
def test_fused_posteriors_match_jax_and_print_as_the_host(staged, locus):
    """One COHORT_ANCHOR locus's real posterior meta (100 samples) with
    seeded pool LLs: the port's fused posteriors against the JAX
    package's (rtol 1e-10), and every field they print equal to the JAX
    package's host posteriors' (sample_posteriors over the genotyper's
    reads, np.add.at's order)."""
    it = staged["cohort"][locus]
    g, pm, Sm = it.genotyper, it.arrays[7], it.statics[7]
    P_pad, H_pad = it.arrays[5].shape[0], it.arrays[4].seed_char.shape[0]
    (P, H), A, S = it.statics[5:7], g.num_alleles, g.num_samples
    LL = np.random.default_rng(57000 + locus).uniform(-60.0, -1.0,
                                                      (1, P_pad, H_pad))
    log_post, totals = posteriors.batched_pool_posteriors(
        torch.from_numpy(LL), {k: torch.from_numpy(np.asarray(v)[None])
                               for k, v in pm.items()}, Sm, torch.float64)
    want_post, want_tot = jax_posteriors.batched_pool_posteriors(
        jnp, jnp.asarray(LL), {k: jnp.asarray(np.asarray(v)[None])
                               for k, v in pm.items()}, Sm, jnp.float64)
    # tests/test_torch_posteriors.py's tolerance: the normalising
    # logsumexp is reduced in another order by XLA, and a log posterior
    # near 0 keeps that ulp of its ~1e3 total as absolute error
    np.testing.assert_allclose(log_post.numpy(), np.asarray(want_post),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(totals.numpy(), np.asarray(want_tot),
                               rtol=1e-10, atol=1e-10)
    g.set_pool_lls(LL[0, :P, :H])
    h_post, h_tot, _ = jax_posteriors.sample_posteriors(
        np, g.log_aln_probs, g.log_p1, g.log_p2, g.read_weights,
        g.sample_label, S, jax_posteriors.log_genotype_priors(
            np, A, g.haploid))
    assert posterior_fields(log_post[0, :S, :A, :A].numpy(),
                            totals[0, :S].numpy(), A, g.haploid,
                            posteriors.extract_genotypes) == \
        posterior_fields(h_post, h_tot, A, g.haploid,
                         jax_posteriors.extract_genotypes)


@pytest.mark.parametrize("locus", range(COHORT_ANCHOR["n_loci"]))
def test_per_sample_sums_add_reads_in_the_host_order(staged, locus):
    """The fused posteriors' per-sample sums at a COHORT_ANCHOR locus's
    real posterior meta (100 samples, padded to RD 4096), on per-read
    cells from seeded LLs: bit-equal to the host posteriors' np.add.at
    over the real reads, each sample's reads in order (a one-hot matrix
    product rounds some cells differently)."""
    it = staged["cohort"][locus]
    pm, Sm, n = it.arrays[7], it.statics[7], it.genotyper.num_reads
    R, C = pm["sample"].shape[0], 1024
    contrib = np.random.default_rng(58000 + locus).uniform(-90.0, -1.0,
                                                           (1, R, C))
    contrib[0, n:] *= pm["weights"][n:, None]      # the padding's zeros
    got = posteriors.sample_sums(torch.from_numpy(contrib),
                                 torch.from_numpy(pm["sample"][None]),
                                 torch.from_numpy(pm["weights"][None]), Sm)
    want = np.zeros((Sm, C))
    np.add.at(want, pm["sample"][:n], contrib[0, :n])
    assert np.array_equal(got[0].numpy(), want)


def test_over_fails_both_loci_at_packing_as_the_jax_cli(tmp_path):
    """250 samples: both pools over P's top bucket (1024), as the JAX CLI
    found (tests/data/torch_port_cohort_over.json)."""
    d = str(tmp_path)
    write_stutter_rich(d, stutter_rich_loci(**COHORT_OVER))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(over_args(d, f"{d}/over.vcf")
                      + ["--device", "cpu", "--dtype", "float64",
                         "--host-workers", "1"])
    assert rc == 0
    got = run_outcome(err.getvalue(), f"{d}/over.vcf")
    want = json.load(open(OVER_JSON))
    assert want["summary"]["fail"] == 2 and want["records"] == 0
    assert all("exceeds largest bucket 1024" in e for e in want["errors"])
    assert got == want


def jax_cli(args) -> str:
    """`python -m hipstr_tpu.cli` on the CPU in float64 (as
    test_torch_slice.run_jax_cli, with a longer limit): its stderr."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               HIPSTR_TPU_COMPILE_CACHE="")
    proc = subprocess.run([sys.executable, "-m", "hipstr_tpu.cli", *args,
                           "--dtype", "float64"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def write_anchor(name: str) -> None:
    """Rewrite one anchor from the JAX CLI on the CPU in float64."""
    with tempfile.TemporaryDirectory() as d:
        if name == "over":
            write_stutter_rich(d, stutter_rich_loci(**COHORT_OVER))
            err = jax_cli(over_args(d, f"{d}/jax.vcf"))
            with open(OVER_JSON, "w") as fh:
                json.dump(run_outcome(err, f"{d}/jax.vcf"), fh, indent=1)
                fh.write("\n")
            return
        spec, vcf, models, extra = ANCHORS[name]
        write_stutter_rich(d, stutter_rich_loci(**spec))
        jax_cli(stutter_rich_args(d, f"{d}/jax.vcf")
                + ["--stutter-out", f"{d}/models.txt"] + extra)
        with open(vcf, "w") as fh:
            fh.writelines(_body(f"{d}/jax.vcf"))
        with open(f"{d}/models.txt") as src, open(models, "w") as fh:
            fh.write(src.read())


def print_buckets() -> None:
    """Each anchor locus's first-round buckets (prepare_locus on the CPU)
    and its real pool and haplotype counts."""
    for name, (spec, *_) in ANCHORS.items():
        with tempfile.TemporaryDirectory() as d:
            write_stutter_rich(d, stutter_rich_loci(**spec))
            for it in staged_items(d):
                print(name, it.region, locus_buckets(it.arrays, it.statics),
                      dict(P_real=it.statics[5], H_real=it.statics[6]))


if __name__ == "__main__":
    if sys.argv[1:] == ["buckets"]:
        print_buckets()
        sys.exit(0)
    for name in sys.argv[1:] or ["cohort", "cohort160", "over"]:
        write_anchor(name)
    sys.exit(0)
