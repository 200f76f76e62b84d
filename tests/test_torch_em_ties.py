"""Printed-float ties: the port's float64 device paths against the host's
order of operations.

The VCF prints the learned stutter parameters and the posterior fields at
`{x:.2f}`, so a value computed in another order than the host's can land
one ulp across a tie and print differently.
* the device EM (ops/em_batched.py) sums each artifact category's
  pseudocounts in the same logsumexp as its read weights, as the host EM
  does: on loci whose model is the pseudocounts alone its six parameters,
  convergence and iteration count equal those of the JAX package's host EM
  (hipstr_tpu/ops/em.py, the JAX CLI's float64 EM) bit for bit (n = 35 and
  n = 195 EM reads, 1/(n + 5) = 0.025 and 0.005);
* the stutter-free locus chrP8b of utils.simdata.period_loci (35 EM
  reads): the JAX package's host EM on its EM problem learns the tie and
  prints it as tests/data/torch_port_periods_f64.vcf does, and the port's
  device EM learns it bit for bit (tests/test_torch_periods.py holds the
  card's batched path, forced on the CPU, to that anchor's chrP8b record);
* the fused posteriors (ops/posteriors.py) on reads that do not tell the
  alleles apart, so every posterior is a ratio of priors (A = 2-5,
  diploid and haploid): every field the VCF prints from them equals the
  one the JAX package's host posteriors print (hipstr_tpu/ops/posteriors.py:
  sample_posteriors with np.add.at, log_genotype_priors,
  extract_genotypes).
"""

import pytest
import torch

import chip_smoke
from hipstr_tpu.ops import posteriors as jax_host_posteriors
from hipstr_tpu.ops.em import EMStutterGenotyper
from hipstr_tpu_torch.io.regions import read_regions
from hipstr_tpu_torch.ops import em_batched
from hipstr_tpu_torch.utils.simdata import (period_loci,
                                            stutter_free_problems, write_sim)

from test_torch_periods import PERIODS_VCF
from test_torch_slice import _body, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TIE_LOCUS = "chrP8b"


@pytest.mark.parametrize("case", [0, 1], ids=["n35", "n195"])
def test_pseudocount_models_bit_equal_to_host_em(case):
    """The port's em_train_batch in float64 against the JAX package's host
    EM on the same problem: six parameters, convergence and iterations."""
    raw = stutter_free_problems()[case]
    arrays, (_, _, Sm) = em_batched.pack_problems(
        [em_batched.EMProblem.build(*raw)])
    got = em_batched.em_train_batch(arrays, Sm, CPU, torch.float64)
    host = EMStutterGenotyper(*raw, 0).train()
    sm = host.stutter_model
    want = [sm.in_geom, sm.in_up, sm.in_down, sm.out_geom, sm.out_up,
            sm.out_down]
    n = len(raw[2][0])
    assert want[1] == pytest.approx(1 / (n + 5), rel=1e-14)
    assert got["params"][0].tolist() == want
    assert bool(got["converged"][0]) == host.converged
    assert int(got["iters"][0]) == host.num_iterations


@pytest.fixture(scope="module")
def tie_problem(tmp_path_factory):
    """chrP8b's host-EM inputs, as the batched run stages them, and the JAX
    package's host EM trained on them."""
    d = str(tmp_path_factory.mktemp("periods"))
    write_sim(d, period_loci())
    regions = read_regions(f"{d}/regions.bed", 1 << 30)
    i = [r.chrom for r in regions].index(TIE_LOCUS)
    _, raw = chip_smoke.em_problems(d, len(regions))[i]
    return raw, EMStutterGenotyper(*raw, 0).train()


@pytest.mark.parametrize("learner", ["jax_host_em", "device_em"])
def test_p8b_learns_the_pseudocount_tie(tie_problem, learner):
    """chrP8b's model is the pseudocounts of its 35 EM reads, 1/40, a tie
    of the VCF's {x:.2f}: the JAX package's host EM prints it as the
    periods anchor does (0.03), and the port's device EM in float64
    learns its six parameters, convergence and iterations bit for bit."""
    raw, host = tie_problem
    sm = host.stutter_model
    want = [sm.in_geom, sm.in_up, sm.in_down, sm.out_geom, sm.out_up,
            sm.out_down]
    if learner == "jax_host_em":
        assert sum(map(len, raw[2])) == 35
        assert want[1] == pytest.approx(1 / 40)
        record, = [l for l in _body(PERIODS_VCF)
                   if l.startswith(TIE_LOCUS + "\t")]
        info = dict(kv.split("=") for kv in record.split("\t")[7].split(";"))
        assert [info[k] for k in (
            "INFRAME_PGEOM", "INFRAME_UP", "INFRAME_DOWN", "OUTFRAME_PGEOM",
            "OUTFRAME_UP", "OUTFRAME_DOWN")] == [f"{x:.2f}" for x in want]
        assert info["INFRAME_UP"] == "0.03"
        return
    arrays, (_, _, Sm) = em_batched.pack_problems(
        [em_batched.EMProblem.build(*raw)])
    got = em_batched.em_train_batch(arrays, Sm, CPU, torch.float64)
    assert got["params"][0].tolist() == want
    assert bool(got["converged"][0]) == host.converged
    assert int(got["iters"][0]) == host.num_iterations


# ------------------------------------------------ posteriors at prior ratios
@pytest.mark.parametrize("haploid", [False, True], ids=["diploid",
                                                         "haploid"])
@pytest.mark.parametrize("A", [2, 3, 4, 5])
def test_fused_posteriors_at_prior_ratios_print_as_the_host(A, haploid):
    """Reads whose LL is the same for every haplotype
    (chip_smoke.prior_ratio_case): every genotype's posterior is its prior
    over their sum.  The port's fused posteriors in float64 (a one-hot
    contraction over the reads), extracted as the port's record does,
    print every field as the JAX package's host posteriors (np.add.at in
    read order); chip_smoke phase 8b runs the same check on the card,
    against the port's copy of that host code."""
    got, want, diff = chip_smoke.prior_ratio_posteriors(
        A, haploid, CPU, host=jax_host_posteriors)
    assert got == want
    assert diff < 1e-12

