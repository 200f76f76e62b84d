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
* the stutter-free locus of utils.simdata.em_tie_loci (35 EM reads): the
  anchor tests/data/torch_port_em_tie_f64.vcf is the JAX CLI's float64
  body, and the card's batched path (device EM and fused posteriors)
  forced on the CPU writes it;
* the fused posteriors (ops/posteriors.py) on reads that do not tell the
  alleles apart, so every posterior is a ratio of priors (A = 2-5,
  diploid and haploid): every field the VCF prints from them equals the
  one the JAX package's host posteriors print (hipstr_tpu/ops/posteriors.py:
  sample_posteriors with np.add.at, log_genotype_priors,
  extract_genotypes).

`PYTHONPATH=.:tests python tests/test_torch_em_ties.py` rewrites the
anchor from the JAX CLI.
"""

import os
import sys
import tempfile

import pytest
import torch

import chip_smoke
from hipstr_tpu.ops import posteriors as jax_host_posteriors
from hipstr_tpu.ops.em import EMStutterGenotyper
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.ops import em_batched
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.utils.simdata import (LEARN_ARGS, em_tie_loci,
                                            stutter_free_problems, write_sim)

from test_torch_golden_a import card_em_rule
from test_torch_slice import (ROOT, _body, _cli_args,  # noqa: F401
                              one_torch_thread, run_jax_cli)

CPU = torch.device("cpu")
TIE_VCF = os.path.join(ROOT, "tests", "data", "torch_port_em_tie_f64.vcf")
TIE_ARGS = LEARN_ARGS + ["--dtype", "float64"]


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
def tie_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("em_tie"))
    write_sim(d, em_tie_loci())
    return d


def test_em_tie_anchor_is_current(tie_dir):
    d = tie_dir
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + TIE_ARGS)
    want = _body(TIE_VCF)
    assert len(want) == 1 and "INFRAME_UP=0.03;" in want[0]
    assert _body(f"{d}/jax.vcf") == want


def test_device_em_prints_the_tie_as_the_host(tie_dir, monkeypatch):
    """The card's batched path forced on the CPU in float64: one device EM
    wave, the anchor's body."""
    d = tie_dir
    monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
    monkeypatch.setattr(executor, "device_post_enabled", lambda dev: True)
    pipeline, counters = cli.run(
        _cli_args(d, f"{d}/dev.vcf") + TIE_ARGS
        + ["--device", "cpu", "--host-workers", "1"])
    assert pipeline.last_run_stats["em_waves"] == 1
    assert counters.genotype_success == 1 and counters.genotype_fail == 0
    assert _body(f"{d}/dev.vcf") == _body(TIE_VCF)


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


def write_anchor() -> None:
    """Rewrite tests/data/torch_port_em_tie_f64.vcf from the JAX CLI."""
    with tempfile.TemporaryDirectory() as d:
        write_sim(d, em_tie_loci())
        run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + TIE_ARGS)
        with open(TIE_VCF, "w") as fh:
            fh.writelines(_body(f"{d}/jax.vcf"))


if __name__ == "__main__":
    write_anchor()
    sys.exit(0)
