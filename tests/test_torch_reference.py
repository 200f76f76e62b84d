"""The cross-machine anchor tests/data/torch_port_ref_f64.vcf.

It is the VCF body `python -m hipstr_tpu.cli` writes in float64 on the CPU
for the seeded reference dataset (hipstr_tpu_torch.utils.simdata);
chip_smoke.py holds the port's float64 run on the card against it.  These
tests keep the file current with the JAX package and hold the port's CPU
run to it.
"""

import os

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.utils.simdata import (REFERENCE_ARGS, reference_loci,
                                            write_sim)

from test_torch_slice import ROOT, _body, _cli_args, run_jax_cli

REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")


def _reference_dir(tmp_path):
    d = str(tmp_path)
    write_sim(d, reference_loci())
    return d


def test_reference_vcf_is_current(tmp_path):
    d = _reference_dir(tmp_path)
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + ["--dtype", "float64"]
                + REFERENCE_ARGS)
    assert _body(f"{d}/jax.vcf") == _body(REF_VCF)


def test_port_cli_matches_reference_vcf(tmp_path):
    d = _reference_dir(tmp_path)
    pipeline, counters = cli.run(
        _cli_args(d, f"{d}/port.vcf")
        + ["--dtype", "float64", "--device", "cpu"] + REFERENCE_ARGS)
    assert counters.genotype_success == len(reference_loci())
    assert counters.genotype_fail == 0
    assert pipeline.last_run_stats["dispatches"] > 0
    assert _body(f"{d}/port.vcf") == _body(REF_VCF)
