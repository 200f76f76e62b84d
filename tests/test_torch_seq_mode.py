"""The sequential path's per-locus mode (`--batch-loci 0`): fused, K1 + K3.

* the port's CLI with `--batch-loci 0 --device cpu` in float64 on the
  `default` golden configuration reaches `ops/hmm_scan.segment_scan` (K3's
  wrapper) twice per aligner call and `flank_scan` (K4's) never, and
  writes the body of tests/data/torch_port_golden_default_f64.vcf, the
  JAX CLI's float64 output (the anchor stands for a JAX run here);
* the same run in flank mode, through chip_smoke's `flank_mode` (the
  wrapper phase 6 times it with on the card), reaches `flank_scan` four
  times per aligner call and `segment_scan` never, and writes the same
  body;
* the mode is set in one place: `compute_hap_log_likelihoods`'s default
  is "fused" and `ops/hmm.segment_forward`/`hmm_forward` have none.
tests/test_torch_hmm_scan.py holds both modes' `hmm_forward` to the JAX
package's.
"""

import contextlib
import inspect
import os

import numpy as np
import pytest

import chip_smoke
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.ops import hmm, hmm_scan
from hipstr_tpu_torch.pipeline import hap_aligner
from hipstr_tpu_torch.utils.simdata import (GOLDEN_CONFIGS, golden_args,
                                            write_golden)
from tests.test_hmm_kernel import _mk_haplotype, _reads_from_hap

from test_torch_slice import ROOT, _body, one_torch_thread  # noqa: F401

ANCHOR = os.path.join(ROOT, "tests", "data",
                      "torch_port_golden_default_f64.vcf")


@pytest.fixture(scope="module")
def default_dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seq_mode"))
    write_golden(d, **GOLDEN_CONFIGS["default"][0])
    return d


def counted(monkeypatch, name: str, calls: dict):
    """Count the calls of hmm_scan.`name` (segment_forward imports the
    wrappers from the module at each call)."""
    orig = getattr(hmm_scan, name)

    def wrapper(*args, **kwargs):
        calls[name] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(hmm_scan, name, wrapper)


@pytest.mark.parametrize("mode", ["fused", "flank"])
def test_sequential_cli_mode_writes_the_golden_anchor(default_dataset, mode,
                                                      monkeypatch):
    calls = dict(segment_scan=0, flank_scan=0)
    for name in calls:
        counted(monkeypatch, name, calls)
    out = f"{default_dataset}/seq_{mode}.vcf"
    calls0 = hap_aligner.CALLS
    with (chip_smoke.flank_mode() if mode == "flank"
          else contextlib.nullcontext()):
        _, counters = cli.run(golden_args("default", default_dataset, out)
                              + ["--dtype", "float64", "--device", "cpu",
                                 "--batch-loci", "0"])
    n = hap_aligner.CALLS - calls0
    assert counters.genotype_fail == 0 and counters.genotype_success > 0
    assert n >= counters.genotype_success
    # fused: one K3 an orientation; flank: two K4 (the rows before and
    # after the repeat block), as chip_smoke counts the card's launches
    want = chip_smoke.want_launches(mode, n)
    assert calls == {k: want[k] for k in calls}
    assert _body(out) == _body(ANCHOR)


def test_one_default_mode():
    def default(fn):
        return inspect.signature(fn).parameters["mode"].default

    assert default(hap_aligner.compute_hap_log_likelihoods) == "fused"
    assert default(hmm.hmm_forward) is inspect.Parameter.empty
    assert default(hmm.segment_forward) is inspect.Parameter.empty


def test_the_aligner_runs_its_default(monkeypatch):
    """compute_hap_log_likelihoods without a mode runs hmm_forward in
    fused mode, whose LL equals flank mode's within 1e-8 (chip_smoke's
    MODES_TOL)."""
    rng = np.random.default_rng(11)
    hap = _mk_haplotype(rng, 2, 5)
    seqs, quals, seeds = _reads_from_hap(rng, hap, 3, 30)
    seen, orig = [], hap_aligner.hmm_forward

    def spy(*args, **kwargs):
        seen.append(kwargs["mode"])
        return orig(*args, **kwargs)

    monkeypatch.setattr(hap_aligner, "hmm_forward", spy)
    got = hap_aligner.compute_hap_log_likelihoods(hap, seqs, quals, seeds,
                                                  dtype="float64",
                                                  device="cpu")
    flank = hap_aligner.compute_hap_log_likelihoods(
        hap, seqs, quals, seeds, dtype="float64", device="cpu", mode="flank")
    assert seen == ["fused", "flank"]
    np.testing.assert_allclose(got, flank, rtol=chip_smoke.MODES_TOL,
                               atol=chip_smoke.MODES_TOL)
