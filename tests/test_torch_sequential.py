"""The port's sequential path (`--batch-loci 0`) against the JAX package.

* `python -m hipstr_tpu_torch.cli --device cpu --batch-loci 0`, with JAX
  blocked, writes the same VCF body as `python -m hipstr_tpu.cli
  --batch-loci 0` in float64 on the CPU: once with `--def-stutter-model`,
  once without a model (the host stutter EM), where the `--stutter-out`
  files are equal too;
* in-process `run_sequential`, and `--host-workers 3` with `--batch-loci
  0` (which runs sequentially, as in the JAX CLI), write that VCF as well;
* faults: the aligner has no CPU default device; a DeviceError ends the
  run; a host error fails one locus and the run goes on; the run refuses a
  genotyper bound to the JAX aligner.

In this pytest session JAX is loaded (conftest), so the genotyper binds
the JAX aligner; the in-process tests bind the port's with monkeypatch.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hipstr_tpu.utils.simulate import simulate_locus
from hipstr_tpu_torch import cli
from hipstr_tpu_torch.kernels import DeviceError
from hipstr_tpu_torch.pipeline import hap_aligner, sequential
from hipstr_tpu_torch.utils.simdata import write_sim
from tests.test_hmm_kernel import _mk_haplotype, _reads_from_hap
from test_torch_slice import (ONE_THREAD, ROOT, _body, _cli_args, _pipeline,
                              one_torch_thread, run_jax_cli)  # noqa: F401

CPU = torch.device("cpu")
GENOTYPER = "hipstr_tpu.pipeline.genotyper"
# the options of test_torch_slice._opts() on the command line, sequential
SEQ_ARGS = ["--min-reads", "12", "--use-unpaired", "--def-stutter-model",
            "--dtype", "float64", "--batch-loci", "0"]
# no model: the host EM; 4 samples x 30 reads of one period-3 locus
# converge (tests/test_cli_modes.py::test_stutter_out_in_roundtrip)
EM_ARGS = ["--min-reads", "20", "--use-unpaired", "--dtype", "float64",
           "--batch-loci", "0"]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """4 loci, 2 samples x 20 reads, periods 2-3, and the VCF body of
    hipstr_tpu's sequential run on them in float64 on the CPU."""
    d = str(tmp_path_factory.mktemp("torch_seq"))
    write_sim(d, [simulate_locus(seed=900 + i, n_samples=2,
                                 reads_per_sample=20, period=2 + i % 2,
                                 ref_units=8, chrom=f"chrT{i}")
                  for i in range(4)])
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + SEQ_ARGS)
    return d, _body(f"{d}/jax.vcf")


@pytest.fixture(scope="module")
def em_sim(tmp_path_factory):
    """One locus for the host EM and hipstr_tpu's sequential outputs."""
    d = str(tmp_path_factory.mktemp("torch_seq_em"))
    write_sim(d, [simulate_locus(seed=207, n_samples=4, reads_per_sample=30,
                                 period=3, ref_units=8)])
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + EM_ARGS
                + ["--stutter-out", f"{d}/jax.stutter"])
    return d, _body(f"{d}/jax.vcf")


@pytest.fixture
def port_binding(monkeypatch):
    """Bind the genotyper to the port's aligner, as host.py does where JAX
    is not loaded."""
    monkeypatch.setattr(sys.modules[GENOTYPER], "compute_hap_log_likelihoods",
                        hap_aligner.compute_hap_log_likelihoods)


def _run_port_cli_without_jax(args):
    script = ("import sys; sys.modules['jax'] = None\n"
              "from hipstr_tpu_torch.cli import main\n"
              "rc = main(sys.argv[1:])\n"
              "aligner = sys.modules['hipstr_tpu.pipeline.hap_aligner']\n"
              "assert aligner.__name__ == "
              "'hipstr_tpu_torch.pipeline.hap_aligner', aligner.__name__\n"
              "assert aligner.CALLS > 0\n"
              "assert not [m for m in sys.modules if m.startswith('jax')\n"
              "            and sys.modules[m] is not None]\n"
              "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", script, *args,
                           "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fail=0" in proc.stderr, proc.stderr[-3000:]


@pytest.mark.parametrize("model", ["def-stutter-model", "host-em"])
def test_cli_sequential_vcf_equals_jax(model, request):
    if model == "host-em":
        d, want = request.getfixturevalue("em_sim")
        extra = EM_ARGS + ["--stutter-out", f"{d}/port.stutter"]
    else:
        d, want = request.getfixturevalue("sim")
        extra = SEQ_ARGS
    args = _cli_args(d, f"{d}/port.vcf") + extra
    _run_port_cli_without_jax([a for a in args if a != "--silent"])
    assert want and _body(f"{d}/port.vcf") == want
    if model == "host-em":
        assert open(f"{d}/port.stutter").read() == \
            open(f"{d}/jax.stutter").read()


def test_run_sequential_vcf_equals_jax(sim, port_binding):
    d, want = sim
    calls = hap_aligner.CALLS
    counters = sequential.run_sequential(_pipeline(d), f"{d}/regions.bed",
                                         f"{d}/inproc.vcf", CPU)
    assert counters.genotype_success == 4 and counters.genotype_fail == 0
    assert hap_aligner.CALLS - calls >= 4
    assert _body(f"{d}/inproc.vcf") == want
    assert hap_aligner._DEVICE is None       # the run's device is uninstalled


def test_host_workers_with_batch_loci_0_runs_sequentially(sim, port_binding):
    d, want = sim
    pipeline, counters = cli.run(_cli_args(d, f"{d}/hw.vcf") + SEQ_ARGS
                                 + ["--host-workers", "3", "--device",
                                    "cpu"])
    assert counters.genotype_success == 4
    assert _body(f"{d}/hw.vcf") == want


def test_aligner_has_no_default_device(monkeypatch):
    """With no device given and none installed the aligner raises rather
    than fall back to the CPU."""
    monkeypatch.setattr(hap_aligner, "_DEVICE", None)
    rng = np.random.default_rng(3)
    hap = _mk_haplotype(rng, 2, 5)
    seqs, quals, seeds = _reads_from_hap(rng, hap, 3, 30)
    with pytest.raises(RuntimeError, match="no device"):
        hap_aligner.compute_hap_log_likelihoods(hap, seqs, quals, seeds,
                                                dtype="float64")
    LL = hap_aligner.compute_hap_log_likelihoods(hap, seqs, quals, seeds,
                                                 dtype="float64", device="cpu")
    assert LL.shape == (3, hap.num_combs)


def test_device_error_ends_the_run(sim, port_binding, monkeypatch):
    """A failure of the device part of an alignment (a kernel that fails to
    build or launch) propagates out of run_sequential as DeviceError; it
    is not counted as a failed locus."""
    d, _ = sim

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA kernel 'flank_scan' failed to launch")

    monkeypatch.setattr(hap_aligner, "hmm_forward", broken)
    with pytest.raises(DeviceError, match="failed to launch"):
        sequential.run_sequential(_pipeline(d), f"{d}/regions.bed",
                                  f"{d}/broken.vcf", CPU)


def test_host_error_fails_one_locus(sim, port_binding, monkeypatch):
    """A host error (here in the packing of the first locus) counts as one
    failed locus and the run goes on."""
    d, want = sim
    real = hap_aligner.prepare_locus
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("bad packing")
        return real(*args, **kwargs)

    monkeypatch.setattr(hap_aligner, "prepare_locus", flaky)
    counters = sequential.run_sequential(_pipeline(d), f"{d}/regions.bed",
                                         f"{d}/flaky.vcf", CPU)
    assert counters.genotype_fail == 1 and counters.genotype_success == 3
    assert _body(f"{d}/flaky.vcf") == want[1:]


def test_run_sequential_refuses_the_jax_aligner(sim):
    """JAX is loaded in this session, so the genotyper is bound to the JAX
    aligner: the sequential run refuses to start."""
    d, _ = sim
    bound = sys.modules[GENOTYPER].compute_hap_log_likelihoods
    assert bound.__module__ == "hipstr_tpu.pipeline.hap_aligner"
    with pytest.raises(RuntimeError, match="not hipstr_tpu_torch"):
        sequential.run_sequential(_pipeline(d), f"{d}/regions.bed",
                                  f"{d}/refused.vcf", CPU)
