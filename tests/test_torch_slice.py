"""The port's whole batched genotyping slice against the JAX package.

* the port's run_batched in float64 on the CPU writes the same VCF body as
  hipstr_tpu's batched run in float64 on the CPU, with host posteriors and
  with the fused posteriors the card uses;
* `python -m hipstr_tpu_torch.cli --device cpu` runs with JAX blocked and
  writes that VCF too;
* device errors end the run instead of failing single loci;
* without a card or nvcc, the device and the kernel builder raise;
* the CLI refuses the paths that are not ported (the sequential path,
  `--batch-loci 0`, is ported and held to the JAX package in
  tests/test_torch_sequential.py; the batched EM in
  tests/test_torch_em_batched.py, the host worker pool in
  tests/test_torch_workers.py).
"""

import os
import subprocess
import sys

import pytest
import torch

from hipstr_tpu.utils.simulate import simulate_locus
from hipstr_tpu_torch import cli, kernels
from hipstr_tpu_torch.device import resolve, resolve_device
from hipstr_tpu_torch.models.stutter import StutterModel
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline, Logger,
                                                 PipelineOptions)
from hipstr_tpu_torch.utils.simdata import write_sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the port's CLI subprocesses run torch on one thread (see one_torch_thread)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
# run in a port subprocess after its work: neither JAX nor any module of
# the JAX package was loaded
ASSERT_NO_JAX_PACKAGE = (
    "assert not [m for m in sys.modules if sys.modules[m] is not None and\n"
    "            (m.split('.')[0] in ('jax', 'hipstr_tpu'))]\n")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of small tensor ops.  With the test
    workers sharing the cores, torch's intra-op threads oversubscribe them
    and each op slows about tenfold, so the port's test modules (which
    import this fixture) run torch on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _opts():
    return PipelineOptions(
        min_reads=12, use_unpaired=True, dtype="float64",
        def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))


def _pipeline(d):
    return GenotyperPipeline([f"{d}/sim.bam"], f"{d}/sim.fa", _opts(),
                             Logger(quiet=True))


def _body(path):
    return [l for l in open(path) if not l.startswith("#")]


def _cli_args(d, out):
    return ["--bams", f"{d}/sim.bam", "--fasta", f"{d}/sim.fa", "--regions",
            f"{d}/regions.bed", "--str-vcf", out, "--silent"]


# the options of _opts() on the command line
SIM_ARGS = ["--min-reads", "12", "--use-unpaired", "--def-stutter-model",
            "--dtype", "float64", "--batch-loci", "4"]


def run_jax_cli(args):
    """`python -m hipstr_tpu.cli` on the CPU in its own process (one JAX
    device: the test session's 8-device CPU mesh is not inherited).  It
    keeps out of the CLI's shared persistent compile cache: JAX writes an
    entry in place, so a CLI in another test worker could load it half
    written (a SIGSEGV seen in a full parallel run)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               HIPSTR_TPU_COMPILE_CACHE="")
    proc = subprocess.run([sys.executable, "-m", "hipstr_tpu.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """4 loci, 2 samples x 20 reads, periods 2-3, and the VCF body that
    hipstr_tpu's batched run writes for them in float64 on the CPU."""
    d = str(tmp_path_factory.mktemp("torch_slice"))
    write_sim(d, [simulate_locus(seed=900 + i, n_samples=2,
                                 reads_per_sample=20, period=2 + i % 2,
                                 ref_units=8, chrom=f"chrT{i}")
                  for i in range(4)])
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + SIM_ARGS)
    return d, _body(f"{d}/jax.vcf")


def test_port_vcf_equals_jax_f64(sim):
    d, want = sim
    counters = executor.run_batched(_pipeline(d), f"{d}/regions.bed",
                                    f"{d}/port.vcf", CPU, batch_size=4)
    assert counters.genotype_success == 4 and counters.genotype_fail == 0
    assert _body(f"{d}/port.vcf") == want


def test_port_fused_posteriors_vcf_equals_jax_f64(sim, monkeypatch):
    """The card's path: posteriors fused into each dispatch."""
    d, want = sim
    monkeypatch.setattr(executor, "device_post_enabled", lambda dev: True)
    executor.run_batched(_pipeline(d), f"{d}/regions.bed", f"{d}/fused.vcf",
                         CPU, batch_size=4)
    assert _body(f"{d}/fused.vcf") == want


def test_cli_runs_with_jax_blocked(sim):
    d, want = sim
    script = ("import sys; sys.modules['jax'] = None\n"
              "from hipstr_tpu_torch.cli import main\n"
              "rc = main(sys.argv[1:])\n"
              + ASSERT_NO_JAX_PACKAGE +
              "sys.exit(rc)\n")
    args = _cli_args(d, f"{d}/nojax.vcf") + SIM_ARGS + ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _body(f"{d}/nojax.vcf") == want


def test_loaded_jax_keeps_the_jax_aligner():
    """JAX is loaded in this session (conftest): the port writes no
    sys.modules entry, so the JAX package keeps its own aligner and the
    port's genotyper its own."""
    from hipstr_tpu.pipeline import genotyper as jax_genotyper
    from hipstr_tpu_torch.pipeline import genotyper, hap_aligner
    assert sys.modules.get("jax") is not None
    mod = sys.modules["hipstr_tpu.pipeline.hap_aligner"]
    assert mod.__name__ == "hipstr_tpu.pipeline.hap_aligner"
    assert jax_genotyper.compute_hap_log_likelihoods is \
        mod.compute_hap_log_likelihoods
    assert genotyper.compute_hap_log_likelihoods is \
        hap_aligner.compute_hap_log_likelihoods


def test_device_error_fails_the_run(sim, monkeypatch):
    """A dispatch error (a kernel that fails to build or launch) propagates
    out of run_batched; it is not counted as a failed locus."""
    d, _ = sim

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA kernel 'segment' failed to launch")

    monkeypatch.setattr(executor, "batched_forward", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        executor.run_batched(_pipeline(d), f"{d}/regions.bed",
                             f"{d}/broken.vcf", CPU, batch_size=4)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        assert resolve("cuda")[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda", "float64")


def test_kernel_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library("segment")


DEF = "--def-stutter-model"


@pytest.mark.parametrize("flags", [
    [DEF, "--workers", "2"], [DEF, "--distributed"], [DEF, "--profile", "p"],
    [DEF, "--platform", "cpu"]],
    ids=["workers", "distributed", "profile", "platform"])
def test_cli_refuses_unported_paths(flags, capsys, tmp_path):
    args = _cli_args(str(tmp_path), str(tmp_path / "x.vcf"))
    assert cli.main(args + ["--device", "cpu"] + flags) == 1
    assert "not yet ported" in capsys.readouterr().err
