"""The pool's host workers never import torch
(hipstr_tpu_torch/parallel/pool_worker.py):

* a fresh interpreter that imports the worker's entry module, the CLI (a
  spawned worker imports it again where it is the main module), or any
  module of the worker's side leaves torch out of sys.modules, while the
  parent's side (workers.py, hap_aligner.py) loads it;
* a pooled CLI run with 2 workers, the CLI its main module as under
  `python -m hipstr_tpu_torch.cli`, writes the float64 EM anchor, and
  every worker reports torch never loaded and its anonymous memory;
* the genotyper binds its torch aligner on first use, and a rebinding of
  its name is what runs;
* a worker's anonymous memory is read as strbench/memwatch.py reads it,
  and strbench/metrics/worker_anon_mib.py averages the reports.

Each interpreter is a subprocess with a time limit.
"""

import json
import os
import subprocess
import sys

import pytest

from hipstr_tpu_torch.parallel import pool_worker
from hipstr_tpu_torch.utils.simdata import (REFERENCE_EM_ARGS,
                                            reference_loci, write_sim)
from strbench import memwatch
from strbench.metrics import worker_anon_mib

from test_torch_slice import (ONE_THREAD, ROOT, _body,  # noqa: F401
                              _cli_args, one_torch_thread)

REF_EM_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_em_f64.vcf")

# prints whether importing argv[1] loaded torch
IMPORT_SCRIPT = """
import importlib, sys
importlib.import_module(sys.argv[1])
print("torch" in sys.modules)
"""

# the CLI as the main module (runpy, as `python -m` runs it), so that the
# spawned workers import it again as __mp_main__; prints the pooled run's
# worker reports and the main module's name that the spawn read
CLI_MAIN_SCRIPT = """
import json, runpy, sys
from hipstr_tpu_torch.parallel import workers
seen = {}
run_pooled = workers.run_pooled

def keeping(pipeline, *args, **kwargs):
    seen["main"] = sys.modules["__main__"].__spec__.name
    try:
        return run_pooled(pipeline, *args, **kwargs)
    finally:
        seen["stats"] = getattr(pipeline, "last_run_stats", None)

workers.run_pooled = keeping
sys.argv = ["hipstr_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("hipstr_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
except SystemExit as exc:
    assert not exc.code, exc.code
print(json.dumps(dict(main=seen["main"], workers=seen["stats"]["workers"],
                      with_torch=seen["stats"]["workers_with_torch"])))
"""


def _python(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _loads_torch(module: str) -> bool:
    proc = _python(["-c", IMPORT_SCRIPT, module], timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1].lower())


@pytest.mark.parametrize("module", [
    "hipstr_tpu_torch.parallel.pool_worker", "hipstr_tpu_torch.cli",
    "hipstr_tpu_torch.device", "hipstr_tpu_torch.pipeline.processor",
    "hipstr_tpu_torch.pipeline.genotyper",
    "hipstr_tpu_torch.pipeline.vcf_record",
    "hipstr_tpu_torch.pipeline.locus_pack",
    "hipstr_tpu_torch.pipeline.locus_host",
    "hipstr_tpu_torch.ops.posteriors", "hipstr_tpu_torch.ops.em",
    "hipstr_tpu_torch.ops.em_problem", "hipstr_tpu_torch.ops.hmm_containers",
    "hipstr_tpu_torch.utils.timers"])
def test_the_workers_side_imports_no_torch(module):
    assert not _loads_torch(module)


@pytest.mark.parametrize("module", [
    "hipstr_tpu_torch.parallel.workers",
    "hipstr_tpu_torch.pipeline.hap_aligner"])
def test_the_parents_side_imports_torch(module):
    # a check of the check above: the parent's modules do load torch
    assert _loads_torch(module)


def test_cli_pool_workers_load_no_torch(tmp_path):
    """`--host-workers 2` on the CPU from the CLI as the main module: each
    worker runs the host EM and the adaptive rounds on numpy alone, and
    the run writes the EM anchor."""
    d = str(tmp_path)
    write_sim(d, reference_loci())
    proc = _python(["-c", CLI_MAIN_SCRIPT]
                   + _cli_args(d, f"{d}/pool.vcf")
                   + ["--dtype", "float64", "--device", "cpu",
                      "--host-workers", "2"] + REFERENCE_EM_ARGS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["main"] == "hipstr_tpu_torch.cli"
    assert len(res["workers"]) == 2 and res["with_torch"] == 0
    for report in res["workers"]:
        assert not report["torch_loaded"] and not report["jax_loaded"]
        assert report["anon_mib"] > 0
    assert _body(f"{d}/pool.vcf") == _body(REF_EM_VCF)


def test_a_rebound_aligner_is_what_runs(monkeypatch):
    from hipstr_tpu_torch.pipeline import genotyper, hap_aligner
    assert genotyper._aligner() is hap_aligner.compute_hap_log_likelihoods

    def wrapper(*args, **kwargs):
        return hap_aligner.compute_hap_log_likelihoods(*args, **kwargs)
    monkeypatch.setattr(genotyper, "compute_hap_log_likelihoods", wrapper)
    assert genotyper._aligner() is wrapper


def test_anon_mib_reads_as_memwatch_reads():
    got = pool_worker.anon_mib()
    want = memwatch.anon_bytes(os.getpid()) / 2 ** 20
    assert got > 0 and got == pytest.approx(want, abs=2.0)


@pytest.mark.parametrize("stats,want", [
    (dict(workers=[dict(anon_mib=40.0), dict(anon_mib=50.5)]), 45.25),
    # a worker of a program that does not report it is left out
    (dict(workers=[dict(anon_mib=40.0), dict(cuda_initialized=False)]),
     40.0),
    (dict(workers=[dict(cuda_initialized=False, jax_loaded=[])]), None),
    (dict(dispatches=12), None)],
    ids=["mean", "reporting-only", "parent", "in-process"])
def test_worker_anon_mib_reader(stats, want):
    got = worker_anon_mib.read(dict(stats=stats))
    assert got == (pytest.approx(want, rel=1e-12) if want is not None
                   else None)
