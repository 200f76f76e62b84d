"""The port's chromosome-scale soak (hipstr_tpu_torch.tools.soak) against
the JAX package's (tools/soak.py).

* `generate` writes the JAX soak's sim.bam, sim.fa, regions.bed and
  snps.vcf byte for byte;
* the port's soak run in float64 on the CPU writes the body of
  tests/data/torch_port_soak_f64.vcf over the 2-locus prefix of the
  20-sample x 30-read soak dataset (its first 2 BED lines);
* the closing JSON line of `python -m hipstr_tpu_torch.tools.soak`, and
  its band table.

The anchor is the JAX package's batched run over that prefix, as
tools/soak.py:run sets it up (GenotyperPipeline + run_batched, the
uncompressed snps.vcf as PipelineOptions.snp_vcf, the default stutter
model) in float64 on the CPU, as the JAX CLI sets float64 up;
`python tests/test_torch_soak.py` rewrites it.  chip_smoke.py holds the
port's float64 runs on the card to the same file.
"""

import filecmp
import json
import os
import subprocess
import sys

import torch

from hipstr_tpu_torch.pipeline.processor import GenotyperPipeline, Logger
from hipstr_tpu_torch.tools import soak

from test_torch_bench import import_jax_tool
from test_torch_slice import (ONE_THREAD, ROOT, _body,  # noqa: F401
                              one_torch_thread)

SOAK_VCF = os.path.join(ROOT, "tests", "data", "torch_port_soak_f64.vcf")
PREFIX = 2                           # loci of the anchor
SAMPLES, READS = 20, 30              # the soak's (BASELINE config 4)
CPU = torch.device("cpu")


def test_generate_matches_the_jax_soak(tmp_path):
    jax_soak = import_jax_tool("tools.soak")
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    soak.generate(str(mine), 3, 2, 10, log=lambda msg: None)
    jax_soak.generate(str(theirs), 3, 2, 10)
    names = ["sim.bam", "sim.fa", "regions.bed", "snps.vcf"]
    match, mismatch, errors = filecmp.cmpfiles(mine, theirs, names,
                                               shallow=False)
    assert match == names, (mismatch, errors)


def _prefix_dataset(d):
    soak.generate(str(d), PREFIX, SAMPLES, READS, log=lambda msg: None)
    return str(d)


def test_soak_f64_matches_the_anchor(tmp_path):
    """The batched run (its 1024-read pools cost ~50 s a locus on the CPU;
    the sequential run is held to the anchor on the card, chip_smoke
    13b)."""
    d = _prefix_dataset(tmp_path)
    want = _body(SOAK_VCF)
    assert len(want) == PREFIX
    res = soak.run(d, CPU, dtype="float64", out=f"{d}/out.vcf",
                   log=lambda msg: None)
    assert (res["loci"], res["success"], res["fail"]) == (PREFIX, PREFIX, 0)
    assert [b["band"] for b in res["bands"]] == ["0-2"]
    assert _body(f"{d}/out.vcf") == want


def test_soak_cli_prints_the_band_table_and_json(tmp_path):
    """The entry point at 3 loci x 2 samples x 20 reads, bands of 2 loci."""
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run(
        [sys.executable, "-m", "hipstr_tpu_torch.tools.soak", "3", "2", "20",
         str(tmp_path), "--device", "cpu", "--band", "2", "--window-s",
         "0.5"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert (res["loci"], res["success"], res["fail"]) == (3, 3, 0)
    assert [b["band"] for b in res["bands"]] == ["0-2", "2-3"]
    assert res["device"]["platform"] == "cpu" and res["device"]["cards"] == 1
    assert res["card_shards"] == res["dispatches"] > 0
    assert res["peak_device_mib"] is None and res["max_rss_mb"] > 0
    assert "| 0-2 |" in proc.stdout and "| 2-3 |" in proc.stdout
    assert os.path.exists(tmp_path / "dataset.json")


def test_trace_prefetch_never_overlaps_a_trace_of_its_locus(tmp_path,
                                                          monkeypatch):
    """A locus's ML-trace prefetch (a pool thread) and any other trace of
    that locus share its haplotype instances' native pointer caches; the
    batched run must let the prefetch finish first.  The prefetch's
    native batch is slowed down here, so a run that went on beside it (the
    soak's intermittent crash in the native trace summary), or marshalled
    another batch of the locus beside it, fails every time."""
    import threading
    import time

    from hipstr_tpu_torch.parallel import executor
    from hipstr_tpu_torch.pipeline.genotyper import SeqStutterGenotyper

    orig = SeqStutterGenotyper._trace_batch_runner
    busy, overlaps, prefetches = {}, [], []

    def traced(self, missing, n_threads=0):
        if busy.get(id(self)):
            overlaps.append(id(self))
        run = orig(self, missing, n_threads)

        def slow_run():
            if busy.get(id(self)):
                overlaps.append(id(self))
            busy[id(self)] = True
            try:
                if threading.current_thread() is not threading.main_thread():
                    prefetches.append(id(self))
                    time.sleep(0.3)
                return run()
            finally:
                busy[id(self)] = False
        return slow_run

    monkeypatch.setattr(SeqStutterGenotyper, "_trace_batch_runner", traced)
    d = str(tmp_path)
    soak.generate(d, 2, 4, 20, log=lambda msg: None)
    p = GenotyperPipeline([f"{d}/sim.bam"], f"{d}/sim.fa",
                          soak.soak_options(d, "float64"), Logger(quiet=True))
    counters = executor.run_batched(p, f"{d}/regions.bed", f"{d}/out.vcf",
                                    CPU)
    assert (counters.genotype_success, counters.genotype_fail) == (2, 0)
    assert prefetches and not overlaps


ANCHOR_SCRIPT = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {root!r})
from tools.soak import generate
jax.config.update("jax_compilation_cache_dir", None)
from hipstr_tpu.models.stutter import StutterModel
from hipstr_tpu.parallel.executor import run_batched
from hipstr_tpu.pipeline.processor import (GenotyperPipeline, Logger,
                                           PipelineOptions)
d = sys.argv[1]
generate(d, {prefix}, {samples}, {reads})
opts = PipelineOptions(
    min_reads=15, use_unpaired=True, dtype="float64",
    snp_vcf=f"{{d}}/snps.vcf",
    def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
p = GenotyperPipeline([f"{{d}}/sim.bam"], f"{{d}}/sim.fa", opts,
                      Logger(quiet=True))
c = run_batched(p, f"{{d}}/regions.bed", f"{{d}}/jax.vcf", batch_size=32)
assert c.genotype_success == {prefix} and c.genotype_fail == 0, c
"""


def write_anchor() -> None:
    """Rewrite tests/data/torch_port_soak_f64.vcf from the JAX package."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
        script = ANCHOR_SCRIPT.format(root=ROOT, prefix=PREFIX,
                                      samples=SAMPLES, reads=READS)
        subprocess.run([sys.executable, "-c", script, d], cwd=ROOT, env=env,
                       check=True)
        with open(f"{d}/jax.vcf") as src, open(SOAK_VCF, "w") as dst:
            dst.write(src.read().replace(f"{d}/", ""))


if __name__ == "__main__":
    write_anchor()
