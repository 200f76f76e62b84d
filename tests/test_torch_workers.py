"""The port's host worker pool (hipstr_tpu_torch/parallel/workers.py).

* run_pooled with 2 workers writes the VCF body (and stutter models) of
  run_batched, in float64 on the CPU: with a fixed model, with the fused
  posteriors, and with the device EM forced on in the parent (the flag
  reaches the workers through their spec); both time a locus's host life
  (pipeline/locus_host.py) under the same timers;
* every worker reports torch (so CUDA) never loaded, its anonymous
  memory, no JAX loaded, and trace jobs run on its trace thread;
* the CLI's pooled run (`--host-workers 2`, host EM in the workers) writes
  the EM anchor tests/data/torch_port_ref_em_f64.vcf;
* a worker that finds several "ll" replies waiting installs them all,
  traces ahead, and leaves no thread behind after "fin";
* a worker that dies ends the run with an error, not a hang;
* `resolve_host_workers` resolves -1 as the JAX CLI does.

Each pooled run is a subprocess with a time limit, so a hang fails one
test instead of spending the suite's clock.
"""

import json
import os
import queue
import subprocess
import sys
import threading
from collections import deque

import pytest
import torch

from hipstr_tpu_torch.cli import resolve_host_workers
from hipstr_tpu_torch.io.regions import read_regions
from hipstr_tpu_torch.models.stutter import StutterModel
from hipstr_tpu_torch.parallel import pool_worker
from hipstr_tpu_torch.parallel.executor import BatchedAligner, _fetch
from hipstr_tpu_torch.parallel.workers import _ReadyItem
from hipstr_tpu_torch.pipeline.processor import Logger, PipelineOptions
from hipstr_tpu_torch.utils.simdata import (REFERENCE_EM_ARGS,
                                            reference_loci, write_sim)
from hipstr_tpu_torch.utils.simulate import simulate_locus

from test_torch_slice import (ONE_THREAD, ROOT, _body,  # noqa: F401
                              _cli_args, one_torch_thread)

REF_EM_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_em_f64.vcf")

# run_batched, then run_pooled with 2 workers, on the CPU in float64;
# argv: data dir, mode (model | device-post | device-em)
POOL_SCRIPT = """
import json, sys
import torch
from hipstr_tpu_torch.models.stutter import StutterModel
from hipstr_tpu_torch.parallel import executor, workers
from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline, Logger,
                                                 PipelineOptions)
d, mode = sys.argv[1], sys.argv[2]
if mode != "model":
    executor.device_post_enabled = lambda dev: True
    workers.device_post_enabled = executor.device_post_enabled
if mode == "device-em":
    executor.device_em_enabled = lambda opts, dev: True
    workers.device_em_enabled = executor.device_em_enabled

def opts(tag):
    model = None if mode == "device-em" else StutterModel(
        0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2)
    return PipelineOptions(min_reads=12, use_unpaired=True, dtype="float64",
                           def_stutter_model=model,
                           stutter_out=f"{d}/{mode}_{tag}.so")

def pipeline(tag):
    return GenotyperPipeline([f"{d}/sim.bam"], f"{d}/sim.fa", opts(tag),
                             Logger(quiet=True))

cpu = torch.device("cpu")
bat = pipeline("bat")
executor.run_batched(bat, f"{d}/regions.bed", f"{d}/{mode}_bat.vcf", cpu,
                     batch_size=4)
pool = pipeline("pool")
spec = dict(bam_paths=[f"{d}/sim.bam"], fasta_path=f"{d}/sim.fa",
            opts=opts("pool"), bam_samps=None, bam_libs=None, lib_field="LB")
c = workers.run_pooled(pool, f"{d}/regions.bed", f"{d}/{mode}_pool.vcf", cpu,
                       spec, n_workers=2, batch_size=4)
print(json.dumps(dict(success=c.genotype_success, fail=c.genotype_fail,
                      em_waves=pool.last_run_stats["em_waves"],
                      workers=pool.last_run_stats["workers"],
                      with_torch=pool.last_run_stats["workers_with_torch"],
                      timers=dict(bat=sorted(bat.timer.totals),
                                  pool=sorted(pool.timer.totals)))))
"""

# the timers of a locus's host life (pipeline/locus_host.py), whichever
# run schedules it
PER_LOCUS = ("Genotyping (adaptive)", "LL install", "Locus packing",
             "VCF record construction")


def _python(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def pool_sim(tmp_path_factory):
    """4 loci, 2 samples x 20 reads, periods 2-3."""
    d = str(tmp_path_factory.mktemp("torch_pool"))
    write_sim(d, [simulate_locus(seed=810 + i, n_samples=2,
                                 reads_per_sample=20, period=2 + (i % 2),
                                 ref_units=8, chrom=f"chrWE{i}")
                  for i in range(4)])
    return d


@pytest.mark.parametrize("mode", ["model", "device-post", "device-em"])
def test_pool_equals_in_process(pool_sim, mode):
    d = pool_sim
    proc = _python(["-c", POOL_SCRIPT, d, mode])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    bat, pool = _body(f"{d}/{mode}_bat.vcf"), _body(f"{d}/{mode}_pool.vcf")
    assert len(bat) == res["success"] > 0 and res["fail"] == 0
    assert pool == bat
    assert open(f"{d}/{mode}_pool.so").read() == \
        open(f"{d}/{mode}_bat.so").read()
    assert (res["em_waves"] > 0) == (mode == "device-em")
    # both runs time a locus's host life alike (the pooled run's
    # timers are its workers', under "<name> (workers)")
    bat_t = [n for n in res["timers"]["bat"] if n in PER_LOCUS]
    pool_t = [n[:-len(" (workers)")] for n in res["timers"]["pool"]
              if n.endswith(" (workers)")
              and n[:-len(" (workers)")] in PER_LOCUS]
    print("per-locus timers, in-process:", bat_t, "pooled:", pool_t)
    assert bat_t == pool_t == list(PER_LOCUS)
    assert len(res["workers"]) == 2
    for report in res["workers"]:
        assert not report["torch_loaded"] and not report["jax_loaded"]
        assert "cuda_initialized" not in report and report["anon_mib"] > 0
    assert res["with_torch"] == 0
    # the workers compute a round's posteriors only where the parent did
    # not fuse them: every round without fused posteriors, none with them
    # (these loci's rounds are all at H_pad <= 32)
    host = sum(r["host_posteriors"] for r in res["workers"])
    assert host >= len(bat) if mode == "model" else host == 0
    # the VCF above came from the overlapped path: every worker ran trace
    # jobs ahead on its trace thread
    for report in res["workers"]:
        assert report["trace_jobs_prefetched"] > 0


def test_cli_pool_matches_em_reference(tmp_path):
    """`--host-workers 2` on the CPU: each worker runs the host EM."""
    d = str(tmp_path)
    write_sim(d, reference_loci())
    proc = _python(["-m", "hipstr_tpu_torch.cli"]
                   + _cli_args(d, f"{d}/pool.vcf")
                   + ["--dtype", "float64", "--device", "cpu",
                      "--host-workers", "2"] + REFERENCE_EM_ARGS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _body(f"{d}/pool.vcf") == _body(REF_EM_VCF)


class _BatchPipe:
    """Both ends of a worker's pipe in one process.  The parent's side
    puts a batch of messages at once, so the worker's next recv finds the
    whole batch waiting; the worker's replies go to `replies`."""

    def __init__(self):
        self.cv = threading.Condition()
        self.inbox = deque()
        self.replies = queue.Queue()

    def put_all(self, msgs) -> None:
        with self.cv:
            self.inbox.extend(msgs)
            self.cv.notify()

    def recv(self):
        with self.cv:
            self.cv.wait_for(lambda: self.inbox)
            return self.inbox.popleft()

    def poll(self, timeout=0.0):
        with self.cv:
            return bool(self.inbox)

    def send(self, msg) -> None:
        self.replies.put(msg)

    def close(self) -> None:
        pass


def test_worker_drains_its_replies_and_leaves_no_thread(pool_sim,
                                                        monkeypatch):
    """One worker (in a thread of this process) gets its loci's "ll"
    replies a round at a time, all waiting before it reads the first: it
    settles every locus with a record, traces ahead on its trace thread,
    and after "fin" no thread of it is alive."""
    d = pool_sim
    # worker_main sets these for its process: keep them to this test
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("HIPSTR_TRACE_THREADS", "1")
    opts = PipelineOptions(min_reads=12, use_unpaired=True, dtype="float64",
                           def_stutter_model=StutterModel(
                               0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
    spec = dict(bam_paths=[f"{d}/sim.bam"], fasta_path=f"{d}/sim.fa",
                opts=opts, bam_samps=None, bam_libs=None, lib_field="LB",
                device_post=False, device_em=False)
    regions = read_regions(f"{d}/regions.bed")
    before = set(threading.enumerate())
    pipe = _BatchPipe()
    worker = threading.Thread(target=pool_worker.worker_main,
                              args=(pipe, spec), daemon=True)
    worker.start()
    aligner = BatchedAligner([torch.device("cpu")], "float64", 4)
    batch = [("prep", i, r) for i, r in enumerate(regions)]
    records, widest, traced = {}, 0, 0.0
    while batch:
        widest = max(widest, sum(m[0] == "ll" for m in batch))
        pipe.put_all(batch)
        waiting = len(batch)          # one "ready" or "settled" each
        while waiting:
            msg = pipe.replies.get(timeout=120)
            if msg[0] == "ready":
                aligner.add(_ReadyItem(msg[1], msg[2], msg[3], 0))
            elif msg[0] == "settled":
                records[msg[1]] = msg[2]
            elif msg[0] == "timers":
                traced += msg[2].get("ML traces", 0.0)
            waiting -= msg[0] in ("ready", "settled")
        batch = []
        for chunk, handle in aligner.dispatch_all():
            LL = _fetch(handle)
            batch += [("ll", it.order, LL[gi, :it.statics[5], :it.statics[6]])
                      for gi, it in enumerate(chunk)]
    pipe.put_all([("fin",)])
    while True:
        msg = pipe.replies.get(timeout=120)
        if msg[0] == "fin":
            break
        if msg[0] == "timers":
            traced += msg[2].get("ML traces", 0.0)
    # the worker has sent its report: its trace thread is gone already
    assert not [t for t in threading.enumerate()
                if t not in before and t is not worker]
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert widest == len(regions) == len(records) == 4
    assert all(rec is not None for rec in records.values())
    report = msg[-1]
    assert report["trace_jobs_prefetched"] > 0
    # the traces' seconds are handed over as a span, not a timer
    assert traced + msg[4].get("ML traces", 0.0) > 0
    assert "ML traces" not in msg[3]
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def test_dead_worker_fails_the_run(pool_sim):
    """Workers that die at start (an unreadable BAM in their spec) end the
    run with the closed pipe's error."""
    d = pool_sim
    script = POOL_SCRIPT.replace('bam_paths=[f"{d}/sim.bam"]',
                                 'bam_paths=[f"{d}/missing.bam"]')
    assert script != POOL_SCRIPT
    proc = _python(["-c", script, d, "model"], timeout=120)
    assert proc.returncode != 0
    last = proc.stderr.strip().splitlines()[-1]
    assert last.split(":")[0] in ("EOFError", "BrokenPipeError",
                                  "ConnectionResetError"), last


@pytest.mark.parametrize("device,n_cores,want", [
    ("cpu", 4, 1), ("cpu", 6, 1), ("cpu", 16, 1),
    ("cuda", 4, 1), ("cuda", 6, 4), ("cuda", 16, 4)])
def test_resolve_host_workers_default(device, n_cores, want):
    assert resolve_host_workers(-1, torch.device(device), n_cores) == want


def test_resolve_host_workers_keeps_a_given_count():
    for n in (0, 1, 3, 8):
        assert resolve_host_workers(n, torch.device("cuda"), 16) == n
