"""The pooled run's own clock (hipstr_tpu_torch/parallel/workers.py and
utils/timers.py):

* the parent's loop states partition "Pool loop", and "Pool idle" is
  "Pool wait idle" + "Pool wait fetch";
* each hand-over of a worker's timers partitions its "Worker wall" into
  leaf timers, "Worker idle" and "Worker other";
* the workers' totals reach the parent before any "fin" is sent;
* under torch.profiler the loop's states are ranges of the trace, and with
  no profiler no range is opened;
* the benchmark's five readers of these timers, and the two of the
  workers' ML traces, on a hand-built record.

The pooled runs are one subprocess with a time limit (2 workers, the
card's EM and fused posteriors forced on as tests/test_torch_workers.py
forces them), so a hang fails the tests instead of the suite's clock.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipstr_tpu_torch.utils.simdata import write_sim
from hipstr_tpu_torch.utils.simulate import simulate_locus
from hipstr_tpu_torch.utils.timers import ProcessTimer
from strbench.metrics import (build_ms_per_locus, pool_busy_pct,
                              pool_fill_wait_pct, pool_idle_pct,
                              pool_pipe_wait_pct, trace_ms_per_locus,
                              trace_prefetch_pct, worker_idle_pct)

from test_torch_slice import ONE_THREAD, ROOT, one_torch_thread  # noqa: F401

# run_pooled twice, without and then under a CPU profiler; prints the
# timers, every hand-over of a worker's timers, the parent's "(workers)"
# totals when it sent the first "fin", the ranges opened in each run and
# the profiled run's event names
TRACE_SCRIPT = """
import json, sys
import multiprocessing
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile
from hipstr_tpu_torch.parallel import executor, workers
from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline, Logger,
                                                 PipelineOptions)
d = sys.argv[1]
executor.device_post_enabled = lambda dev: True
workers.device_post_enabled = executor.device_post_enabled
executor.device_em_enabled = lambda opts, dev: True
workers.device_em_enabled = executor.device_em_enabled

entered = [0]
enter = profiler.record_function.__enter__
def counting_enter(self):
    entered[0] += 1
    return enter(self)
profiler.record_function.__enter__ = counting_enter

handed = []
add = workers.add_worker_timers
def recording_add(pipeline, totals, spans):
    handed.append(dict(totals))
    add(pipeline, totals, spans)
workers.add_worker_timers = recording_add

state = dict(pipeline=None, at_fin=None)
class ParentEnd:
    def __init__(self, conn):
        self.conn = conn
    def send(self, msg):
        if msg[0] == "fin" and state["at_fin"] is None:
            state["at_fin"] = sorted(k for k in state["pipeline"].timer.totals
                                     if k.endswith(" (workers)"))
        return self.conn.send(msg)
    def __getattr__(self, name):
        return getattr(self.conn, name)
class Context:
    def __init__(self, real):
        self.real = real
    def Pipe(self, duplex=True):
        a, b = self.real.Pipe(duplex)
        return ParentEnd(a), b
    def __getattr__(self, name):
        return getattr(self.real, name)
class Mp:
    def get_context(self, method=None):
        return Context(multiprocessing.get_context(method))
workers.mp = Mp()

def run(tag):
    opts = PipelineOptions(min_reads=12, use_unpaired=True, dtype="float64")
    p = GenotyperPipeline([f"{d}/sim.bam"], f"{d}/sim.fa", opts,
                          Logger(quiet=True))
    state["pipeline"], state["at_fin"] = p, None
    spec = dict(bam_paths=[f"{d}/sim.bam"], fasta_path=f"{d}/sim.fa",
                opts=opts, bam_samps=None, bam_libs=None, lib_field="LB")
    c = workers.run_pooled(p, f"{d}/regions.bed", f"{d}/{tag}.vcf",
                           torch.device("cpu"), spec, n_workers=2,
                           batch_size=4)
    assert c.genotype_success > 0 and c.genotype_fail == 0
    return p.timer.totals

out = {}
handed.clear()
entered[0] = 0
out["plain"] = dict(timers=run("plain"), handed=list(handed),
                    at_fin=state["at_fin"], entered=entered[0])
entered[0] = 0
with profile(activities=[ProfilerActivity.CPU]) as prof:
    timers = run("profiled")
out["profiled"] = dict(timers=timers, entered=entered[0],
                       names=sorted({e.name for e in prof.events()
                                     if e.name.startswith("Pool ")}))
print(json.dumps(out))
"""

STATES = ("Pool route", "Pool send", "Pool dispatch",
          "Stutter estimation (device)", "Pool wait fill", "Pool wait fetch",
          "Pool wait idle")
# a worker's timers that are not leaves of its wall: the wall, its parts
# that are not leaves, and the nested timer
NOT_LEAVES = ("Worker wall", "Worker other", "Worker idle",
              "VCF record construction")     # in "Genotyping (adaptive)"


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """6 loci, 2 samples x 20 reads, periods 2-3, pooled twice."""
    d = str(tmp_path_factory.mktemp("torch_pool_trace"))
    write_sim(d, [simulate_locus(seed=910 + i, n_samples=2,
                                 reads_per_sample=20, period=2 + (i % 2),
                                 ref_units=8, chrom=f"chrPT{i}")
                  for i in range(6)])
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", TRACE_SCRIPT, d], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("run", ["plain", "profiled"])
def test_parent_states_partition_the_loop(traced, run):
    t = traced[run]["timers"]
    assert "Pool poll" not in t
    states = sum(t.get(s, 0.0) for s in STATES)
    assert t["Pool loop"] > 0
    assert abs(states - t["Pool loop"]) <= 0.01 * t["Pool loop"]
    assert t["Pool idle"] == pytest.approx(
        t.get("Pool wait idle", 0.0) + t.get("Pool wait fetch", 0.0),
        rel=1e-12, abs=1e-12)
    # the workers' start is waited out with nothing staged
    assert t["Pool wait idle"] > 0 and t["Pool dispatch"] > 0
    assert t["Pool send"] > 0


def test_worker_hand_overs_partition_the_wall(traced):
    handed = traced["plain"]["handed"]
    # at least one hand-over a worker: each one's "fin"
    assert len(handed) >= 2
    for d in handed:
        leaves = sum(v for k, v in d.items() if k not in NOT_LEAVES)
        assert d["Worker other"] >= -1e-9
        assert leaves + d["Worker idle"] + d["Worker other"] == \
            pytest.approx(d["Worker wall"], rel=1e-9, abs=1e-9)
    t = traced["plain"]["timers"]
    for name in ("Worker wall", "Worker idle", "Worker other",
                 "Worker send", "Genotyper build",
                 "LL install"):
        assert t[f"{name} (workers)"] == pytest.approx(
            sum(d.get(name, 0.0) for d in handed), rel=1e-12)


def test_worker_totals_reach_the_parent_before_fin(traced):
    at_fin = traced["plain"]["at_fin"]
    assert "Worker wall (workers)" in at_fin
    assert "Genotyping (adaptive) (workers)" in at_fin


def test_profiler_sees_the_loop_states(traced):
    names = traced["profiled"]["names"]
    assert "Pool wait fill" in names and "Pool dispatch" in names
    assert traced["profiled"]["entered"] > 0


def test_no_range_without_a_profiler(traced):
    assert traced["plain"]["entered"] == 0


def test_switch_partitions_the_time_between_switches():
    timer = ProcessTimer()
    t0 = timer.switch("a")
    timer.switch("b")
    timer.switch("a")
    t1 = timer.switch(None)
    timer.switch(None)               # nothing open: adds nothing
    assert set(timer.totals) == {"a", "b"}
    assert timer.totals["a"] + timer.totals["b"] == pytest.approx(
        t1 - t0, rel=1e-12, abs=1e-12)


def test_nested_blocks_are_covered_once():
    timer = ProcessTimer()
    with timer.time("outer"):
        with timer.time("inner"):
            sum(range(10000))
    with timer.time("second"):
        pass
    t = timer.totals
    assert t["inner"] <= t["outer"]
    assert timer.covered == pytest.approx(t["outer"] + t["second"],
                                          rel=1e-12)


def test_ranges_only_under_a_profiler(monkeypatch):
    opened = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        opened.append(self.name)
        return enter(self)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        counting)
    timer = ProcessTimer()
    with timer.time("block"):
        timer.switch("state")
    timer.switch(None)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.time("block"):
            timer.switch("state")
        timer.switch(None)
    assert opened == ["block", "state"]
    names = {e.name for e in prof.events()}
    assert {"block", "state"} <= names


# a traced run's record as the harness hands it to the readers
RECORD = dict(
    wall_s=110.0, loci=4000,
    timers={"Worker start": 10.0, "Pool loop": 95.0, "Pool route": 8.0,
            "Pool send": 2.0, "Pool dispatch": 4.0,
            "Stutter estimation (device)": 6.0, "Pool wait fill": 60.0,
            "Pool wait fetch": 5.0, "Pool wait idle": 10.0,
            "Pool idle": 15.0, "Worker wall (workers)": 400.0,
            "Worker idle (workers)": 80.0,
            "Genotyper build (workers)": 36.0,
            "ML traces (workers)": 80.0},
    stats=dict(workers=[
        dict(trace_jobs_prefetched=900, trace_jobs_main=100,
             trace_jobs_discarded=10),
        dict(trace_jobs_prefetched=800, trace_jobs_main=200,
             trace_jobs_discarded=0)]))
# the parent commit's record: none of the new timers, and workers'
# reports without trace jobs
PARENT_RECORD = dict(
    wall_s=110.0, loci=4000,
    timers={"Worker start": 10.0, "Pool poll": 80.0, "Pool idle": 15.0,
            "Stutter estimation (device)": 6.0,
            "Worker idle (workers)": 80.0},
    stats=dict(workers=[dict(anon_mib=140.0, host_posteriors=0)] * 2))


@pytest.mark.parametrize("reader,want", [
    (pool_busy_pct, 18.0), (pool_pipe_wait_pct, 2.0),
    (pool_fill_wait_pct, 60.0), (worker_idle_pct, 20.0),
    (build_ms_per_locus, 9.0), (trace_ms_per_locus, 20.0),
    (trace_prefetch_pct, 85.0)])
def test_reader_on_a_hand_built_record(reader, want):
    assert reader.read(RECORD) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("reader", [pool_busy_pct, pool_pipe_wait_pct,
                                    pool_fill_wait_pct, worker_idle_pct,
                                    build_ms_per_locus, trace_ms_per_locus,
                                    trace_prefetch_pct])
def test_reader_finds_nothing_on_the_parent(reader):
    assert reader.read(PARENT_RECORD) is None


def test_parent_shares_add_up_to_the_loop():
    # every state is read by one share; pool_idle_pct takes "Worker start"
    # off "Pool idle", which this record holds wholly in "Pool wait idle"
    shares = (pool_busy_pct.read(RECORD) + pool_pipe_wait_pct.read(RECORD)
              + pool_fill_wait_pct.read(RECORD) + pool_idle_pct.read(RECORD))
    t = RECORD["timers"]
    loop = 100.0 * (t["Pool loop"] - t["Worker start"]) / (
        RECORD["wall_s"] - t["Worker start"])
    assert shares == pytest.approx(loop, rel=1e-12)
