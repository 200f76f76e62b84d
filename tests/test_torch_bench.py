"""The port's measuring entry points (hipstr_tpu_torch.bench and
hipstr_tpu_torch.tools.profile_host / decode_bench) against the JAX
package's (bench.py, tools/).

* the bench's dataset is bench.py's `_write_dataset`, byte for byte;
* `python -m hipstr_tpu_torch.bench --device cpu` prints one JSON line
  with bench.py's keys (less the TPU-only ones) and the port's, every
  locus genotyped;
* the bench's end-to-end run in float64 on the first 2 loci of the
  reference dataset writes the first 2 records of
  tests/data/torch_port_ref_f64.vcf (the JAX CLI's float64 output);
* the entry points raise when asked for the card without one;
* the host profile and the decode + filter throughput run on the CPU.
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from hipstr_tpu_torch import bench
from hipstr_tpu_torch.tools import decode_bench, profile_host, soak
from hipstr_tpu_torch.utils.simdata import reference_loci, write_sim

from test_torch_slice import (ONE_THREAD, ROOT, _body,  # noqa: F401
                              one_torch_thread)

REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")
CPU = torch.device("cpu")
# bench.py's keys, less the TPU-only ones (achieved_gflops, mfu_vs_peak)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "n_loci", "success",
            "device_wait_s", "host_s", "shallow_loci_per_sec",
            "vs_baseline_shallow", "shallow_host_s", "shallow_n_loci",
            "kernel_ms_per_locus", "kernel_deep_ms_per_locus",
            "kernel_shapes", "fetch_ms", "spec_hit_rate", "rounds_hist",
            "platform", "ref_loci_per_sec", "ref_deep_loci_per_sec"}
PORT_KEYS = {"fail", "host_workers", "runs", "worker_start_s",
             "loci_per_sec_runs", "loci_per_sec_spread",
             "shallow_loci_per_sec_runs", "shallow_loci_per_sec_spread",
             "max_rss_mb", "peak_device_mib", "dispatches", "card_shards",
             "launches", "device"}


def import_jax_tool(name: str):
    """Import one of the JAX package's scripts (bench.py, tools/*.py) by
    module name.  They point JAX's persistent compile cache at the CLI's
    shared directory when imported; this test process keeps its own."""
    import jax
    cache = jax.config.jax_compilation_cache_dir
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        return importlib.import_module(name)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


def test_dataset_matches_bench_py(tmp_path):
    jax_bench = import_jax_tool("bench")
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    bench.write_dataset(str(mine), 2, 20)
    jax_bench._write_dataset(str(theirs), 2, 20)
    for name in ("sim.bam", "sim.fa", "regions.bed"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), \
            name


def test_bench_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    proc = subprocess.run(
        [sys.executable, "-m", "hipstr_tpu_torch.bench", "--device", "cpu",
         "--loci", "2", "--deep-loci", "1", "--batch-loci", "1"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert not JAX_KEYS - set(res), JAX_KEYS - set(res)
    assert not PORT_KEYS - set(res), PORT_KEYS - set(res)
    assert "mfu_vs_peak" not in res and "achieved_gflops" not in res
    assert (res["n_loci"], res["success"], res["fail"]) == (1, 1, 0)
    assert (res["shallow_n_loci"], res["shallow_success"],
            res["shallow_fail"]) == (2, 2, 0)
    assert res["value"] == res["loci_per_sec_runs"][0] > 0
    assert res["platform"] == "cpu" == res["device"]["platform"]
    assert res["device"]["cards"] == 1
    assert res["host_workers"] == 1 and res["runs"] == 1
    # the CPU run names no device time: not measured there
    assert res["kernel_ms_per_locus"] is None and res["fetch_ms"] is None
    assert res["peak_device_mib"] is None
    assert res["kernel_shapes"]["P"] > 0
    # warm + timed passes of both workloads, and the two kernel timings
    assert res["dispatches"] >= 2 * 2 + 2
    assert res["card_shards"] == res["dispatches"]      # one device
    assert res["launches"] == dict(emission=0, segment=0, flank_scan=0,
                                   segment_scan=0)


def test_bench_run_f64_matches_the_reference_prefix(tmp_path):
    d = str(tmp_path)
    write_sim(d, reference_loci())
    dt, counters, times = bench.run_e2e(d, CPU, dtype="float64",
                                        max_regions=2, out=f"{d}/b.vcf")
    assert (counters.genotype_success, counters.genotype_fail) == (2, 0)
    assert times["_run_stats"]["dispatches"] > 0 and dt > 0
    assert _body(f"{d}/b.vcf") == _body(REF_VCF)[:2]


@pytest.mark.parametrize("entry", ["bench", "soak", "profile_host"])
def test_entry_points_raise_without_a_card(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = dict(bench=bench.main, soak=soak.main,
                profile_host=profile_host.main)[entry]
    argv = dict(bench=["--loci", "1"],
                soak=["2", "2", "10", str(tmp_path)],
                profile_host=["--loci", "1"])[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)
    assert not os.listdir(tmp_path)


def test_profile_host_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "prof.out")
    stats = profile_host.main(["--device", "cpu", "--loci", "1", "--reads",
                               "10", "--out", out])
    text = capsys.readouterr().out
    assert "e2e:" in text and "success=1 fail=0" in text
    assert os.path.getsize(out) > 0
    assert any(fn[2] == "run_batched" for fn in stats.stats)


def test_profile_host_waits_for_the_warm_up_threads(monkeypatch, capsys):
    """A helper thread that the warm-up run leaves behind (run_batched shuts
    its pools down without waiting) and that returns from its frames while
    cProfile runs must not cost the profiled run its frames: cProfile keeps
    one call stack for every thread, so those returns would pop them."""
    profiled = threading.Event()
    runs = []

    def linger(depth):
        if depth:
            return linger(depth - 1)
        profiled.wait(timeout=0.5)

    def run_e2e(tmp, device):
        runs.append(tmp)
        if len(runs) == 2:                  # the profiled run
            profiled.set()
            return bench.run_e2e(tmp, device)
        res = bench.run_e2e(tmp, device)
        threading.Thread(target=linger, args=(50,)).start()
        return res

    monkeypatch.setattr(profile_host, "run_e2e", run_e2e)
    stats = profile_host.main(["--device", "cpu", "--loci", "1", "--reads",
                               "10"])
    assert "success=1 fail=0" in capsys.readouterr().out
    assert {"run_e2e", "run_batched"} <= {fn[2] for fn in stats.stats}


def test_decode_bench_bam_and_cram(tmp_path):
    d = str(tmp_path)
    write_sim(d, reference_loci()[:2])
    res = decode_bench.main([d])
    assert res["format"] == "bam" and res["records"] == 2 * 3 * 20
    assert res["mb_per_s"] > 0
    res = decode_bench.main(["--cram"])
    assert res["format"] == "cram" and res["records"] == 20


def test_peak_reset_initialises_cuda_first(monkeypatch):
    """A fresh bench or soak process resets the peak memory of every card
    by index, which fails unless CUDA was initialised first."""
    calls = []
    monkeypatch.setattr(torch.cuda, "init", lambda: calls.append("init"))

    def reset(card):
        if "init" not in calls:
            raise RuntimeError("Invalid device argument")
        calls.append(card)

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(bench, "local_devices", lambda device: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    bench.reset_peak_device(torch.device("cuda"))
    assert calls == ["init", torch.device("cuda", 0), torch.device("cuda", 1)]
    bench.reset_peak_device(torch.device("cpu"))
    assert len(calls) == 3
