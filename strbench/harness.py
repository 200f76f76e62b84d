"""One run of one cell: make the inputs from the seed, start the user's
default genotyping run (`python -m hipstr_tpu_torch.cli` at its defaults
on the card host: the host worker pool of 4, batches of 32 loci, float32,
no stutter model) in a thread of this process, open the window once the
pool has answered and the configuration's warm-up loci have settled,
measure for `--seconds`, then judge what the window produced against the
plain reference and print the result line.

End-to-end (`--trace 0`): loci_per_s, the loci whose worker settled them
(each "settled" reply on the pool's pipes, in any order) between the
window's open and close over its seconds; peak_host_mib, the peak over the
window of the summed anonymous memory of this process and its descendants
(`memwatch`); setup_s, the process's age at the window's open less the
seconds this run spent generating its inputs (the benchmark's own work,
done once per seed in a checkout).  A locus of the window that settles
without its VCF record has failed.  The pool is then stopped: nothing
restarts it.  Per-layer (`--trace 1`): torch.profiler over the window;
then the run drains (every further locus is handed out as a region too
long to genotype) and ends, since the workers hand their timers over only
at the end; the readers of strbench/metrics take what they need.
"""

from __future__ import annotations

import json
import math
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from . import check, spec
from .capture import Hooks
from .trace import DeviceTrace, reduce

BUILD = spec.ROOT / "build" / "strbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "hipstr_tpu")
TRACED_RUN_LIMIT_S = 300.0       # a traced run's end, from process start


def log(msg: str) -> None:
    print(f"[strbench] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (its start in /proc)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries that would load JAX by themselves are kept from it."""
    caches = BUILD / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(caches / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_truth(data_dir: str) -> dict:
    """Each locus's reads' length changes per sample, as the generator
    made them, and each locus's period, by contig."""
    loci = json.loads(Path(data_dir, "truth.json").read_text())
    period = {}
    for line in Path(data_dir, "regions.bed").read_text().splitlines():
        cols = line.split("\t")
        period[cols[0]] = int(cols[3])
    return dict(loci=loci, period=period)


class MemWatch:
    """strbench.memwatch over this process's tree, in a process of its own
    (reading smaps here would take the run's own interpreter from it)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "strbench.memwatch", str(os.getpid())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=spec.ROOT)
        self.peak, self.n, self.source = 0, 0, "-"

    def say(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def off(self) -> None:
        self.say("off")
        peak, n, self.source = self.proc.stdout.readline().split()
        self.peak, self.n = int(peak), int(n)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.say("quit")
        self.proc.wait(timeout=30)


class Run(threading.Thread):
    """cli.run_args on the argv, as the user's CLI runs it."""

    def __init__(self, argv):
        super().__init__(daemon=True)
        self.argv, self.error, self.t0, self.t1 = argv, None, None, None

    def run(self):
        from hipstr_tpu_torch import cli
        self.t0 = time.perf_counter()
        try:
            cli.run_args(cli.build_parser().parse_args(self.argv))
        except BaseException as exc:      # reported, or expected once stopped
            self.error = exc
        self.t1 = time.perf_counter()


def stop_pool(run: Run) -> None:
    """End the run after the window: its host workers are terminated, the
    parent's reader threads see their pipes close and run_pooled raises
    out of the run, which this waits for."""
    for proc in mp.active_children():
        proc.terminate()
    for proc in mp.active_children():
        proc.join(timeout=30)
    run.join(timeout=120)


def cli_argv(cfg: dict, data: str, info: dict, out_vcf: str,
             device) -> list:
    return ["--bams", f"{data}/sim.bam", "--fasta", f"{data}/sim.fa",
            "--regions", f"{data}/regions.bed", "--snp-vcf",
            f"{data}/{info['snp_vcf']}", "--str-vcf", out_vcf,
            "--host-workers", str(cfg["host_workers"]),
            "--batch-loci", str(cfg["batch_loci"]), "--dtype", cfg["dtype"],
            "--device", device.type] + list(cfg["cli"])


def run_cell(cell: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, bench: dict) -> tuple:
    """(result dict, [(name, value, limit)]) of one run."""
    import torch
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    cache_env()
    from .traffic.generate import dataset
    data, info = dataset(str(BUILD / "data"), cfg, traffic, seed,
                         workers=min(8, len(os.sched_getaffinity(0))),
                         log=log)
    truth = load_truth(data)
    out_dir = BUILD / "runs" / cell_name
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = cli_argv(cfg, data, info, str(out_dir / "out.vcf"), device)
    hooks = Hooks(seed, cfg["em_sample"], cfg["dispatch_sample"],
                  cfg["loci_per_dispatch"], launches=trace, loci=cfg["loci"],
                  record_every=cfg["record_every"]).install()
    mem, run = MemWatch(), Run(argv)
    dt = DeviceTrace() if trace else None
    try:
        run.start()
        warm = cfg["warmup_loci"]
        while True:
            if len(hooks.settles) >= warm:
                break
            if not run.is_alive():
                raise RuntimeError(f"the run ended before the window opened: "
                                   f"{run.error!r}")
            time.sleep(0.01)
        if trace:
            hooks.spans.on = True
            dt.start()
        hooks.recording = True
        t_open = time.perf_counter()
        done_open = hooks.pipeline.loci_done
        settled_open = len(hooks.settles)
        setup_s = process_age() - (0.0 if info["cached"] else
                                   info["seconds"])
        mem.say("on")
        log(f"window open {t_open - run.t0:.3f} s into the run, at locus "
            f"{done_open} in BED order, {settled_open} settled")
        t_close = t_open + seconds
        while time.perf_counter() < t_close:
            if not run.is_alive():
                raise RuntimeError(
                    "the dataset ran out inside the window: the run settled "
                    f"every locus ({len(hooks.settles)}); {run.error!r}")
            time.sleep(min(0.01, max(0.0, t_close - time.perf_counter())))
        done_close = hooks.pipeline.loci_done
        t_close = time.perf_counter()
        hooks.recording = False
        mem.off()
        if trace:
            dt.stop()
            hooks.spans.on = False
        mem_peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
        if trace:
            # no further locus is genotyped: the run ends once those handed
            # out have settled, and the workers hand over their timers
            hooks.drain = True
            run.join(timeout=max(1.0, TRACED_RUN_LIMIT_S - process_age()))
            if run.is_alive() or run.error is not None:
                raise RuntimeError(f"the traced run did not end cleanly: "
                                   f"{run.error!r}")
        else:
            stop_pool(run)
    finally:
        mem.close()
        if run.is_alive():
            stop_pool(run)
        hooks.remove()
    window_s = t_close - t_open
    hooks.t_open, hooks.t_close = t_open, t_close
    in_window = [rec for t, _, rec in hooks.settles if t_open < t <= t_close]
    attempted = len(in_window)
    failed = sum(1 for rec in in_window if rec is None)
    for text in hooks.error_lines[:5]:
        log(f"the program logged: {text}")
    result = dict(attempted=attempted, failed=failed)
    if trace:
        tr = reduce(dt.events(), hooks.spans.rows,
                    int(t_open * 1e9), int(t_close * 1e9))
        record = layer_record(hooks, run, tr, cfg["dtype"])
        metrics = {}
        for m in spec.metrics_of(bench, cell_name, "per_layer"):
            v = spec.reader(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        result.update(metrics=metrics, busy_s=tr["busy_s"],
                      window_s=tr["window_s"],
                      breakdown=dict(device_ops=tr["device_ops"],
                                     idle_gaps=tr["idle_gaps"]))
    else:
        e2e = dict(loci_per_s=attempted / window_s,
                   peak_host_mib=mem.peak / 2 ** 20,
                   setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result["metrics"] = {k: dict(value=v, unit=units[k])
                             for k, v in e2e.items()
                             if k in {m["name"] for m in spec.metrics_of(
                                 bench, cell_name, "end_to_end")}}
    log(f"window {window_s:.3f} s: {attempted} loci settled, BED order "
        f"{done_open} -> {done_close}, memory from {mem.source}, "
        f"setup {setup_s:.3f} s, dataset {info['dir']} "
        f"({'cached' if info['cached'] else 'generated'} "
        f"{info['seconds']} s, {info['bytes']} bytes), EM waves "
        f"{hooks.em_waves} ({hooks.em_problems} loci), memory samples "
        f"{mem.n}")
    (out_dir / "last_run.json").write_text(json.dumps(dict(
        seed=seed, trace=trace, t_run0=run.t0, t_open=t_open,
        t_close=t_close, done_open=done_open, done_close=done_close,
        setup_s=setup_s, dataset=info,
        settle_times=[t for t, _, _ in hooks.settles])))
    result["memory_peak_bytes"] = mem_peak
    # the reference runs once the program's state is freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums = check.numbers(hooks, truth, device,
                         record_sample=cfg["record_sample"])
    ok, rows = check.verdict(nums, limits, failed, attempted)
    log(f"reference checks took {time.perf_counter() - t0:.3f} s")
    result["correct"] = ok
    return result, rows


def layer_record(hooks, run: Run, tr: dict, dtype: str) -> dict:
    """What the per-layer readers read: the whole run's timers (the
    workers' with " (workers)"), counters and launch counts, the loci it
    genotyped (those after the window's close were settled unread), and the
    window's trace and captured launches."""
    from hipstr_tpu_torch import kernels
    p = hooks.pipeline
    loci = len(hooks.settles) - len(hooks.skipped)
    return dict(timers=dict(p.timer.totals), loci=loci,
                wall_s=run.t1 - run.t0, stats=dict(p.last_run_stats),
                launches=dict(kernels.LAUNCHES),
                locus_rounds=hooks.locus_rounds, trace=tr,
                captured=hooks.launches, dtype=dtype)


def main(args) -> int:
    import importlib.util
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if importlib.util.find_spec("hipstr_tpu_torch") is None:
        log("the program (hipstr_tpu_torch) is not in this checkout")
        return 2
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA device, or fewer than the {chips} the cell needs")
        return 3
    device = torch.device("cuda")
    result, rows = run_cell(cell, args.workload, args.seed, args.seconds,
                            bool(args.trace), device, bench)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package is loaded: {found[:10]}")
        return 5
    return emit(result, rows, dict(
        platform="gpu", kind=torch.cuda.get_device_name(device),
        count=chips), bool(args.trace))


def _num(v):
    """A number for the JSON line (a non-finite one as its text)."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def emit(result: dict, rows: list, device: dict, trace: bool) -> int:
    """The numbers compared, beside their limits, as the last lines on
    standard error; the result as the last line of standard output."""
    device = dict(device, memory_peak_bytes=int(result["memory_peak_bytes"]))
    if trace:
        device.update(busy_s=result["busy_s"], window_s=result["window_s"])
    line = dict(correct=bool(result["correct"]),
                attempted=int(result["attempted"]),
                failed=int(result["failed"]), metrics=result["metrics"],
                device=device)
    if trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {n: dict(value=_num(v), limit=l) for n, v, l in rows}
    for n, v, l in rows:
        print(f"check {n} = {v!r} (limit {l!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
