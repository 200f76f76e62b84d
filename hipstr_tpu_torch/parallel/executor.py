"""Multi-locus batched execution, each dispatch sharded over the devices.

Counterpart of hipstr_tpu/parallel/executor.py.  The host prepares a wave
of loci (filters, haplotype generation, pooling, seeds: each locus's host
life is pipeline/locus_host.py's, as in a pool's worker), groups them by
kernel shape, and dispatches every group's read<->haplotype alignment
(K1 emission + K2 segment forward per orientation, seed combination, and
on the card the fused posteriors) before fetching any result, so device
work overlaps host work across waves.  The adaptive per-locus rounds
regroup and dispatch together.

Every dispatch is split over a list of devices, by default
`device.local_devices` (every visible card for `cuda`), as the JAX
executor shards it over its locus mesh: `shard_bounds` cuts the chunk's
loci into contiguous shards in the mesh's order, each shard runs on its
own card's stream, and the fetch joins them in locus order.  A list may
repeat a device, so several shards can share one card or the CPU.  The
device EM, the sequential path and the de novo contractions stay on the
first device, as they run on JAX's default device.

Without a stutter model, on the card the stutter models of each wave are
learned together before its dispatch (ops/em_batched.em_train_batch, in
the run's dtype); on the CPU each locus keeps the host EM (ops/em.py), the
golden-parity path.

Differences from the JAX executor: chunks are stacked with numpy and moved
with `torch.from_numpy(...).to(device)`; the locus axis is padded only to
the real group size (kernels take runtime extents), in the EM too; the
period is always runtime data, so groups merge across periods.  Only host
errors are counted per locus (`genotype_fail`): an exception from a
dispatch, the EM, a kernel build or launch, or a fetch propagates and
fails the run.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import local_devices, resolve_dtype
from ..io.regions import read_regions
from ..io.vcf_write import VCFWriter, build_vcf_header
from ..models.stutter import write_stutter_models
from ..ops.em_batched import em_train_batch, pack_problems
from ..ops.em_problem import EMProblem
from ..ops.hmm2 import batched_forward
from ..ops.posteriors import batched_pool_posteriors
from ..pipeline.hap_aligner import locus_to_torch
from ..pipeline.locus_host import LocusHost
from ..pipeline.locus_pack import stack_arrays


def _leaf_shapes(x) -> tuple:
    if isinstance(x, dict):
        return tuple(_leaf_shapes(x[k]) for k in sorted(x))
    if isinstance(x, tuple):
        return tuple(_leaf_shapes(v) for v in x)
    return np.shape(x)


class LocusWorkItem:
    """A locus's round packed for a dispatch (the arrays and statics of
    pipeline/locus_pack); `order` is its BED index and `rounds` the
    dispatches it has ridden."""

    def __init__(self, arrays, statics, order=0):
        self.arrays = arrays
        self.statics = statics
        self.order = order
        self.rounds = 0

    def shape_key(self):
        # the period is runtime data: groups merge across periods
        st = self.statics
        return (st[:4] + (st[7],), _leaf_shapes(self.arrays))


def shard_bounds(G: int, n: int) -> List[Tuple[int, int]]:
    """[start, stop) of the n contiguous shards of ceil(G / n) loci that a
    dispatch of G loci is cut into: GSPMD's even split of a locus axis
    padded to a multiple of n, less the padding.  The port's kernels take
    runtime extents, so nothing is padded; shards past the last locus are
    empty."""
    size = -(-G // n)
    return [(min(i * size, G), min((i + 1) * size, G)) for i in range(n)]


class BatchedAligner:
    """Groups per-locus prepared arrays by kernel shape and dispatches each
    group as one (or a few) batched device calls, each sharded over
    `devices` (a list of torch devices, repeats allowed), all enqueued
    before any caller fetches.  `dispatches` counts chunks; `card_shards`
    counts the non-empty shards launched, one K1 and K2 pair per
    orientation each, so the launch counters count card-shards."""

    def __init__(self, devices: List[torch.device], dtype: str = "float32",
                 batch_size: int = 32, logger=None):
        self.devices = list(devices)
        self.torch_dtype = resolve_dtype(dtype)
        self.batch_size = batch_size
        self.groups: Dict[tuple, List[LocusWorkItem]] = {}
        self.logger = logger
        self._logged_mesh = False
        # per-shape dispatch accounting: key -> [dispatches, loci]
        self.stats: Dict[tuple, list] = {}
        self.dispatches = 0
        self.card_shards = 0
        self.round_hist: Dict[int, int] = {}

    def finalize(self, item) -> None:
        """Record a settled locus's round count."""
        self.round_hist[item.rounds] = self.round_hist.get(item.rounds, 0) + 1

    def log_stats(self, spec_hits: int = 0, spec_misses: int = 0) -> None:
        if self.logger is None or not self.stats:
            return
        for key, (n, real) in sorted(self.stats.items()):
            R_f, R_r = key[:2]
            self.logger.log(f"Dispatch shape R={R_f}+{R_r}: {n} dispatches, "
                            f"{real} loci")
        if self.round_hist:
            hist = ", ".join(f"{r}: {c}" for r, c in
                             sorted(self.round_hist.items()))
            self.logger.log(f"Device rounds per locus: {{{hist}}}")
        if spec_hits or spec_misses:
            self.logger.log(
                f"Speculation: {spec_hits}/{spec_hits + spec_misses} "
                f"allele-addition rounds served by column gather "
                f"({spec_misses} realignment dispatches)")

    def add(self, item: LocusWorkItem) -> None:
        self.groups.setdefault(item.shape_key(), []).append(item)

    def dispatch_all(self) -> List[Tuple[List[LocusWorkItem], object]]:
        """Dispatch every pending group (chunked to batch_size); returns
        [(chunk_items, device results)] without waiting for any."""
        out = []
        for key in list(self.groups):
            group = self.groups.pop(key)
            for i in range(0, len(group), self.batch_size):
                chunk = group[i:i + self.batch_size]
                out.append((chunk, self._dispatch_chunk(chunk)))
        return out

    def _dispatch_chunk(self, chunk: List[LocusWorkItem]):
        """Enqueue one chunk, shard by shard; returns each non-empty
        shard's device results in locus order (see `_fetch`)."""
        G = len(chunk)
        st = self.stats.setdefault(tuple(chunk[0].statics[:4]), [0, 0])
        st[0] += 1
        st[1] += G
        self.dispatches += 1
        for it in chunk:
            it.rounds += 1
        n = len(self.devices)
        if n > 1 and not self._logged_mesh and self.logger is not None:
            self.logger.log(f"Sharding locus batches over {n} devices")
            self._logged_mesh = True
        shards = []
        for dev, (a, b) in zip(self.devices, shard_bounds(G, n)):
            if a < b:
                shards.append(self._dispatch_shard(chunk[a:b], dev))
                self.card_shards += 1
        return shards

    def _dispatch_shard(self, part: List[LocusWorkItem], dev: torch.device):
        """K1 -> K2 x 2 -> seed combination (-> fused posteriors) for one
        shard's loci on `dev`; enqueued on that device's stream."""
        dt = self.torch_dtype
        t = locus_to_torch(stack_arrays([it.arrays for it in part]), dev, dt)
        R_f, R_r, sr_f, sr_r = part[0].statics[:4]
        Sm = part[0].statics[7]
        h_real = torch.tensor([it.statics[6] for it in part],
                              dtype=torch.int32).to(dev)
        periods = torch.tensor([it.statics[4] for it in part],
                               dtype=torch.int32).to(dev)
        LL = batched_forward(*t[:7], R_f, R_r, sr_f, sr_r, h_real, periods, dt)
        if Sm is None:
            return LL
        log_post, totals = batched_pool_posteriors(LL, t[7], Sm, dt)
        return LL, log_post, totals


def device_post_enabled(device: torch.device) -> bool:
    """Fuse the genotype posteriors into each dispatch on the card; the CPU
    keeps the host float64 posteriors (the golden-parity path)."""
    return device.type == "cuda"


def device_em_enabled(opts, device: torch.device) -> bool:
    """Learn the stutter models of each wave together on the card
    (ops/em_batched.py) when no model is given; the CPU keeps the host
    per-locus EM (the golden-parity path)."""
    return (opts.def_stutter_model is None and not opts.stutter_in
            and device.type == "cuda")


class EMStats:
    """The device EM's waves and the histogram of its iteration counts."""

    def __init__(self):
        self.waves = 0
        self.iter_hist: Dict[int, int] = {}

    def as_dict(self) -> dict:
        return dict(em_waves=self.waves, em_iter_hist=dict(
            sorted(self.iter_hist.items())))


def solve_em(problems: List[EMProblem], opts, device: torch.device,
             stats: EMStats):
    """Train the stutter models of a wave in one em_train_batch call on
    `device`, in the run's dtype; returns (params [G, 6] float64 numpy,
    converged [G] numpy)."""
    arrays, (_, _, Sm) = pack_problems(problems)
    out = em_train_batch(arrays, Sm, device, resolve_dtype(opts.dtype),
                         max_iter=opts.max_em_iter,
                         min_LL_abs_change=opts.abs_ll_converge,
                         min_LL_frac_change=opts.frac_ll_converge)
    params = out["params"].cpu().numpy().astype(np.float64)
    conv = out["converged"].cpu().numpy()
    stats.waves += 1
    for n in out["iters"].cpu().tolist():
        stats.iter_hist[n] = stats.iter_hist.get(n, 0) + 1
    return params, conv


def open_vcf(pipeline, out_vcf: Optional[str], full_command: str):
    """The run's VCF writer, or None without an output path."""
    if not out_vcf:
        return None
    header = build_vcf_header(pipeline.fasta_path, full_command,
                              pipeline.fasta.contig_header_lines(),
                              pipeline.samples, pipeline.opts.output)
    return VCFWriter(out_vcf, header)


def close_outputs(pipeline, writer) -> None:
    """Close the run's VCF, viz and pass/filt BAM writers and write
    --stutter-out (the tail of the JAX package's run)."""
    for w in (writer, pipeline.viz_writer, pipeline.pass_writer,
              pipeline.filt_writer):
        if w is not None:
            w.close()
    if pipeline.opts.stutter_out:
        with open(pipeline.opts.stutter_out, "w") as fh:
            write_stutter_models(pipeline._stutter_out, fh)


def _fetch(shards):
    """One dispatch's results on the host: each shard's LL (or (LL,
    log_post, totals)) fetched and joined along the locus axis in shard
    order, which is locus order."""
    parts = [tuple(r.cpu().numpy() for r in res) if isinstance(res, tuple)
             else (res.cpu().numpy(),) for res in shards]
    out = parts[0] if len(parts) == 1 else tuple(
        np.concatenate(xs) for xs in zip(*parts))
    return out if len(out) > 1 else out[0]


def dispatch_devices(device: torch.device, devices=None) -> List[torch.device]:
    """The devices a run's dispatches are sharded over: `devices` when
    given, else every local device of `device` (device.local_devices)."""
    out = [torch.device(d) for d in (devices if devices is not None
                                     else local_devices(device))]
    if not out or len({d.type for d in out}) > 1:
        raise ValueError(f"dispatch devices {out}: none, or of mixed types")
    return out


def run_batched(pipeline, regions_bed: str, out_vcf: Optional[str],
                device: torch.device, batch_size: int = 32,
                full_command: str = "hipstr-tpu-torch", devices=None):
    """Batched genotyping run; the JAX executor's outputs.  Each dispatch
    is sharded over `devices` (a list of torch devices, repeats allowed;
    default every local device of `device`); the device EM runs on the
    first of them."""
    opts = pipeline.opts
    regions = read_regions(regions_bed, opts.max_regions, opts.chrom,
                           opts.locus_shard)
    devices = dispatch_devices(device, devices)
    device = devices[0]
    writer = open_vcf(pipeline, out_vcf, full_command)

    aligner = BatchedAligner(devices, opts.dtype, batch_size, pipeline.logger)
    # records enter the writer in BED order; loci settle out of order
    pending: Dict[int, Tuple] = {}
    next_emit = [0]
    # loci settled in BED order so far, read by a progress sampler
    pipeline.loci_done = 0

    def drain_pending():
        while next_emit[0] in pending:
            rec, viz = pending.pop(next_emit[0])
            if rec is not None and writer is not None:
                writer.add_vcf_record(*rec)
            if viz is not None and pipeline.viz_writer is not None:
                pipeline.viz_writer.add(*viz)
            next_emit[0] += 1
            pipeline.loci_done = next_emit[0]

    items: Dict[int, LocusWorkItem] = {}   # BED index -> its packed round
    prepared: List[LocusWorkItem] = []     # rounds for the next dispatch
    # (BED index, EMProblem) of loci whose stutter model the next wave
    # learns on the device
    em_staged: List[Tuple[int, EMProblem]] = []

    def emit(msg) -> None:
        """Route a message of the loci's host (pipeline/locus_host)."""
        tag = msg[0]
        if tag == "ready":
            _, idx, arrays, statics = msg
            item = items.get(idx)
            if item is None:
                item = items[idx] = LocusWorkItem(arrays, statics, idx)
            item.arrays, item.statics = arrays, statics
            prepared.append(item)
        elif tag == "em":
            em_staged.append(msg[1:])
        elif tag == "settled":
            idx = msg[1]
            if idx in items:
                aligner.finalize(items.pop(idx))
            pending[idx] = msg[2:]
            drain_pending()
        else:
            pipeline.logger.log(msg[1])

    # native trace batches release the GIL; size the pool to spare cores
    trace_pool = cf.ThreadPoolExecutor(
        max_workers=max(2, min(3, (os.cpu_count() or 2) - 1)))
    # fetches start the moment a wave is dispatched, so the copy back
    # overlaps the next wave's host work
    fetch_pool = cf.ThreadPoolExecutor(max_workers=4)
    host = LocusHost(pipeline, emit, device_em=device_em_enabled(opts, device),
                     device_post=device_post_enabled(device),
                     trace_pool=trace_pool, trace_threads=2)

    def dispatch():
        """Dispatch the rounds packed so far; their fetches start at once."""
        for item in prepared:
            aligner.add(item)
        prepared.clear()
        return [(chunk, fetch_pool.submit(_fetch, res))
                for chunk, res in aligner.dispatch_all()]

    def finish_handles(handles) -> None:
        """Resolve in-flight fetches and drive every adaptive round of the
        wave to completion, regrouping realignments per round."""
        while handles:
            with pipeline.timer.time("Device fetch"):
                handles = [(chunk, fut.result()) for chunk, fut in handles]
            installed: List[int] = []
            for chunk, res in handles:
                LL_all, *post = res if isinstance(res, tuple) else (res,)
                for gi, item in enumerate(chunk):
                    P_real, H_real = item.statics[5], item.statics[6]
                    if host.install(item.order, LL_all[gi, :P_real, :H_real],
                                    *(x[gi] for x in post)):
                        installed.append(item.order)
            finished = [idx for idx in installed if host.step(idx)]
            for idx in finished:
                host.record(idx)
            handles = dispatch()

    em_stats = EMStats()
    in_flight: List[Tuple[List[LocusWorkItem], object]] = []

    def launch_wave():
        """Learn the staged stutter models (reference train loop
        src/em_stutter_genotyper.cpp:170-226), dispatch the prepared loci,
        then settle the previous wave while this one computes."""
        nonlocal in_flight
        if em_staged:
            staged = em_staged[:]
            em_staged.clear()
            with pipeline.timer.time("Stutter estimation (device)"):
                params, conv = solve_em([prob for _, prob in staged], opts,
                                        device, em_stats)
            for i, (idx, _) in enumerate(staged):
                host.resume(idx, params[i], conv[i])
        done, in_flight = in_flight, dispatch()
        finish_handles(done)

    try:
        for order, region in enumerate(regions):
            pipeline.logger.log(f"Preparing region {region} ...")
            # host errors fail the locus; the device wave below runs
            # outside the host, so device errors end the run
            host.begin(order, region)
            if len(prepared) + len(em_staged) >= batch_size:
                launch_wave()

        launch_wave()            # dispatch the tail, settle the previous wave
        finish_handles(in_flight)
        in_flight = []
    finally:
        trace_pool.shutdown(wait=False)
        fetch_pool.shutdown(wait=False)
    drain_pending()
    aligner.log_stats(host.spec_hits, host.spec_misses)
    pipeline.last_run_stats = dict(
        round_hist={int(k): int(v) for k, v in aligner.round_hist.items()},
        spec_hits=int(host.spec_hits),
        spec_misses=int(host.spec_misses),
        dispatches=int(aligner.dispatches),
        card_shards=int(aligner.card_shards), cards=len(set(devices)),
        shards_per_dispatch=len(devices),
        **em_stats.as_dict())

    close_outputs(pipeline, writer)
    return pipeline.counters
