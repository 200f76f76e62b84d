"""The port's counterparts of the repository's `__graft_entry__.py`.

`entry()` returns the forward step of the flagship model, the
stutter-aware read<->haplotype HMM forward pass over one simulated locus's
[pools x haplotypes] grid (ops/hmm.hmm_forward), with its example
arguments on the device.  `dryrun_multichip(n)` runs the production
batched pipeline (run_batched: wave scheduling, the HMM dispatches and,
on the card, the device EM and the fused posteriors, each dispatch
sharded over n devices, streaming VCF emission) on a few tiny simulated
loci.  On `cuda` it needs n visible cards and never fakes them; on `cpu`
it places n shards on the CPU, as the JAX dry run uses a virtual CPU mesh.
"""

from __future__ import annotations

import tempfile

import torch

from .align.hap_generator import HaplotypeGenerator
from .align.haplotype import Haplotype
from .device import local_devices, resolve_device
from .models.stutter import StutterModel
from .ops.hmm import hmm_forward
from .pipeline.genotyper import calc_seed_base
from .pipeline.hap_aligner import locus_to_torch, prepare_locus
from .utils.simulate import simulate_locus


def entry(device: str = "cuda"):
    """(fn, example_args): fn(*example_args) is LL [P, H] of the locus the
    JAX entry point simulates (seed 7, 2 samples x 10 reads, period 3) in
    float32, through the port's kernels on the card (K1 + K3; their plain
    versions on the CPU); padded rows and columns included."""
    dev = resolve_device(device)
    locus = simulate_locus(seed=7, n_samples=2, reads_per_sample=10,
                           period=3, ref_units=8)
    by_sample = [[], []]
    for a in locus.alns:
        by_sample[locus.sample_names.index(a.name.split("_read")[0])].append(a)
    gen = HaplotypeGenerator(min(a.start for a in locus.alns),
                             max(a.stop for a in locus.alns))
    if not gen.add_haplotype_block(locus.region, locus.chrom_seq, by_sample,
                                   [], StutterModel.default(3)):
        raise RuntimeError("entry: the simulated locus has no haplotype")
    gen.fuse_haplotype_blocks(locus.chrom_seq)
    hap = Haplotype(gen.hap_blocks)
    seqs = [a.sequence for a in locus.alns]
    quals = [a.base_qualities for a in locus.alns]
    seeds = [calc_seed_base(a, hap) for a in locus.alns]
    arrays, statics = prepare_locus(hap, seqs, quals, seeds, "float32")
    R_f, R_r, sr_f, sr_r, period = statics[:5]

    def fn(l_seg, r_seg, fw_meta, rev_meta, seed_meta, sc, sq):
        # the sequential aligner's mode (compute_hap_log_likelihoods)
        return hmm_forward(l_seg, r_seg, fw_meta, rev_meta, seed_meta, sc,
                           sq, R_f, R_r, period, sr_f, sr_r, torch.float32,
                           mode="fused")

    return fn, locus_to_torch(arrays, dev, torch.float32)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """run_batched over n_devices shards on max(2n, 4) tiny simulated loci;
    asserts every record genotyped, at least one, and (n > 1) a dispatch
    split over the devices.  On `cuda` raises
    unless n_devices cards are visible; on `cpu` the n shards share the
    CPU (the host EM and host posteriors run there)."""
    from .parallel.executor import run_batched
    from .pipeline.processor import GenotyperPipeline, Logger, PipelineOptions
    from .utils.simdata import write_sim

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip: n_devices={n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = local_devices(dev)
        if len(cards) < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} cards, "
                               f"{len(cards)} visible")
        devices = cards[:n_devices]
    else:
        devices = [dev] * n_devices
        print(f"dryrun_multichip: {n_devices} shards on the CPU")
    n_loci = max(2 * n_devices, 4)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        write_sim(tmp, [simulate_locus(seed=50 + i, n_samples=2,
                                       reads_per_sample=16,
                                       period=2 + (i % 2), ref_units=8,
                                       chrom=f"chrD{i}")
                        for i in range(n_loci)])
        opts = PipelineOptions(min_reads=10, use_unpaired=True,
                               dtype="float32")
        pipeline = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa",
                                     opts, Logger(quiet=True))
        # waves of 2n loci: each shape group of them splits over the n
        counters = run_batched(pipeline, f"{tmp}/regions.bed",
                               f"{tmp}/out.vcf", dev,
                               batch_size=2 * n_devices, devices=devices)
        with open(f"{tmp}/out.vcf") as fh:
            records = [l for l in fh if not l.startswith("#")]
    stats = pipeline.last_run_stats
    if not counters.genotype_success == len(records) > 0:
        raise AssertionError(f"dryrun_multichip: {len(records)} records, "
                             f"counters {counters}")
    if n_devices > 1 and stats["card_shards"] <= stats["dispatches"]:
        raise AssertionError(f"dryrun_multichip: no dispatch was split "
                             f"over the devices: {stats}")
    print(f"dryrun_multichip ok: {n_devices} {dev.type} shards, "
          f"{len(records)}/{n_loci} loci genotyped through run_batched "
          f"({stats['dispatches']} dispatches in {stats['card_shards']} "
          f"card-shards, {stats['em_waves']} device EM waves)")

