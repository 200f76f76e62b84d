"""The sequential per-locus run (`--batch-loci 0`) on one torch device.

Counterpart of hipstr_tpu/pipeline/processor.py::GenotyperPipeline.run:
the same regions, writer, counters, `too_long` check and closing of the
pass/filt/viz writers and `--stutter-out`.  Each locus goes through the
port's copy of the host code (`GenotyperPipeline.analyze_region`: filters,
the host stutter EM when no model is given, haplotype generation, the
genotyper's adaptive rounds, the VCF record), whose alignment calls land
in the port's `compute_hap_log_likelihoods` on the installed device.

Difference from the JAX run: a DeviceError (a kernel that fails to build
or launch, a failed transfer) ends the run instead of failing one locus.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..io.regions import read_regions
from ..kernels import DeviceError
from ..parallel.executor import close_outputs, open_vcf
from . import hap_aligner


def run_sequential(pipeline, regions_bed: str, out_vcf: Optional[str],
                   device: torch.device,
                   full_command: str = "hipstr-tpu-torch"):
    """Genotype every region one locus at a time on `device`; returns the
    pipeline's counters.  Host errors fail one locus; DeviceError ends the
    run."""
    opts = pipeline.opts
    regions = read_regions(regions_bed, opts.max_regions, opts.chrom,
                           opts.locus_shard)
    writer = open_vcf(pipeline, out_vcf, full_command)
    prev = hap_aligner.use_device(device)
    # loci settled so far, read by a progress sampler
    pipeline.loci_done = 0
    try:
        chrom = chrom_seq = None
        for done, region in enumerate(regions):
            pipeline.loci_done = done
            if region.stop - region.start > opts.max_str_len:
                pipeline.counters.too_long += 1
                continue
            if not pipeline.fasta.has_chrom(region.chrom):
                raise RuntimeError(f"chromosome {region.chrom} missing from "
                                   "FASTA")
            if region.chrom != chrom:
                chrom = region.chrom
                chrom_seq = pipeline.fasta.get_sequence(chrom)
            pipeline.logger.log(f"Processing region {region} ...")
            try:
                pipeline.analyze_region(region, chrom_seq, writer)
            except DeviceError:
                raise
            except Exception as exc:  # a host error fails only this locus
                pipeline.counters.genotype_fail += 1
                pipeline.logger.log(f"ERROR at {region}: {exc!r}")
        pipeline.loci_done = len(regions)
    finally:
        hap_aligner.use_device(prev)
    close_outputs(pipeline, writer)
    return pipeline.counters
