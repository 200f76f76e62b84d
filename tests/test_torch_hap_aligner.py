"""The port's prepare_locus packs a locus exactly as the JAX package does
on the CPU (`_CPU_BUCKETS`), array for array, and locus_to_torch carries
either package's pytree into the port's containers unchanged."""

import numpy as np
import pytest
import torch

from hipstr_tpu.align.hap_generator import HaplotypeGenerator
from hipstr_tpu.align.haplotype import Haplotype
from hipstr_tpu.models.stutter import StutterModel
from hipstr_tpu.pipeline import hap_aligner as jax_aligner
from hipstr_tpu.pipeline.genotyper import calc_seed_base
from hipstr_tpu.utils.simulate import simulate_locus
from hipstr_tpu_torch.pipeline import hap_aligner as port_aligner
from test_torch_slice import one_torch_thread  # noqa: F401


def _locus(seed, period, n_samples=2, reads=12):
    locus = simulate_locus(seed=seed, n_samples=n_samples,
                           reads_per_sample=reads, period=period, ref_units=8,
                           allele_units=[8, 10])
    gen = HaplotypeGenerator(min(a.start for a in locus.alns),
                             max(a.stop for a in locus.alns))
    by_sample = [[] for _ in range(n_samples)]
    for a in locus.alns:
        by_sample[locus.sample_names.index(a.name.split("_read")[0])
                  ].append(a)
    assert gen.add_haplotype_block(locus.region, locus.chrom_seq, by_sample,
                                   [], StutterModel.default(period))
    gen.fuse_haplotype_blocks(locus.chrom_seq)
    hap = Haplotype(gen.hap_blocks)
    seeds = [calc_seed_base(a, hap) for a in locus.alns]
    return (hap, [a.sequence for a in locus.alns],
            [a.base_qualities for a in locus.alns], seeds)


def _post_meta(n_reads, n_samples, H):
    rng = np.random.default_rng(n_reads)
    return dict(pool_row=rng.integers(0, 4, n_reads).astype(np.int32),
                mate_index=np.arange(n_reads, dtype=np.int32),
                has_mate=np.zeros(n_reads, bool),
                read_ok=np.ones(n_reads, bool),
                weights=np.ones(n_reads), log_p1=np.full(n_reads, -0.69),
                log_p2=np.full(n_reads, -0.69),
                sample=rng.integers(0, n_samples, n_reads).astype(np.int32),
                num_samples=n_samples, haploid=False,
                col_index=np.arange(H, dtype=np.int32))


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        if hasattr(a, "_fields"):
            assert a._fields == b._fields
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,period,dtype", [(11, 2, "float64"),
                                               (12, 3, "float32"),
                                               (13, 4, "float64")])
def test_prepare_locus_matches_jax(seed, period, dtype):
    hap, seqs, quals, seeds = _locus(seed, period)
    pm = _post_meta(len(seqs), 2, hap.num_combs)
    want = jax_aligner.prepare_locus(hap, seqs, quals, seeds, dtype,
                                     post_meta=pm)
    got = port_aligner.prepare_locus(hap, seqs, quals, seeds, dtype,
                                     post_meta=pm)
    assert got[1] == want[1]                      # statics
    _assert_same(got[0], want[0])


def test_locus_to_torch_reads_fields_by_name():
    hap, seqs, quals, seeds = _locus(14, 3)
    arrays, _ = jax_aligner.prepare_locus(hap, seqs, quals, seeds, "float64")
    t = port_aligner.locus_to_torch(arrays, torch.device("cpu"),
                                    torch.float32)
    assert type(t[2]).__module__ == "hipstr_tpu_torch.ops.hmm"
    for src, dst in zip(arrays[:5], t[:5]):
        for f in dst._fields:
            a, b = np.asarray(getattr(src, f)), getattr(dst, f)
            if a.dtype.kind == "f":
                assert b.dtype == torch.float32
                np.testing.assert_array_equal(b.numpy(), a.astype(np.float32))
            else:
                np.testing.assert_array_equal(b.numpy(), a)
