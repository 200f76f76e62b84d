"""Parity: the port's batched forward HMM (plain segment forward + seed
combination) vs the JAX package's XLA path, `hmm_forward` per locus.

Inputs are the JAX package's own prepared loci, moved into the port's
containers by `locus_to_torch`.  Tolerance 1e-8 in float64: both sides
run the same recurrences in float64 and differ only by summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipstr_tpu.align.hap_generator import HaplotypeGenerator
from hipstr_tpu.align.haplotype import Haplotype
from hipstr_tpu.models.stutter import StutterModel
from hipstr_tpu.ops.hmm import hmm_forward
from hipstr_tpu.parallel.batch_builder import build_demo_batch
from hipstr_tpu.pipeline.genotyper import calc_seed_base
from hipstr_tpu.pipeline.hap_aligner import prepare_locus
from hipstr_tpu.utils.simulate import simulate_locus
from hipstr_tpu_torch.ops.hmm2 import (SMEM_BLOCK, batched_forward,
                                       segment_chain, segment_geometry)
from hipstr_tpu_torch.pipeline.hap_aligner import locus_to_torch, stack_arrays
from test_torch_slice import one_torch_thread  # noqa: F401

TOL = 1e-8


def _port(arrays, statics, h_real, periods):
    R_f, R_r, sr_f, sr_r = statics[:4]
    t = locus_to_torch(arrays, torch.device("cpu"), torch.float64)
    return batched_forward(*t[:7], R_f, R_r, sr_f, sr_r,
                           torch.tensor(h_real, dtype=torch.int32),
                           torch.tensor(periods, dtype=torch.int32),
                           torch.float64).numpy()


def _jax_one(arrays, statics, period):
    R_f, R_r, sr_f, sr_r = statics[:4]
    args = jax.tree.map(jnp.asarray, tuple(arrays[:7]))
    return np.asarray(jax.jit(
        lambda *a: hmm_forward(*a, R_f, R_r, period, sr_f, sr_r,
                               jnp.float64))(*args))


@pytest.mark.parametrize("reads,period", [(12, 3), (8, 2)])
def test_batched_forward_matches_xla(reads, period):
    G = 3
    batch, statics, _ = build_demo_batch(G, n_samples=2,
                                         reads_per_sample=reads,
                                         period=period, dtype="float64")
    R_f, R_r, sr_f, sr_r, per = statics
    args = (batch.l_seg, batch.r_seg, batch.fw_meta, batch.rev_meta,
            batch.seed, batch.seed_codes, batch.seed_quals)

    def one(*a):
        return hmm_forward(*a, R_f, R_r, per, sr_f, sr_r, jnp.float64)

    ref = np.asarray(jax.jit(jax.vmap(one))(*args))
    H = ref.shape[2]
    got = _port(jax.tree.map(np.asarray, args), statics, [H] * G, [per] * G)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def _prepared(seed, period):
    """One simulated locus (2 samples x 10 reads, alleles of 8 and 9
    units), prepared by the JAX package."""
    locus = simulate_locus(seed=seed, n_samples=2, reads_per_sample=10,
                           period=period, ref_units=8, allele_units=[8, 9])
    gen = HaplotypeGenerator(min(a.start for a in locus.alns),
                             max(a.stop for a in locus.alns))
    by_sample = [[], []]
    for a in locus.alns:
        by_sample[locus.sample_names.index(a.name.split("_read")[0])
                  ].append(a)
    assert gen.add_haplotype_block(locus.region, locus.chrom_seq, by_sample,
                                   [], StutterModel.default(period))
    gen.fuse_haplotype_blocks(locus.chrom_seq)
    hap = Haplotype(gen.hap_blocks)
    seeds = [calc_seed_base(a, hap) for a in locus.alns]
    return prepare_locus(hap, [a.sequence for a in locus.alns],
                         [a.base_qualities for a in locus.alns], seeds,
                         "float64")


def test_mixed_period_batch_with_padded_haplotypes():
    """One dispatch holding period-2 and period-3 loci (seeds chosen so
    their bucketed shapes agree) with h_real < H: every locus's real
    columns match hmm_forward at that locus's own period."""
    loci = [_prepared(105, 2), _prepared(102, 3), _prepared(107, 3)]
    statics = [st for _, st in loci]
    assert len({st[:4] for st in statics}) == 1
    h_real = [st[6] for st in statics]
    periods = [st[4] for st in statics]
    H = loci[0][0][2].row_char.shape[0]
    assert periods == [2, 3, 3] and max(h_real) < H
    got = _port(stack_arrays([a for a, _ in loci]), statics[0], h_real,
                periods)
    for g, (arrays, st) in enumerate(loci):
        ref = _jax_one(arrays, st, st[4])
        np.testing.assert_allclose(got[g, :, :h_real[g]], ref[:, :h_real[g]],
                                   rtol=TOL, atol=TOL)
        # padded haplotype columns are NEG garbage the callers slice off
        assert (got[g, :, h_real[g]:] < -1e20).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [64, 128, 256, 512])
def test_segment_geometry_covers_every_chain_once(L, dtype):
    """K2's launch (csrc/segment.cu): every (g, h, p) chain is run by
    exactly one warp, within 1024 threads and 227 KB of shared memory a
    block, from the shortest rows to the longest bucket (R up to 450)."""
    for G, H, P, R in ((1, 1, 1, 2), (3, 5, 7, 50), (2, 16, 64, 130),
                       (4, 8, 96, 450)):
        geom = segment_geometry(G, H, P, L, R, dtype)
        assert geom.threads == 32 * geom.warps <= 1024
        assert geom.smem <= SMEM_BLOCK
        assert geom.lanes_per_thread * 32 == L
        assert geom.shared_lanes == (dtype == torch.float64 and L > 256)
        seen = [segment_chain(geom, (x, y, z), w, P)
                for x in range(geom.grid[0]) for y in range(geom.grid[1])
                for z in range(geom.grid[2]) for w in range(geom.warps)]
        chains = [c for c in seen if c is not None]
        assert len(chains) == len(set(chains)) == G * H * P
        assert set(chains) == {(g, h, p) for g in range(G)
                               for h in range(H) for p in range(P)}


@pytest.mark.parametrize("bad", [
    dict(L=96), dict(L=1024), dict(L=48), dict(dtype=torch.float16),
    dict(P=0), dict(R=1), dict(L=512, R=10000, dtype=torch.float64)],
    ids=["L96", "L1024", "L48", "float16", "no-pools", "one-row",
         "rows-past-shared-memory"])
def test_segment_geometry_refuses_what_the_kernel_does_not_take(bad):
    args = dict(G=2, H=4, P=16, L=128, R=130, dtype=torch.float32)
    args.update(bad)
    with pytest.raises(ValueError, match="segment_forward"):
        segment_geometry(**args)
