"""Parity: the port's fused genotype posteriors vs the JAX package's
`batched_pool_posteriors` (float64, 1e-10), with speculative column
gathers, mate pairs, padded reads, unused reads and a haploid locus."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipstr_tpu.ops.posteriors import batched_pool_posteriors as jax_post
from hipstr_tpu_torch.ops.posteriors import batched_pool_posteriors
from test_torch_slice import one_torch_thread  # noqa: F401


def _batch(seed, G=3, P=6, H=4, R=12, n_samples=3, Sm=4, n_pad=3):
    rng = np.random.default_rng(seed)
    LL = rng.uniform(-60.0, -1.0, (G, P, H))
    pool_row = rng.integers(0, P, (G, R)).astype(np.int32)
    mate_index = np.tile(np.arange(R, dtype=np.int32), (G, 1))
    has_mate = np.zeros((G, R), bool)
    for g in range(G):                      # reads 0/1 and 4/5 are mates
        for a, b in ((0, 1), (4, 5)):
            mate_index[g, a], mate_index[g, b] = b, a
            has_mate[g, [a, b]] = True
    read_ok = rng.random((G, R)) > 0.1
    weights = np.ones((G, R))
    weights[:, R - n_pad:] = 0.0            # bucket-padding reads
    read_ok[:, R - n_pad:] = False
    log_p1 = np.log(rng.uniform(0.05, 0.95, (G, R)))
    log_p2 = np.log1p(-np.exp(log_p1))
    sample = rng.integers(0, n_samples, (G, R)).astype(np.int32)
    sample[:, R - n_pad:] = 0
    # speculative dispatch: the current alleles are a subset of the
    # dispatched haplotype columns, in another order
    col_index = np.array([[0, 1, 2, 3], [2, 0, 3, 0], [1, 3, 0, 0]],
                         np.int32)[:G]
    n_alleles = np.array([4, 3, 2], np.int32)[:G]
    haploid = np.array([False, False, True])[:G]
    pm = dict(pool_row=pool_row, mate_index=mate_index, has_mate=has_mate,
              read_ok=read_ok, weights=weights, log_p1=log_p1, log_p2=log_p2,
              sample=sample, col_index=col_index, n_alleles=n_alleles,
              haploid=haploid)
    return LL, pm, Sm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posteriors_match_jax(seed):
    LL, pm, Sm = _batch(seed)
    ref_post, ref_tot = jax_post(jnp, jnp.asarray(LL),
                                 {k: jnp.asarray(v) for k, v in pm.items()},
                                 Sm, jnp.float64)
    got_post, got_tot = batched_pool_posteriors(
        torch.from_numpy(LL), {k: torch.from_numpy(v) for k, v in pm.items()},
        Sm, torch.float64)
    np.testing.assert_allclose(got_post.numpy(), np.asarray(ref_post),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_tot.numpy(), np.asarray(ref_tot),
                               rtol=1e-10, atol=1e-10)


def test_posteriors_normalise_per_sample():
    """Each sample's real genotype posteriors sum to one; the haploid
    locus puts no mass on heterozygotes."""
    LL, pm, Sm = _batch(3)
    post, _ = batched_pool_posteriors(
        torch.from_numpy(LL), {k: torch.from_numpy(v) for k, v in pm.items()},
        Sm, torch.float64)
    for g, A in enumerate(pm["n_alleles"]):
        p = torch.exp(post[g, :, :A, :A])
        present = np.unique(pm["sample"][g][pm["weights"][g] > 0])
        for s in present:
            assert math.isclose(float(p[s].sum()), 1.0, rel_tol=1e-12)
        if pm["haploid"][g]:
            off = ~torch.eye(int(A), dtype=torch.bool)
            assert float(p[:, off].max()) == 0.0
