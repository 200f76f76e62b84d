"""Parity: the port's plain stutter emissions vs the JAX package's
reference formulation (`stutter_emissions_tpu` under numpy, the oracle of
tests/test_pallas_emission.py), and the K1 wrapper's device dispatch."""

import numpy as np
import pytest
import torch

from hipstr_tpu.models.base_quality import BaseQuality
from hipstr_tpu.ops.stutter_emission import stutter_emissions_tpu
from hipstr_tpu_torch import kernels
from hipstr_tpu_torch.ops.emission import stutter_emissions
from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
from test_torch_slice import one_torch_thread  # noqa: F401


def _inputs(seed, G, O, P, L, Bmax, periods):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(G, P, L)).astype(np.int32)
    codes[rng.random((G, P, L)) < 0.02] = 4
    q = rng.integers(35, 70, size=(G, P, L)).astype(np.uint8)
    blw = BaseQuality.log_error_table[q]
    blc = BaseQuality.log_correct_table[q]
    brev = rng.integers(0, 4, size=(G, O, Bmax)).astype(np.int32)
    blen = rng.integers(1, Bmax + 1, size=(G, O)).astype(np.int32)
    blen[:, -1] = 0                    # padded repeat option
    return codes, blw, blc, brev, blen, np.asarray(periods, np.int32)


def _reference(codes, blw, blc, brev, blen, periods):
    G, P, L = codes.shape
    O = brev.shape[1]
    ref = np.zeros((G, O, 13, P, L))
    for g in range(G):
        for o in range(O):
            for p in range(P):
                ref[g, o, :, p, :] = stutter_emissions_tpu(
                    np, codes[g, p], blw[g, p], blc[g, p], brev[g, o],
                    int(blen[g, o]), period=int(periods[g]), max_units=6)
    return ref


@pytest.mark.parametrize("periods,Bmax,L", [((1, 2), 16, 32),
                                            ((3, 1), 16, 32),
                                            ((2, 3), 32, 64)])
def test_plain_emissions_match_reference(periods, Bmax, L):
    G, O, P = 2, 3, 4
    args = _inputs(sum(periods) * 100 + Bmax + L, G, O, P, L, Bmax, periods)
    ref = _reference(*args)
    got = stutter_emissions_plain(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-10)


def test_plain_emissions_chunked_rows_agree():
    """Chunking the (option, pool) rows changes nothing."""
    args = [torch.from_numpy(a) for a in
            _inputs(5, 2, 3, 4, 32, 16, (2, 1))]
    whole = stutter_emissions_plain(*args)
    chunked = stutter_emissions_plain(*args, max_elems=1)
    assert torch.equal(whole, chunked)


def test_cpu_wrapper_takes_plain_version_without_launching():
    args = [torch.from_numpy(a) for a in
            _inputs(6, 1, 2, 3, 32, 16, (3,))]
    before = dict(kernels.LAUNCHES)
    assert torch.equal(stutter_emissions(*args),
                       stutter_emissions_plain(*args))
    assert kernels.LAUNCHES == before


def test_non_cpu_tensor_never_takes_plain_version():
    """Only a CPU tensor takes the plain path: any other device launches
    the kernel or raises."""
    args = [torch.from_numpy(a).to("meta") for a in
            _inputs(7, 1, 2, 3, 32, 16, (2,))]
    with pytest.raises(ValueError, match="unsupported device"):
        stutter_emissions(*args)
