"""Stutter-block emission tensor E[G, O, 13, P, L]: the K1 kernel wrapper.

Counterpart of hipstr_tpu/ops/pallas_emission.py (stutter_emissions_pallas).
On a CUDA tensor it launches the hand-written kernel csrc/emission.cu or
raises; a CPU tensor takes the plain PyTorch version
(ops/stutter_emission.stutter_emissions_plain).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .stutter_emission import stutter_emissions_plain

MAX_UNITS = 6
ND = 2 * MAX_UNITS + 1


def stutter_emissions(codes, blw, blc, brev, blen, periods):
    """E [G, O, 13, P, L] for a batch of loci.

    codes [G, P, L] int32 read codes; blw/blc [G, P, L] log P(error) /
    log P(correct); brev [G, O, Bmax] int32 repeat alleles right to left
    (padded options have blen = 0); blen [G, O] int32; periods [G] int32,
    runtime per locus."""
    if codes.device.type == "cpu":
        return stutter_emissions_plain(codes, blw, blc, brev, blen, periods,
                                       MAX_UNITS)
    if codes.device.type != "cuda":
        raise ValueError(f"stutter_emissions: unsupported device "
                         f"{codes.device}")
    G, P, L = codes.shape
    O, Bmax = brev.shape[1], brev.shape[2]
    dev, dtype = codes.device, blc.dtype
    kernels.check_lanes("stutter_emissions", dtype, L)
    for name, t, dt, shape in (
            ("codes", codes, torch.int32, (G, P, L)),
            ("blw", blw, dtype, (G, P, L)), ("blc", blc, dtype, (G, P, L)),
            ("brev", brev, torch.int32, (G, O, Bmax)),
            ("blen", blen, torch.int32, (G, O)),
            ("periods", periods, torch.int32, (G,))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    E = torch.empty((G, O, ND, P, L), dtype=dtype, device=dev)
    fn = kernels.launcher("emission", dtype)
    rc = fn(kernels.ptr(codes), kernels.ptr(blw), kernels.ptr(blc),
            kernels.ptr(brev), kernels.ptr(blen), kernels.ptr(periods),
            kernels.ptr(E), ctypes.c_int(G), ctypes.c_int(O), ctypes.c_int(P),
            ctypes.c_int(L), ctypes.c_int(Bmax), kernels.stream())
    kernels.check_launch("emission", rc, (G, O, P, L, Bmax))
    return E
