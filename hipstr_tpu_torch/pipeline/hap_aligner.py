"""The torch haplotype aligner, and the per-locus packing it runs on.

Counterpart of hipstr_tpu/pipeline/hap_aligner.py (reference
HapAligner::process_reads, src/SeqAlignment/HapAligner.cpp:320-343).
`prepare_locus` (pipeline/locus_pack.py, the numpy half, which imports no
torch, re-exported here with `stack_arrays`, `pad_posterior_meta` and
`_CPU_BUCKETS`) packs one locus's haplotypes and read pools into
bucket-padded numpy arrays, exactly as the JAX package does on the CPU.
`locus_to_torch` turns such a pytree (the port's or the JAX package's,
read by field name) into the port's containers of tensors.

`compute_hap_log_likelihoods` takes the JAX module's arguments; the port's
genotyper (pipeline/genotyper.py) imports it for its sequential rounds,
and the batched executor never calls it.  It runs on the device that
`use_device` installed (the sequential runner installs it) and never picks
one itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.haplotype import Haplotype
from ..device import resolve_dtype
from ..kernels import DeviceError
from ..ops.hmm import HapMeta, SeedMeta, SegmentInputs, hmm_forward
# the numpy half, re-exported: its callers and tests name it here
from .locus_pack import (_CPU_BUCKETS, pad_posterior_meta,  # noqa: F401
                         prepare_locus, stack_arrays)


def _tensor(x, device, dtype):
    a = np.asarray(x)
    # ascontiguousarray would make a 0-d array (a per-locus scalar) 1-d
    t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a)
    if a.dtype.kind == "f":
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)


def _convert(cls, obj, device, dtype):
    return cls(*[_tensor(getattr(obj, f), device, dtype) for f in cls._fields])


def locus_to_torch(arrays, device, dtype):
    """The port's containers of tensors on `device` from a prepare_locus
    pytree (single or stacked along a locus axis; from either package:
    fields are read by name).  Float arrays become `dtype`; integer and
    bool arrays keep their type."""
    out = [_convert(SegmentInputs, arrays[0], device, dtype),
           _convert(SegmentInputs, arrays[1], device, dtype),
           _convert(HapMeta, arrays[2], device, dtype),
           _convert(HapMeta, arrays[3], device, dtype),
           _convert(SeedMeta, arrays[4], device, dtype),
           _tensor(arrays[5], device, dtype),
           _tensor(arrays[6], device, dtype)]
    if len(arrays) > 7:
        out.append({k: _tensor(v, device, dtype)
                    for k, v in arrays[7].items()})
    return tuple(out)


# the device compute_hap_log_likelihoods runs on when it is given none
_DEVICE = None
# compute_hap_log_likelihoods calls that reached the device, this process
CALLS = 0


def use_device(device):
    """Install the torch device of `compute_hap_log_likelihoods` (None
    uninstalls); returns the one installed before."""
    global _DEVICE
    prev = _DEVICE
    _DEVICE = None if device is None else torch.device(device)
    return prev


def compute_hap_log_likelihoods(haplotype: Haplotype, seqs, quals, seeds,
                                dtype: str = "float32", device=None,
                                mode: str = "fused") -> np.ndarray:
    """LL[pool, hap] for every read pool against every haplotype
    combination of one locus, on `device` or else the installed one
    (`use_device`); raises when there is neither.  `mode` picks the
    per-locus forward (ops/hmm.segment_forward): "fused" (K1 + K3, the
    sequential path's, on every device: on the H100 it beat "flank", K1 +
    K4, per call in float32 and float64, PERF.md §6) or "flank".  Packing
    is host work; any failure from the move to the device through the
    fetch of LL is raised as DeviceError."""
    global CALLS
    dev = torch.device(device) if device is not None else _DEVICE
    if dev is None:
        raise RuntimeError("compute_hap_log_likelihoods: no device given and "
                           "none installed (pipeline.hap_aligner.use_device)")
    arrays, statics = prepare_locus(haplotype, seqs, quals, seeds, dtype)
    R_f, R_r, sr_f, sr_r, period, P_real, H_real = statics[:7]
    tdtype = resolve_dtype(dtype)
    CALLS += 1
    try:
        LL = hmm_forward(*locus_to_torch(arrays, dev, tdtype), R_f, R_r,
                         period, sr_f, sr_r, tdtype, mode=mode)
        return LL[:P_real, :H_real].cpu().numpy()
    except Exception as exc:
        raise DeviceError(f"per-locus alignment on {dev} failed: "
                          f"{exc!r}") from exc
