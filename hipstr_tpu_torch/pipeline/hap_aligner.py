"""Per-locus packing with shape buckets, and the torch haplotype aligner.

Counterpart of hipstr_tpu/pipeline/hap_aligner.py (reference
HapAligner::process_reads, src/SeqAlignment/HapAligner.cpp:320-343).
`prepare_locus` packs one locus's haplotypes and read pools into
bucket-padded numpy arrays, exactly as the JAX package does on the CPU
(`_CPU_BUCKETS` on every device: the hand-written kernels take runtime
extents, so there is no compile count to save with coarser buckets).
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
from ..align.packing import pack_haplotypes, pack_reads
from ..device import resolve_dtype
from ..kernels import DeviceError
from ..ops.hmm import HapMeta, SeedMeta, SegmentInputs, hmm_forward

_CPU_BUCKETS = dict(
    L=[64, 128, 192, 256, 384, 512],
    ROWS=[16, 32, 64, 96, 128, 224],
    H=[4, 8, 16, 32, 64, 128, 256, 512, 1024],
    P=[16, 32, 64, 128, 256, 512, 1024],
    S=[64, 128, 256, 384],
    O=[4, 8, 16, 32, 64],
    B=[32, 64, 128, 192],
    RD=[32, 64, 128, 256, 512, 1024, 4096],
    SAMP=[2, 4, 8, 16, 32, 64, 128, 512],
)


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    raise ValueError(f"value {v} exceeds largest bucket {buckets[-1]}")


def _pad_axis(a: np.ndarray, axis: int, target: int, mode: str = "edge"):
    """Pad `axis` to `target`: zeros ("constant") or copies of the last
    real entry ("edge")."""
    n = a.shape[axis]
    if n == target:
        return a
    shape = list(a.shape)
    shape[axis] = target
    if mode == "constant":
        dst = np.zeros(shape, dtype=a.dtype)
    else:
        dst = np.empty(shape, dtype=a.dtype)
        edge = [slice(None)] * a.ndim
        edge[axis] = slice(n - 1, n)
        tail = [slice(None)] * a.ndim
        tail[axis] = slice(n, target)
        dst[tuple(tail)] = a[tuple(edge)]
    head = [slice(None)] * a.ndim
    head[axis] = slice(0, n)
    dst[tuple(head)] = a
    return dst


def _pad_orientation(d: dict, sr_real: int, R_real: int, H_pad: int,
                     O_pad: int, B_pad: int):
    """Pad one orientation's row metadata; returns (new dict, row_map fn,
    R_pad).  Phase-1 padding rows go between row 0 and the first real flank
    row, phase-3 padding rows at the end."""
    rows_b = _CPU_BUCKETS["ROWS"]
    B1 = _bucket(sr_real, rows_b)
    tail = R_real - sr_real - 2
    B3 = _bucket(max(tail, 0), rows_b) if tail > 0 else _bucket(1, rows_b)
    pad1 = B1 - sr_real
    R_pad = B1 + 2 + B3

    # rm[r] = padded row index of real row r
    rm = np.empty(R_real, dtype=np.int64)
    if sr_real > 1:
        rm[1:sr_real] = pad1 + np.arange(1, sr_real)
    if sr_real > 0:              # row 0 wins over the stutter row (r==0 first)
        rm[sr_real] = B1
    rm[0] = 0
    if R_real > sr_real + 1:
        rm[sr_real + 1] = B1 + 1
    if R_real > sr_real + 2:
        rm[sr_real + 2:] = B1 + 2 + np.arange(R_real - sr_real - 2)

    def row_map(r: int) -> int:
        return int(rm[r])

    H = d["row_char"].shape[0]
    out = {}
    for key in ("row_char", "row_m2m", "row_m2i", "row_m2d"):
        src = d[key]
        dst = np.zeros((H, R_pad), dtype=src.dtype)
        dst[:, rm] = src
        out[key] = _pad_axis(dst, 0, H_pad)

    active = np.zeros(R_pad, dtype=bool)
    active[rm] = True
    out["row_active"] = active

    # padded repeat options are blen=0 sentinels that no haplotype's
    # hap_opt points at
    out["rep_rev_codes"] = _pad_axis(
        _pad_axis(d["rep_rev_codes"], 1, B_pad, "constant"), 0, O_pad,
        "constant")
    out["rep_len"] = _pad_axis(d["rep_len"], 0, O_pad, "constant")
    out["lpmf"] = _pad_axis(d["lpmf"], 0, O_pad, "constant")
    out["hap_opt"] = _pad_axis(d["hap_opt"], 0, H_pad)
    out["stutter_row"] = B1
    return out, row_map, R_pad


def _to_meta_np(d: dict) -> HapMeta:
    return HapMeta(*[d[f] for f in HapMeta._fields])


def pad_posterior_meta(pm: dict, H_real: int, H_pad: int):
    """Bucket-pad a SeqStutterGenotyper.posterior_meta dict for stacking
    into a batched dispatch (padded reads: weight 0, self-mate, sample 0).
    col_index maps each current allele to its column of the dispatched
    [P, H] LL matrix; n_alleles is the current allele count."""
    R = pm["pool_row"].shape[0]
    RD = _bucket(max(R, 1), _CPU_BUCKETS["RD"])
    Sm = _bucket(max(pm["num_samples"], 1), _CPU_BUCKETS["SAMP"])
    cols = pm.get("col_index")
    if cols is None:
        cols = np.arange(H_real, dtype=np.int32)
    A = int(cols.shape[0])
    out = dict(
        pool_row=_pad_axis(pm["pool_row"], 0, RD, "constant"),
        mate_index=np.concatenate(
            [pm["mate_index"],
             np.arange(R, RD, dtype=np.int32)]).astype(np.int32),
        has_mate=_pad_axis(pm["has_mate"], 0, RD, "constant"),
        read_ok=_pad_axis(pm["read_ok"], 0, RD, "constant"),
        weights=_pad_axis(pm["weights"], 0, RD, "constant"),
        log_p1=_pad_axis(pm["log_p1"], 0, RD, "constant"),
        log_p2=_pad_axis(pm["log_p2"], 0, RD, "constant"),
        sample=_pad_axis(pm["sample"], 0, RD, "constant"),
        col_index=_pad_axis(cols.astype(np.int32), 0, H_pad, "constant"),
        n_alleles=np.asarray(A, dtype=np.int32),
        haploid=np.asarray(pm["haploid"], dtype=bool),
    )
    return out, Sm


def prepare_locus(haplotype: Haplotype, seqs, quals, seeds,
                  dtype: str = "float32", post_meta: dict = None,
                  read_cache: dict = None):
    """Pack + bucket-pad one locus; returns (numpy array pytree, statics).

    The pytree holds (l_seg, r_seg, fw_meta, rev_meta, seed_meta,
    seed_codes, seed_quals[, padded posterior meta]); statics is
    (R_f, R_r, sr_f, sr_r, period, P_real, H_real, Sm or None)."""
    P_real = len(seqs)
    H_real = haplotype.num_combs
    # lane headroom: the stutter row reads lane j - shift with shift as low
    # as rep_len - 6*period (negative for short alleles), i.e. up to
    # 6*period lanes above j; every real read offset keeps that many
    # in-bounds lanes above it so the circular read never wraps into a
    # consumed lane
    period_hr = next(b.repeat_info.period for b in haplotype.blocks
                     if b.is_repeat)
    L_need = max(2, max(len(s) for s in seqs) - 1 + 6 * period_hr)
    L = _bucket(L_need, _CPU_BUCKETS["L"])

    packed = pack_haplotypes(haplotype, L)
    # the pooled reads never change across a locus's adaptive rounds, so
    # callers may pass a per-locus dict to reuse them (keyed by (P, L))
    if read_cache is not None:
        key = (P_real, L)
        reads = read_cache.get(key)
        if reads is None:
            reads = read_cache[key] = pack_reads(seqs, quals, seeds, L)
    else:
        reads = pack_reads(seqs, quals, seeds, L)

    H_pad = _bucket(H_real, _CPU_BUCKETS["H"])
    O_pad = _bucket(packed.O, _CPU_BUCKETS["O"])
    B_pad = _bucket(packed.fw["rep_rev_codes"].shape[1], _CPU_BUCKETS["B"])
    P_pad = _bucket(P_real, _CPU_BUCKETS["P"])

    sr_f = packed.fw["stutter_row"]
    sr_r = packed.rev["stutter_row"]
    fw_d, fw_map, R_f = _pad_orientation(packed.fw, sr_f, packed.R,
                                         H_pad, O_pad, B_pad)
    rev_d, rev_map, R_r = _pad_orientation(packed.rev, sr_r, packed.R,
                                           H_pad, O_pad, B_pad)

    sd = packed.seed
    S_real = len(sd["seed_fw_row"])
    S_pad = _bucket(max(S_real, 1), _CPU_BUCKETS["S"])
    seed_fw_row = np.zeros(S_pad, dtype=np.int32)
    seed_rev_row = np.zeros(S_pad, dtype=np.int32)
    seed_valid = np.zeros(S_pad, dtype=bool)
    seed_char = np.zeros((H_pad, S_pad), dtype=np.int32)
    for s in range(S_real):
        seed_fw_row[s] = fw_map(int(sd["seed_fw_row"][s]))
        seed_rev_row[s] = rev_map(int(sd["seed_rev_row"][s]))
        seed_valid[s] = True
    seed_char[:H_real, :S_real] = sd["seed_char"]
    seed_char[H_real:] = seed_char[0]

    seed_meta = SeedMeta(
        seed_fw_row=seed_fw_row,
        seed_rev_row=seed_rev_row,
        seed_char=seed_char,
        seed_valid=seed_valid,
        first_char=_pad_axis(sd["first_char"], 0, H_pad),
        last_char=_pad_axis(sd["last_char"], 0, H_pad),
        log_num_seeds=np.asarray(sd["log_num_seeds"],
                                 dtype=np.float64 if dtype == "float64"
                                 else np.float32),
        cfg_fw_row=np.asarray(fw_map(packed.R - 2), dtype=np.int32),
        cfg_rev_row=np.asarray(rev_map(packed.R - 2), dtype=np.int32),
    )

    def seg(codes, quals, last):
        codes = _pad_axis(codes, 0, P_pad, "constant")
        quals = _pad_axis(quals, 0, P_pad, "constant")
        last = np.concatenate([last, np.zeros(P_pad - P_real, np.int32)]) \
            if P_pad != P_real else last
        return SegmentInputs(codes, quals, last.astype(np.int32))

    l_seg = seg(reads.l_codes, reads.l_quals, reads.l_last)
    r_seg = seg(reads.r_codes, reads.r_quals, reads.r_last)
    seed_codes = np.concatenate(
        [reads.seed_codes, np.zeros(P_pad - P_real, np.int8)])
    seed_quals = np.concatenate(
        [reads.seed_quals, np.zeros(P_pad - P_real, np.uint8)])

    arrays = [l_seg, r_seg, _to_meta_np(fw_d), _to_meta_np(rev_d), seed_meta,
              seed_codes, seed_quals]
    Sm = None
    # the fused posterior output is [G, Sm, H_pad, H_pad]; past H_pad=32
    # wide-allele rounds use host posteriors
    if post_meta is not None and H_pad <= 32:
        pm, Sm = pad_posterior_meta(post_meta, H_real, H_pad)
        arrays.append(pm)
    statics = (R_f, R_r, fw_d["stutter_row"], rev_d["stutter_row"],
               packed.period, P_real, H_real, Sm)
    return tuple(arrays), statics


def stack_arrays(items):
    """Stack a list of same-shaped locus pytrees along a new locus axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: stack_arrays([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        parts = [stack_arrays([it[i] for it in items])
                 for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    return np.stack(items)


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
