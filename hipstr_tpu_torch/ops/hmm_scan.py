"""Per-locus forward-DP kernels: the K4 flank-row scan and the K3 fused
segment, with their plain PyTorch versions.

Counterpart of hipstr_tpu/ops/pallas_hmm.py (`flank_scan_pallas`,
`segment_scan_pallas`), with the same contracts: inputs [P, L] per read
pool, row metadata [n_rows, H] (K4) or one locus's HapMeta (K3), state
[P, H, L]; every row's last-column M is written, inactive (bucket-padding)
rows carrying the state through; padded haplotype columns are computed
like real ones.  On a CUDA tensor each wrapper launches its hand-written
kernel (csrc/flank_scan.cu, csrc/segment_scan.cu) or raises; only a CPU
tensor takes the plain version, which is built from the rows of
ops/hmm.py.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .hmm import emit_locus, flank_row, last_col_values, segment_rows


# ------------------------------------------------------------------ K4
def flank_scan(codes, blw, blc, C, Csh, last_col, row_char, row_m2m,
               row_m2i, row_m2d, row_active, M, I, D):
    """Flank-row scan of one locus.

    codes/blw/blc/C/Csh [P, L]; last_col [P]; row_* [n_rows, H];
    row_active [n_rows] bool; M/I/D [P, H, L].  Returns (M, I, D,
    Mcol [n_rows, P, H])."""
    args = (codes, blw, blc, C, Csh, last_col, row_char, row_m2m, row_m2i,
            row_m2d, row_active, M, I, D)
    if codes.device.type == "cpu":
        return flank_scan_plain(*args)
    if codes.device.type == "cuda":
        return flank_scan_kernel(*args)
    raise ValueError(f"flank_scan: unsupported device {codes.device}")


def flank_scan_plain(codes, blw, blc, C, Csh, last_col, row_char, row_m2m,
                     row_m2i, row_m2d, row_active, M, I, D):
    """Plain PyTorch flank scan (arguments and result of `flank_scan`)."""
    P, L = codes.shape
    n_rows, H = row_char.shape
    dtype = M.dtype
    jj = torch.arange(L, dtype=dtype, device=M.device)
    C3, Csh3 = C[:, None], Csh[:, None]
    Mcol = torch.empty((n_rows, P, H), dtype=dtype, device=M.device)
    for r in range(n_rows):
        if bool(row_active[r]):
            M, I, D = flank_row(
                M, D, emit_locus(codes, row_char[r], blc, blw), C3, Csh3, jj,
                *(x[r].to(dtype)[None, :, None]
                  for x in (row_m2m, row_m2i, row_m2d)))
        Mcol[r] = last_col_values(M, last_col)
    return M, I, D, Mcol


def flank_scan_kernel(codes, blw, blc, C, Csh, last_col, row_char, row_m2m,
                      row_m2i, row_m2d, row_active, M, I, D):
    """Launch csrc/flank_scan.cu on CUDA tensors (see `flank_scan`)."""
    P, L = codes.shape
    n_rows, H = row_char.shape
    dtype, dev = M.dtype, codes.device
    kernels.check_lanes("flank_scan", dtype, L)
    row_char = row_char.int().contiguous()
    row_active = row_active.int().contiguous()
    m2m, m2i, m2d = (x.to(dtype).contiguous()
                     for x in (row_m2m, row_m2i, row_m2d))
    i32 = torch.int32
    for name, t, dt, shape in (
            ("codes", codes, i32, (P, L)), ("blw", blw, dtype, (P, L)),
            ("blc", blc, dtype, (P, L)), ("C", C, dtype, (P, L)),
            ("Csh", Csh, dtype, (P, L)), ("last_col", last_col, i32, (P,)),
            ("row_char", row_char, i32, (n_rows, H)),
            ("row_m2m", m2m, dtype, (n_rows, H)),
            ("row_m2i", m2i, dtype, (n_rows, H)),
            ("row_m2d", m2d, dtype, (n_rows, H)),
            ("row_active", row_active, i32, (n_rows,)),
            ("M", M, dtype, (P, H, L)), ("I", I, dtype, (P, H, L)),
            ("D", D, dtype, (P, H, L))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    Mcol = torch.empty((n_rows, P, H), dtype=dtype, device=dev)
    Mo, Io, Do = (torch.empty_like(M) for _ in range(3))
    fn = kernels.launcher("flank_scan", dtype)
    ptrs = [kernels.ptr(t) for t in (codes, blw, blc, C, Csh, last_col,
                                     row_char, m2m, m2i, m2d, row_active, M,
                                     I, D, Mcol, Mo, Io, Do)]
    ints = [ctypes.c_int(v) for v in (P, H, L, n_rows)]
    rc = fn(*ptrs, *ints, kernels.stream())
    kernels.check_launch("flank_scan", rc)
    return Mo, Io, Do, Mcol


# ------------------------------------------------------------------ K3
def segment_scan(codes, blw, blc, C, Csh, last_col, meta, E, R: int,
                 sr: int, period: int):
    """The whole segment of one locus and orientation in one pass.

    codes/blw/blc/C/Csh [P, L]; last_col [P]; meta one locus's HapMeta;
    E [O, nD, P, L] (K1's layout); period the locus's repeat period.
    Returns Mcol [R, P, H]."""
    args = (codes, blw, blc, C, Csh, last_col, meta, E, R, sr, period)
    if codes.device.type == "cpu":
        return segment_scan_plain(*args)
    if codes.device.type == "cuda":
        return segment_scan_kernel(*args)
    raise ValueError(f"segment_scan: unsupported device {codes.device}")


def segment_scan_plain(codes, blw, blc, C, Csh, last_col, meta, E, R: int,
                       sr: int, period: int):
    """Plain PyTorch fused segment (arguments and result of
    `segment_scan`): the plain flank scan around the stutter row with the
    kernel's circular entry."""
    return segment_rows(codes, blw, blc, C, Csh, last_col, meta, E, R, sr,
                        period, flank_scan_plain, clip=False)


def segment_scan_kernel(codes, blw, blc, C, Csh, last_col, meta, E, R: int,
                        sr: int, period: int):
    """Launch csrc/segment_scan.cu on CUDA tensors (see `segment_scan`)."""
    P, L = codes.shape
    H = meta.row_char.shape[0]
    O, nD = meta.lpmf.shape
    dtype, dev = blc.dtype, codes.device
    kernels.check_lanes("segment_scan", dtype, L)
    if not 0 < sr < R:
        raise ValueError(f"segment_scan: stutter row {sr} outside [1, {R})")
    hap_opt = meta.hap_opt.long()
    shift = (meta.rep_len.long()[hap_opt]
             - ((nD - 1) // 2) * period).int().contiguous()
    lpmf_h = meta.lpmf.to(dtype)[hap_opt].contiguous()
    row_char = meta.row_char.int().contiguous()
    m2m, m2i, m2d = (x.to(dtype).contiguous()
                     for x in (meta.row_m2m, meta.row_m2i, meta.row_m2d))
    row_active = meta.row_active.int().contiguous()
    hap_opt = hap_opt.int().contiguous()
    i32 = torch.int32
    for name, t, dt, shape in (
            ("codes", codes, i32, (P, L)), ("blw", blw, dtype, (P, L)),
            ("blc", blc, dtype, (P, L)), ("C", C, dtype, (P, L)),
            ("Csh", Csh, dtype, (P, L)), ("last_col", last_col, i32, (P,)),
            ("row_char", row_char, i32, (H, R)),
            ("row_m2m", m2m, dtype, (H, R)), ("row_m2i", m2i, dtype, (H, R)),
            ("row_m2d", m2d, dtype, (H, R)),
            ("row_active", row_active, i32, (R,)),
            ("E", E, dtype, (O, nD, P, L)), ("hap_opt", hap_opt, i32, (H,)),
            ("shift", shift, i32, (H,)), ("lpmf_h", lpmf_h, dtype, (H, nD))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    Mcol = torch.empty((R, P, H), dtype=dtype, device=dev)
    fn = kernels.launcher("segment_scan", dtype)
    ptrs = [kernels.ptr(t) for t in (codes, blw, blc, C, Csh, last_col,
                                     row_char, m2m, m2i, m2d, row_active, E,
                                     hap_opt, shift, lpmf_h, Mcol)]
    ints = [ctypes.c_int(v) for v in (P, H, L, R, nD, sr, period)]
    rc = fn(*ptrs, *ints, kernels.stream())
    kernels.check_launch("segment_scan", rc)
    return Mcol

