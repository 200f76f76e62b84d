"""Per-locus forward-DP kernels: the K4 flank-row scan and the K3 fused
segment, with their plain PyTorch versions.

Counterpart of hipstr_tpu/ops/pallas_hmm.py (`flank_scan_pallas`,
`segment_scan_pallas`), with the same contracts: inputs [P, L] per read
pool, row metadata [n_rows, H] (K4) or one locus's HapMeta (K3), state
[P, H, L]; every row's last-column M is written, inactive (bucket-padding)
rows carrying the state through; padded haplotype columns are computed
like real ones.  On a CUDA tensor each wrapper launches its hand-written
kernel (csrc/flank_scan.cu, csrc/segment_scan.cu: one warp per (p, h)
chain, launched as `scan_geometry` says) or raises; only a CPU tensor takes
the plain version, which is built from the rows of ops/hmm.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import kernels
from .hmm import emit_locus, flank_row, last_col_values, segment_rows
from .hmm2 import ND, WarpGeometry, check_warp_lanes, pick_warps


# ---- K4/K3 launch geometry (csrc/flank_scan.cu, csrc/segment_scan.cu) -----
SCAN_KERNELS = ("flank_scan", "segment_scan")


def scan_smem(kernel: str, W: int, L: int, rows: int, itemsize: int,
              shared_lanes: bool) -> int:
    """Bytes of shared memory of one K4 or K3 block, the sum the kernel
    carves: per warp, with shared_lanes, the lane constants (w, c, C, Csh
    and the code of each of its L lanes) and, for K3, the 13 emission planes
    and the stutter row's M ([14][L]) and the 13 log artifact
    probabilities; per block the [rows][W] tile of last-column M, the
    block's rows of chars and three transitions and the rows' active
    flags."""
    slab = L * (4 * itemsize + 4) if shared_lanes else 0
    per_block = rows * W * (4 * itemsize + 4) + rows * 4
    if kernel == "flank_scan":
        return W * slab + per_block
    return W * ((ND + 1) * L * itemsize + slab + ND * itemsize) + per_block


def scan_geometry(P: int, H: int, L: int, rows: int, dtype,
                  kernel: str) -> WarpGeometry:
    """The launch of K4 (`kernel` "flank_scan", `rows` its flank rows) or
    K3 ("segment_scan", `rows` = R): grid, warps a block (`pick_warps`, no
    more than H), shared memory.  Raises on what the kernel does not
    take."""
    if kernel not in SCAN_KERNELS:
        raise ValueError(f"scan_geometry: unknown kernel {kernel!r}")
    itemsize = check_warp_lanes(kernel, dtype, L)
    if min(P, H) < 1 or rows < (0 if kernel == "flank_scan" else 2):
        raise ValueError(f"{kernel}: P={P} H={H} rows={rows}")
    shared = itemsize == 8 and L > 256

    def smem(W):
        return scan_smem(kernel, W, L, rows, itemsize, shared)

    W = pick_warps(f"{kernel}: rows={rows} L={L}", H, smem)
    return WarpGeometry(((H + W - 1) // W, P), W, 32 * W, smem(W), L // 32,
                        shared)


def scan_chain(geom: WarpGeometry, block: Tuple[int, int], warp: int,
               H: int) -> Optional[Tuple[int, int]]:
    """The (p, h) chain that `warp` of `block` (x, y) runs in K4 or K3, or
    None for a warp past the last haplotype."""
    h = block[0] * geom.warps + warp
    return (block[1], h) if h < H else None


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
    """Launch csrc/flank_scan.cu on CUDA tensors (see `flank_scan`).  The
    kernel reads the row arrays in place: int8 chars, bool flags, and any
    strides shared by the four [n_rows, H] arrays (the per-locus path
    passes transposed slices of its [H, R] rows), so those launch no
    conversion kernels."""
    P, L = codes.shape
    n_rows, H = row_char.shape
    dtype, dev = M.dtype, codes.device
    geom = scan_geometry(P, H, L, n_rows, dtype, "flank_scan")
    rows = (row_char.to(torch.int8), row_m2m.to(dtype), row_m2i.to(dtype),
            row_m2d.to(dtype))
    if len({x.stride() for x in rows}) > 1:
        rows = tuple(x.contiguous() for x in rows)
    row_active = row_active.to(torch.bool).contiguous()
    i32 = torch.int32
    for name, t, dt, shape in (
            ("codes", codes, i32, (P, L)), ("blw", blw, dtype, (P, L)),
            ("blc", blc, dtype, (P, L)), ("C", C, dtype, (P, L)),
            ("Csh", Csh, dtype, (P, L)), ("last_col", last_col, i32, (P,)),
            ("row_active", row_active, torch.bool, (n_rows,)),
            ("M", M, dtype, (P, H, L)), ("I", I, dtype, (P, H, L)),
            ("D", D, dtype, (P, H, L))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    for name, t, dt in zip(("row_char", "row_m2m", "row_m2i", "row_m2d"),
                           rows, (torch.int8, dtype, dtype, dtype)):
        kernels.check_cuda_tensor(name, t, dt, (n_rows, H), dev,
                                  contiguous=False)
    for name, t in (("codes", codes), ("blw", blw), ("blc", blc), ("C", C),
                    ("Csh", Csh), ("M", M), ("I", I), ("D", D)):
        kernels.check_aligned(name, t)
    Mcol = torch.empty((n_rows, P, H), dtype=dtype, device=dev)
    Mo, Io, Do = (torch.empty_like(M) for _ in range(3))
    ptrs = [kernels.ptr(t) for t in (codes, blw, blc, C, Csh, last_col,
                                     *rows, row_active, M, I, D, Mcol, Mo,
                                     Io, Do)]
    ints = [ctypes.c_int(v) for v in (P, H, L, n_rows, *rows[0].stride(),
                                      geom.warps, geom.smem)]
    kernels.launch("flank_scan", dtype, dev, (P, H, L, n_rows), *ptrs, *ints)
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
    """Launch csrc/segment_scan.cu on CUDA tensors (see `segment_scan`).
    The kernel reads the locus's metadata as the per-locus path holds it
    (int8 chars, bool flags, each option's rep_len and lpmf, from which it
    derives each haplotype's shift and artifact probabilities), so those
    launch no conversion kernels."""
    P, L = codes.shape
    H = meta.row_char.shape[0]
    O, nD = meta.lpmf.shape
    dtype, dev = blc.dtype, codes.device
    geom = scan_geometry(P, H, L, R, dtype, "segment_scan")
    if not 0 < sr < R:
        raise ValueError(f"segment_scan: stutter row {sr} outside [1, {R})")
    if nD != ND:
        raise ValueError(f"segment_scan: {nD} artifact sizes, not {ND}")
    row_char = meta.row_char.to(torch.int8).contiguous()
    m2m, m2i, m2d = (x.to(dtype).contiguous()
                     for x in (meta.row_m2m, meta.row_m2i, meta.row_m2d))
    row_active = meta.row_active.to(torch.bool).contiguous()
    hap_opt = meta.hap_opt.to(torch.int32).contiguous()
    rep_len = meta.rep_len.to(torch.int32).contiguous()
    lpmf = meta.lpmf.to(dtype).contiguous()
    i32 = torch.int32
    for name, t, dt, shape in (
            ("codes", codes, i32, (P, L)), ("blw", blw, dtype, (P, L)),
            ("blc", blc, dtype, (P, L)), ("C", C, dtype, (P, L)),
            ("Csh", Csh, dtype, (P, L)), ("last_col", last_col, i32, (P,)),
            ("row_char", row_char, torch.int8, (H, R)),
            ("row_m2m", m2m, dtype, (H, R)), ("row_m2i", m2i, dtype, (H, R)),
            ("row_m2d", m2d, dtype, (H, R)),
            ("row_active", row_active, torch.bool, (R,)),
            ("E", E, dtype, (O, nD, P, L)), ("hap_opt", hap_opt, i32, (H,)),
            ("rep_len", rep_len, i32, (O,)), ("lpmf", lpmf, dtype, (O, nD))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    for name, t in (("codes", codes), ("blw", blw), ("blc", blc), ("C", C),
                    ("Csh", Csh), ("E", E)):
        kernels.check_aligned(name, t)
    Mcol = torch.empty((R, P, H), dtype=dtype, device=dev)
    ptrs = [kernels.ptr(t) for t in (codes, blw, blc, C, Csh, last_col,
                                     row_char, m2m, m2i, m2d, row_active, E,
                                     hap_opt, rep_len, lpmf, Mcol)]
    ints = [ctypes.c_int(v) for v in (P, H, L, R, nD, sr, period, geom.warps,
                                      geom.smem)]
    kernels.launch("segment_scan", dtype, dev, (P, H, L, R, O), *ptrs, *ints)
    return Mcol
