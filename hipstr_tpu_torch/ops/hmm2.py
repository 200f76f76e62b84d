"""Batched stutter-aware forward HMM: the K2 segment kernel wrapper, its
plain version, the seed combination and the batched forward pass.

Counterpart of hipstr_tpu/ops/pallas_hmm2.py.  `segment_forward` runs one
orientation for a batch of loci; on a CUDA tensor it launches the
hand-written kernel csrc/segment.cu (one warp per (locus, haplotype, pool)
chain, launched as `segment_geometry` says) or raises, and a CPU tensor
takes the plain PyTorch loop over rows (`segment_forward_plain`).  Both follow
`segment_forward_v2`: runtime periods and real haplotype counts per locus,
rows outside the active bounds skipped and left NEG.  `batched_forward`
keeps the output contract of `batched_forward_v2`: [G, P, H] with NEG
garbage in padded haplotype columns.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .emission import stutter_emissions
from .hmm import (IMPOSSIBLE, NEG, SeedMeta, emit, expand_quals, flank_row,
                  forced_match_row, stutter_row)


# ---- K2 launch geometry (csrc/segment.cu) ----------------------------------
SEGMENT_LANES = (64, 128, 192, 256, 384, 512)  # L: V = L/32 lanes a thread
SEGMENT_WARPS = (8, 4, 2, 1)                   # warps a block, preferred first
SMEM_BLOCK = 232448      # shared memory a block may use on the H100 (227 KB)
SMEM_SM = 233472         # shared memory of one SM (228 KB)
SMEM_RESERVED = 1024     # the runtime's reservation per block
ND = 13                  # artifact sizes (E's third axis)


class SegmentGeometry(NamedTuple):
    grid: Tuple[int, int, int]   # (ceil(P / warps), H, G)
    warps: int                   # W: one warp per (g, h, p) chain
    threads: int                 # 32 * W
    smem: int                    # dynamic shared memory, bytes
    lanes_per_thread: int        # V = L / 32
    shared_lanes: bool           # lane constants in shared memory


def segment_smem(W: int, L: int, R: int, itemsize: int,
                 shared_lanes: bool) -> int:
    """Bytes of shared memory of one K2 block, in the kernel's order: per
    warp the 13 emission planes and the stutter row's M ([14][L]) and, with
    shared_lanes, the lane constants (w, c, C, Csh and the code of each of
    its L lanes); per block the [R][W] tile of last-column M, the three
    transition rows, the 13 log artifact probabilities and the row chars."""
    slab = L * (4 * itemsize + 4) if shared_lanes else 0
    return W * ((ND + 1) * L * itemsize + slab) \
        + (R * W + 3 * R + ND) * itemsize + R * 4


def segment_geometry(G: int, H: int, P: int, L: int, R: int,
                     dtype) -> SegmentGeometry:
    """The K2 launch for one orientation: grid, warps a block (the W of
    SEGMENT_WARPS, no more than P, that keeps the most warps resident on an
    SM; ties to the larger), shared memory.  Raises on what the kernel does
    not take."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_forward: dtype {dtype}")
    if L not in SEGMENT_LANES:
        raise ValueError(f"segment_forward: L={L} not in {SEGMENT_LANES}")
    if min(G, H, P) < 1 or R < 2:
        raise ValueError(f"segment_forward: G={G} H={H} P={P} R={R}")
    itemsize = 8 if dtype == torch.float64 else 4
    shared = itemsize == 8 and L > 256

    def smem(W):
        return segment_smem(W, L, R, itemsize, shared)

    def resident(W):
        return W * min(32, 64 // W, SMEM_SM // (smem(W) + SMEM_RESERVED))

    fits = [W for W in SEGMENT_WARPS if W <= P and smem(W) <= SMEM_BLOCK]
    if not fits:
        raise ValueError(f"segment_forward: R={R} L={L} needs "
                         f"{smem(1)} bytes of shared memory per warp")
    W = max(fits, key=lambda w: (resident(w), w))
    return SegmentGeometry(((P + W - 1) // W, H, G), W, 32 * W, smem(W),
                           L // 32, shared)


def segment_chain(geom: SegmentGeometry, block: Tuple[int, int, int],
                  warp: int, P: int) -> Optional[Tuple[int, int, int]]:
    """The (g, h, p) chain that `warp` of `block` (x, y, z) runs in the
    kernel, or None for a warp past the last pool."""
    p = block[0] * geom.warps + warp
    return (block[2], block[1], p) if p < P else None


def row_bounds(row_active, R: int, sr: int, h_real, periods):
    """[G, 4] int32 (start1, end3, h_real, period): phase-1 bucket padding
    sits at rows 1..start1-1, phase-3 padding at rows end3..R-1."""
    idx = torch.arange(R, device=row_active.device)[None, :]
    act = row_active.bool()
    mask1 = act & (idx >= 1) & (idx < sr)
    start1 = torch.clamp(torch.where(mask1, idx, R).amin(dim=1), max=sr)
    mask3 = act & (idx >= sr + 2)
    end3 = torch.clamp(torch.where(mask3, idx + 1, 0).amax(dim=1),
                       min=sr + 2)
    return torch.stack([start1, end3, h_real.long(), periods.long()],
                       dim=1).int().contiguous()


def segment_forward_plain(codes, blw, blc, C, Csh, last_col, row_char,
                          m2m, m2i, m2d, E, hap_opt, shift, lpmf_h, bounds,
                          R: int, sr: int):
    """Plain PyTorch segment forward: Mcol [G, H, R, P].  Arguments as for
    the kernel (see `segment_forward`)."""
    G, P, L = codes.shape
    H = row_char.shape[1]
    dtype, dev = blc.dtype, blc.device
    start1, end3, h_real, periods = bounds.long().unbind(1)
    jj = torch.arange(L, dtype=dtype, device=dev)
    C4, Csh4 = C[:, None], Csh[:, None]
    lc = last_col.long()[:, None, :, None].expand(G, H, P, 1)
    Mcol = torch.full((G, H, R, P), NEG, dtype=dtype, device=dev)

    def col(M):
        return torch.gather(M, -1, lc)[..., 0]

    def rc(x, r):
        return x[:, :, r, None, None]

    M = emit(codes, row_char[:, :, 0], blc, blw) + Csh4
    D = torch.full((G, H, P, L), IMPOSSIBLE, dtype=dtype, device=dev)
    Mcol[:, :, 0] = col(M)

    def rows(M, D, lo, hi, on_fn):
        for r in range(lo, hi):
            on = on_fn(r)                                       # [G] bool
            if not bool(on.any()):
                continue
            em = emit(codes, row_char[:, :, r], blc, blw)
            Mn, _, Dn = flank_row(M, D, em, C4, Csh4, jj, rc(m2m, r),
                                  rc(m2i, r), rc(m2d, r))
            sel = on[:, None, None, None]
            M = torch.where(sel, Mn, M)
            D = torch.where(sel, Dn, D)
            Mcol[:, :, r] = torch.where(on[:, None, None], col(M), NEG)
        return M, D

    # phase 1: flank rows start1 .. sr-1
    M, D = rows(M, D, 1, sr, lambda r: r >= start1)
    # phase 2: the stutter row, then the forced-match row
    E_h = E[torch.arange(G, device=dev)[:, None], hap_opt.long()]
    M = stutter_row(M, E_h, lpmf_h, shift, periods)
    D = torch.full_like(M, IMPOSSIBLE)
    Mcol[:, :, sr] = col(M)
    if sr + 1 < R:
        M = forced_match_row(M, emit(codes, row_char[:, :, sr + 1], blc, blw))
        Mcol[:, :, sr + 1] = col(M)
    # phase 3: remaining flank rows up to end3
    rows(M, D, sr + 2, R, lambda r: r < end3)
    pad_h = torch.arange(H, device=dev)[None, :] >= h_real[:, None]
    Mcol[pad_h] = NEG
    return Mcol


def segment_args(codes, quals, last_col, meta, E, R: int, sr: int, h_real,
                 periods, dtype):
    """The kernel's argument tuple for one orientation (see
    `segment_forward`), plus the read prefix sums C [G, P, L]."""
    G, P, L = codes.shape
    H = meta.row_char.shape[1]
    nD = meta.lpmf.shape[-1]
    dev = codes.device
    blw, blc = expand_quals(quals, dtype)
    C = torch.cumsum(blc, dim=-1)
    Csh = torch.cat([torch.zeros((G, P, 1), dtype=dtype, device=dev),
                     C[..., :-1]], dim=-1)
    hap_opt = meta.hap_opt.long()
    d_min = -((nD - 1) // 2) * periods.long()                      # [G]
    lpmf_h = torch.gather(meta.lpmf.to(dtype), 1,
                          hap_opt[:, :, None].expand(G, H, nD)).contiguous()
    shift = (torch.gather(meta.rep_len.long(), 1, hap_opt)
             + d_min[:, None]).int().contiguous()
    bounds = row_bounds(meta.row_active, R, sr, h_real, periods)
    args = (codes.int().contiguous(), blw, blc, C, Csh,
            last_col.int().contiguous(), meta.row_char.int().contiguous(),
            meta.row_m2m.to(dtype).contiguous(),
            meta.row_m2i.to(dtype).contiguous(),
            meta.row_m2d.to(dtype).contiguous(),
            E.contiguous(), hap_opt.int().contiguous(), shift, lpmf_h, bounds)
    return args, C


def segment_forward(codes, quals, last_col, meta, E, R: int, sr: int,
                    h_real, periods, dtype):
    """One orientation for a batch of loci.

    codes [G, P, L] int8, quals [G, P, L] uint8, last_col [G, P]; `meta` a
    HapMeta with a leading locus axis; E [G, O, nD, P, L]; h_real and
    periods [G].  Returns (Mcol [G, R, P, H], seg_logsum [G, P])."""
    args, C = segment_args(codes, quals, last_col, meta, E, R, sr, h_real,
                           periods, dtype)
    if codes.device.type == "cpu":
        Mcol = segment_forward_plain(*args, R=R, sr=sr)
    elif codes.device.type == "cuda":
        Mcol = segment_kernel(*args, R=R, sr=sr)
    else:
        raise ValueError(f"segment_forward: unsupported device {codes.device}")
    seg_logsum = torch.gather(C, -1, last_col.long()[..., None])[..., 0]
    return Mcol.permute(0, 2, 3, 1), seg_logsum


def segment_kernel(codes, blw, blc, C, Csh, last_col, row_char, m2m, m2i,
                   m2d, E, hap_opt, shift, lpmf_h, bounds, R: int, sr: int):
    """Launch csrc/segment.cu on CUDA tensors: Mcol [G, H, R, P]."""
    G, P, L = codes.shape
    H = row_char.shape[1]
    O, nD = E.shape[1], E.shape[2]
    dtype, dev = blc.dtype, codes.device
    geom = segment_geometry(G, H, P, L, R, dtype)
    if not 0 < sr < R:
        raise ValueError(f"segment_forward: stutter row {sr} outside [1, {R})")
    if nD != ND:
        raise ValueError(f"segment_forward: {nD} artifact sizes, not {ND}")
    i32 = torch.int32
    for name, t, dt, shape in (
            ("codes", codes, i32, (G, P, L)), ("blw", blw, dtype, (G, P, L)),
            ("blc", blc, dtype, (G, P, L)), ("C", C, dtype, (G, P, L)),
            ("Csh", Csh, dtype, (G, P, L)), ("last_col", last_col, i32, (G, P)),
            ("row_char", row_char, i32, (G, H, R)),
            ("row_m2m", m2m, dtype, (G, H, R)),
            ("row_m2i", m2i, dtype, (G, H, R)),
            ("row_m2d", m2d, dtype, (G, H, R)),
            ("E", E, dtype, (G, O, nD, P, L)),
            ("hap_opt", hap_opt, i32, (G, H)), ("shift", shift, i32, (G, H)),
            ("lpmf_h", lpmf_h, dtype, (G, H, nD)),
            ("bounds", bounds, i32, (G, 4))):
        kernels.check_cuda_tensor(name, t, dt, shape, dev)
    Mcol = torch.empty((G, H, R, P), dtype=dtype, device=dev)
    fn = kernels.launcher("segment", dtype)
    ptrs = [kernels.ptr(t) for t in (codes, blw, blc, C, Csh, last_col,
                                     row_char, m2m, m2i, m2d, E, hap_opt,
                                     shift, lpmf_h, bounds, Mcol)]
    ints = [ctypes.c_int(v) for v in (G, H, P, L, R, O, nD, sr, geom.warps,
                                      geom.smem)]
    rc = fn(*ptrs, *ints, kernels.stream())
    kernels.check_launch("segment", rc, (G, H, P, L, R, O))
    return Mcol


def emissions_batched(codes, quals, rep_rev_codes, rep_len, periods, dtype):
    """E [G, O, nD, P, L] for one orientation (K1 on the card)."""
    blw, blc = expand_quals(quals, dtype)
    return stutter_emissions(codes.int().contiguous(), blw, blc,
                             rep_rev_codes.int().contiguous(),
                             rep_len.int().contiguous(),
                             periods.int().contiguous())


def seed_combine(Mcol_fw, Mcol_rev, l_prob, r_prob, seed: SeedMeta,
                 seed_codes, seed_blw, seed_blc, dtype):
    """Seed-anchor marginalisation for a batch of loci (the tail of
    ops/hmm.hmm_forward; reference HapAligner.cpp:163-231).  Mcol_* are
    [G, R, P, H]; returns LL [G, P, H]."""
    G = Mcol_fw.shape[0]
    gi = torch.arange(G, device=Mcol_fw.device)
    seed_codes = seed_codes.long()
    seed_blc, seed_blw = seed_blc.to(dtype), seed_blw.to(dtype)
    prior = seed.log_num_seeds.to(dtype)

    eq = seed_codes[:, :, None, None] == seed.seed_char.long()[:, None]
    sc_seed = torch.where(eq, seed_blc[:, :, None, None],
                          seed_blw[:, :, None, None])              # [G,P,H,S]
    Ml = Mcol_fw[gi[:, None], seed.seed_fw_row.long()].permute(0, 2, 3, 1)
    Mr = Mcol_rev[gi[:, None], seed.seed_rev_row.long()].permute(0, 2, 3, 1)
    vals = prior[:, None, None, None] + sc_seed + Ml + Mr
    vals = torch.where(seed.seed_valid.bool()[:, None, None, :], vals, NEG)

    p3 = prior[:, None, None]
    eqA = seed_codes[:, :, None] == seed.first_char.long()[:, None, :]
    scA = torch.where(eqA, seed_blc[:, :, None], seed_blw[:, :, None])
    cfgA = p3 + scA + l_prob[:, :, None] + Mcol_rev[gi, seed.cfg_rev_row.long()]
    eqB = seed_codes[:, :, None] == seed.last_char.long()[:, None, :]
    scB = torch.where(eqB, seed_blc[:, :, None], seed_blw[:, :, None])
    cfgB = p3 + scB + r_prob[:, :, None] + Mcol_fw[gi, seed.cfg_fw_row.long()]

    allv = torch.cat([vals, cfgA[..., None], cfgB[..., None]], dim=-1)
    m = torch.amax(allv, dim=-1)
    return m + torch.log(torch.sum(torch.exp(allv - m[..., None]), dim=-1))


def batched_forward(l_seg, r_seg, fw_meta, rev_meta, seed, seed_codes,
                    seed_quals, R_fw: int, R_rev: int, sr_fw: int,
                    sr_rev: int, h_real, periods, dtype):
    """Batched full forward pass: LL [G, P, H].

    The left read segment aligns against the forward haplotype and the
    reversed right segment against the reversed haplotype (K1 then K2 for
    each), then the seed base marginalises over anchor positions.  Columns
    h >= h_real[g] hold NEG garbage that callers slice off."""
    E_fw = emissions_batched(l_seg.codes, l_seg.quals, fw_meta.rep_rev_codes,
                             fw_meta.rep_len, periods, dtype)
    E_rev = emissions_batched(r_seg.codes, r_seg.quals,
                              rev_meta.rep_rev_codes, rev_meta.rep_len,
                              periods, dtype)
    Mcol_fw, l_prob = segment_forward(l_seg.codes, l_seg.quals,
                                      l_seg.last_col, fw_meta, E_fw, R_fw,
                                      sr_fw, h_real, periods, dtype)
    Mcol_rev, r_prob = segment_forward(r_seg.codes, r_seg.quals,
                                       r_seg.last_col, rev_meta, E_rev, R_rev,
                                       sr_rev, h_real, periods, dtype)
    seed_blw, seed_blc = expand_quals(seed_quals, dtype)
    return seed_combine(Mcol_fw, Mcol_rev, l_prob, r_prob, seed, seed_codes,
                        seed_blw, seed_blc, dtype)
