"""K2, the batched segment forward kernel (csrc/segment.cu): operations
and bytes of one launch, a frozen copy of chip_smoke.bound_segment.

Per DP cell (lane x row) of a flank row 16 operations; row 0 and the
forced-match row 2 per lane; the stutter row 13 terms of 8 operations and
one log per lane; only the rows each locus's bounds make active and its
real haplotypes count.  Bytes: reads, quality planes and prefix sums once,
row metadata once, the emission planes real haplotypes read once, Mcol
written once."""

from .peaks import bound

FLANK_OPS, EDGE_OPS, STUTTER_OPS = 16, 2, 13 * 8 + 1
KERNEL = "segment_kernel"


def used_planes(hap_opt, h_real):
    """Emission planes (locus, option) that real haplotypes read."""
    return sum(len(set(ho[:hr].tolist())) for ho, hr in zip(hap_opt, h_real))


def launch_bound(codes_shape, itemsize, H, O, hap_opt, bounds, R, sr,
                 dtype_name):
    G, P, L = codes_shape
    start1, end3, h_real = (bounds[:, k].long() for k in range(3))
    flank = (sr - start1) + (end3 - sr - 2)
    per_lane = FLANK_OPS * flank + 2 * EDGE_OPS + STUTTER_OPS
    lanes = h_real * P * L
    ops = int((lanes * per_lane).sum())
    exp_log = int(lanes.sum()) * (2 * 13 + 1)
    sz = itemsize
    nbytes = G * P * L * (4 + 4 * sz) + G * P * 4 + G * H * R * (4 + 3 * sz) \
        + used_planes(hap_opt, h_real.tolist()) * 13 * P * L * sz \
        + G * H * (8 + 13 * sz) + G * 16 + G * H * R * P * sz
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_segment(args, kwargs, dtype_name):
    """chip_smoke.bound_segment's signature: segment_kernel's arguments and
    its R, sr."""
    return launch_bound(tuple(args[0].shape), args[2].element_size(),
                        args[6].shape[1], args[10].shape[1], args[11].cpu(),
                        args[14].cpu(), kwargs["R"], kwargs["sr"], dtype_name)


def captured_bound(c, dtype_name):
    return launch_bound(c["codes"], c["itemsize"], c["H"], c["O"],
                        c["hap_opt"].cpu(), c["bounds"].cpu(), c["R"],
                        c["sr"], dtype_name)
