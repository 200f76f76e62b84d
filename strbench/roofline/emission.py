"""K1, the stutter-block emission kernel (csrc/emission.cu): operations
and bytes of one launch, a frozen copy of chip_smoke.bound_emission.

Per lane of a real repeat option (blen > 0) and block step (blen + 1 of
them): 7 prefix updates of 2 operations, 12 log-sum-exp terms of 4 (one
exp), 6 insertion-shift updates of 5; per lane 6 * period
insertion-prefix steps of 2 operations and 13 outputs (a log each).  Bytes:
the read codes and both quality planes read once, the repeat alleles and
periods once, E [G, O, 13, P, L] written once."""

from .peaks import bound

K1_STEP_OPS, K1_STEP_EXP = 7 * 2 + 12 * 4 + 6 * 5, 12
KERNEL = "emission_kernel"


def launch_bound(codes_shape, brev_shape, itemsize, blen, periods,
                 dtype_name):
    """The bound of one launch from its shapes, blen [G, O] and periods
    [G] (host tensors)."""
    G, P, L = codes_shape
    O, B = brev_shape[1:]
    steps = (blen + 1) * (blen > 0)
    lanes_real = int((blen > 0).sum()) * P * L
    per = periods.long()[:, None].expand(G, O)[blen > 0]
    ops = P * L * (K1_STEP_OPS * int(steps.sum()) + 12 * int(per.sum())) \
        + lanes_real * 13
    exp_log = P * L * K1_STEP_EXP * int(steps.sum()) + lanes_real * 13
    nbytes = G * P * L * (4 + 2 * itemsize) + G * O * (B + 1) * 4 + G * 4 \
        + G * O * 13 * P * L * itemsize
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_emission(args, kwargs, dtype_name):
    """chip_smoke.bound_emission's signature: the wrapper's arguments
    (codes, blw, blc, brev, blen, periods)."""
    codes, blw, blc, brev, blen, periods = args
    return launch_bound(tuple(codes.shape), tuple(brev.shape),
                        blc.element_size(), blen.cpu(), periods.cpu(),
                        dtype_name)


def captured_bound(c, dtype_name):
    """The bound of a launch the harness captured (strbench/capture.py)."""
    return launch_bound(c["codes"], c["brev"], c["itemsize"], c["blen"].cpu(),
                        c["periods"].cpu(), dtype_name)
