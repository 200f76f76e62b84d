"""Each frozen bound function equals chip_smoke's on fixed arguments."""

import sys
from pathlib import Path

import pytest
import torch

from strbench.roofline import emission, segment

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402


def emission_args(dtype):
    g = torch.Generator().manual_seed(1)
    G, P, L, O, B = 3, 40, 128, 5, 24
    return (torch.randint(0, 5, (G, P, L), generator=g, dtype=torch.int32),
            torch.zeros(G, P, L, dtype=dtype), torch.zeros(G, P, L,
                                                           dtype=dtype),
            torch.randint(0, 4, (G, O, B), generator=g, dtype=torch.int32),
            torch.tensor([[4, 8, 0, 12, 3], [6, 0, 0, 9, 24], [1, 2, 3, 0,
                                                                0]],
                         dtype=torch.int32),
            torch.tensor([1, 3, 6], dtype=torch.int32))


def segment_args(dtype):
    g = torch.Generator().manual_seed(2)
    G, H, P, L, R, O = 2, 16, 50, 128, 40, 6
    f = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    i = lambda *s: torch.zeros(*s, dtype=torch.int32)  # noqa: E731
    hap_opt = torch.randint(0, O, (G, H), generator=g, dtype=torch.int32)
    bounds = torch.tensor([[5, 30, 11, 2], [1, 38, 16, 4]], dtype=torch.int32)
    return (i(G, P, L), f(G, P, L), f(G, P, L), f(G, P, L), f(G, P, L),
            i(G, P), i(G, H, R), f(G, H, R), f(G, H, R), f(G, H, R),
            f(G, O, 13, P, L), hap_opt, i(G, H), f(G, H, 13), bounds)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "float32"),
                                        (torch.float64, "float64")])
def test_emission_bound(dtype, name):
    args = emission_args(dtype)
    assert emission.bound_emission(args, {}, name) == \
        chip_smoke.bound_emission(args, {}, name)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "float32"),
                                        (torch.float64, "float64")])
def test_segment_bound(dtype, name):
    args, kw = segment_args(dtype), dict(R=40, sr=17)
    assert segment.bound_segment(args, kw, name) == \
        chip_smoke.bound_segment(args, kw, name)


def test_captured_bounds_equal_the_wrappers():
    a = emission_args(torch.float32)
    cap = dict(codes=tuple(a[0].shape), brev=tuple(a[3].shape), itemsize=4,
               blen=a[4], periods=a[5])
    assert emission.captured_bound(cap, "float32") == \
        emission.bound_emission(a, {}, "float32")
    s = segment_args(torch.float64)
    cap = dict(codes=tuple(s[0].shape), itemsize=8, H=16, O=6, hap_opt=s[11],
               bounds=s[14], R=40, sr=17)
    assert segment.captured_bound(cap, "float64") == \
        segment.bound_segment(s, dict(R=40, sr=17), "float64")


def test_peaks_equal_chip_smoke():
    from strbench.roofline import peaks
    assert peaks.PEAK_OPS == chip_smoke.PEAK_OPS
    assert peaks.PEAK_BYTES == chip_smoke.PEAK_BYTES
