"""Repeat periods 5-9 on the port's sequential path (--batch-loci 0: the
host EM, K1 and K3's plain versions) on the CPU in float64: the body of
tests/data/torch_port_periods_f64.vcf (see test_torch_periods.py)."""

import pytest

from test_torch_periods import check_port, write_periods
from test_torch_slice import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def periods_dir(tmp_path_factory):
    return write_periods(tmp_path_factory)


def test_sequential_writes_the_periods_anchor(periods_dir, monkeypatch):
    check_port(periods_dir, "sequential", monkeypatch)
