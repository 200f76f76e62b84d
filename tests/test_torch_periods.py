"""Repeat periods 5-9 on the port, held to a frozen float64 anchor.

The loci of utils.simdata.period_loci (one of each period 5-9, and a
period-8 locus whose learned model is the pseudocounts alone) through the
port's CLI on the CPU in float64 without a stutter model:
* batched on the card's code path forced on the CPU (the device EM and
  the fused posteriors; K1 and K2's plain versions),
* sequentially (--batch-loci 0: the host EM, K1 and K3's plain versions),
each writes the body of tests/data/torch_port_periods_f64.vcf, the JAX
CLI's float64 run on the CPU (its host EM).  chip_smoke.py holds the
card's runs to the same anchor.  A port locus of 150-bp reads costs
~4-9 s here (K1's plain version), so the sequential run is in
test_torch_periods_b.py, which shares the helpers here.

`PYTHONPATH=.:tests python tests/test_torch_periods.py` rewrites the
anchor from the JAX CLI.
"""

import os
import sys
import tempfile

import pytest

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.utils.simdata import LEARN_ARGS, period_loci, write_sim

from test_torch_golden_a import card_em_rule
from test_torch_slice import (ROOT, _body, _cli_args,  # noqa: F401
                              one_torch_thread, run_jax_cli)

PERIODS_VCF = os.path.join(ROOT, "tests", "data", "torch_port_periods_f64.vcf")
ARGS = LEARN_ARGS + ["--dtype", "float64", "--device", "cpu"]
MODES = {"card_path": ["--host-workers", "1"],
         "sequential": ["--batch-loci", "0"]}


def write_periods(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("periods"))
    write_sim(d, period_loci())
    return d


@pytest.fixture(scope="module")
def periods_dir(tmp_path_factory):
    return write_periods(tmp_path_factory)


def test_anchor_covers_periods_5_to_9():
    want = _body(PERIODS_VCF)
    assert len(want) == len(period_loci())
    assert sorted({int(l.split("PERIOD=")[1].split(";")[0])
                   for l in want}) == [5, 6, 7, 8, 9]


def check_port(d: str, mode: str, monkeypatch) -> None:
    if mode == "card_path":
        monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
        monkeypatch.setattr(executor, "device_post_enabled",
                            lambda dev: True)
    out = f"{d}/{mode}.vcf"
    pipeline, counters = cli.run(_cli_args(d, out) + ARGS + MODES[mode])
    assert counters.genotype_success == len(period_loci())
    assert counters.genotype_fail == 0
    if mode == "card_path":
        assert pipeline.last_run_stats["em_waves"] == 1
    assert _body(out) == _body(PERIODS_VCF)


def test_card_path_writes_the_periods_anchor(periods_dir, monkeypatch):
    check_port(periods_dir, "card_path", monkeypatch)


def write_anchor() -> None:
    """Rewrite tests/data/torch_port_periods_f64.vcf from the JAX CLI."""
    with tempfile.TemporaryDirectory() as d:
        write_sim(d, period_loci())
        run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + LEARN_ARGS
                    + ["--dtype", "float64"])
        with open(PERIODS_VCF, "w") as fh:
            fh.writelines(_body(f"{d}/jax.vcf"))


if __name__ == "__main__":
    write_anchor()
    sys.exit(0)
