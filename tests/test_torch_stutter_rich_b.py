"""The stutter-rich anchor set on the port's batched path with the card's
device EM and fused posteriors forced on the CPU (K1 and K2's plain
versions): in float64 the anchor's records and models of the loci it runs
byte for byte, in float32 every record within the golden drift bands (see
test_torch_stutter_rich.py)."""

import pytest

import chip_smoke
from hipstr_tpu_torch.parallel import executor

from test_torch_golden_a import card_em_rule
from test_torch_slice import one_torch_thread  # noqa: F401
from test_torch_stutter_rich import (CPU_LOCI, anchor_models, anchor_records,
                                     cpu_chroms, run_cpu_loci,
                                     write_anchor_set)


@pytest.fixture(scope="module")
def anchor_dir(tmp_path_factory):
    return write_anchor_set(str(tmp_path_factory.mktemp("stutter_rich_b")))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_card_path_writes_the_anchor(anchor_dir, dtype, monkeypatch):
    monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
    monkeypatch.setattr(executor, "device_post_enabled", lambda dev: True)
    chroms = cpu_chroms()
    pipeline, _, body, models = run_cpu_loci(
        anchor_dir, f"card_{dtype}", ["--dtype", dtype, "--host-workers",
                                      "1"])
    stats = pipeline.last_run_stats
    assert stats["em_waves"] == 1
    hist = stats["em_iter_hist"]
    assert sum(hist.values()) == len(CPU_LOCI) and min(hist) >= 3
    if dtype == "float64":
        assert body == anchor_records(chroms)
        assert models == anchor_models(chroms)
    else:
        chip_smoke.hold_bodies("stutter-rich f32", body,
                               anchor_records(chroms))
