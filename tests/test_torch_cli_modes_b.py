"""The CLI modes `viz`, `bam_samps`, `ref_vcf`, `cram` on the port, held to their float64 anchors
(see test_torch_cli_modes_a.py, whose helpers these tests share)."""

import pytest

from test_torch_cli_modes_a import (cases, check_anchor, check_port,
                                    check_writer, mode_datasets)
from test_torch_slice import one_torch_thread  # noqa: F401

NAMES = ["viz", "bam_samps", "ref_vcf", "cram"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    return mode_datasets(tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_mode_writer_equals_the_jax_test(name, tmp_path):
    check_writer(name, tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_mode_anchor_is_current(datasets, name):
    check_anchor(name, datasets(name))


@pytest.mark.parametrize("name,mode", cases(NAMES))
def test_port_writes_the_mode_anchor(datasets, name, mode, monkeypatch):
    check_port(name, datasets(name), mode, monkeypatch)
