"""The golden configurations `em8`, `deep`, `hp10x` on the port, held to their float64
anchors (see test_torch_golden_a.py, whose helpers these tests share)."""

import pytest

from test_torch_golden_a import (MODES, check_anchor, check_port,
                                 check_writer, golden_datasets)
from test_torch_slice import one_torch_thread  # noqa: F401

NAMES = ['em8', 'deep', 'hp10x']


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    return golden_datasets(tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_write_golden_equals_the_tool(datasets, name):
    check_writer(*datasets(name))


@pytest.mark.parametrize("name", NAMES)
def test_golden_anchor_is_current(datasets, name):
    check_anchor(name, datasets(name)[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_port_writes_the_golden_anchor(datasets, name, mode, monkeypatch):
    check_port(name, datasets(name)[1], mode, monkeypatch)
