"""The golden suites' configurations on the port, held to float64 anchors.

For each configuration of hipstr_tpu_torch.utils.simdata.GOLDEN_CONFIGS
(the datasets and flags of tests/test_golden_vs_reference.py and
tests/test_golden_realistic.py, plus the EM run with SNP phasing and every
--output-* flag):
* `write_golden` writes the files tools/make_golden_data.py writes, byte
  for byte;
* the anchor tests/data/torch_port_golden_<name>_f64.vcf is current: the
  body of `python -m hipstr_tpu.cli --dtype float64` on the tool's dataset;
* the port's CLI on the CPU in float64 writes the anchor's body batched
  (--host-workers 1), sequentially (--batch-loci 0) and on the card's
  batched code path (the device EM where no model is given, and the fused
  posteriors) forced on the CPU.
chip_smoke.py holds the port's runs on the card to the same anchors.  The
configurations are spread over test_torch_golden_{a,b,c,d}.py, which share
the helpers here; `python tests/test_torch_golden_a.py [name ...]` rewrites
anchors from the JAX package.
"""

import filecmp
import os
import subprocess
import sys
import tempfile

import pytest

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.utils.simdata import (GOLDEN_CONFIGS, golden_args,
                                            golden_tool_args, write_golden)

from test_torch_slice import (ROOT, _body, one_torch_thread,  # noqa: F401
                              run_jax_cli)

# the port's run modes: extra flags
MODES = {"batched": ["--host-workers", "1"],
         "sequential": ["--batch-loci", "0"],
         "card_path": ["--host-workers", "1"]}


def anchor_path(name: str) -> str:
    return os.path.join(ROOT, "tests", "data",
                        f"torch_port_golden_{name}_f64.vcf")


def card_em_rule(opts, device) -> bool:
    """executor.device_em_enabled without its device check: the card's
    choice of the device EM, made on the CPU."""
    return opts.def_stutter_model is None and not opts.stutter_in


def make_tool_dataset(name: str, d: str) -> None:
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_golden_data.py"), d]
                   + golden_tool_args(name), check=True, capture_output=True,
                   timeout=300)


def golden_datasets(tmp_path_factory):
    """name -> (the tool's dataset dir, write_golden's dataset dir), each
    made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            base = tmp_path_factory.mktemp(f"golden_{name}")
            tool, port = str(base / "tool"), str(base / "port")
            make_tool_dataset(name, tool)
            write_golden(port, **GOLDEN_CONFIGS[name][0])
            cache[name] = tool, port
        return cache[name]
    return get


def check_writer(tool: str, port: str) -> None:
    names = sorted(os.listdir(tool))
    assert names == sorted(os.listdir(port)) and "sim.bam" in names
    for f in names:
        assert filecmp.cmp(f"{tool}/{f}", f"{port}/{f}", shallow=False), f


def check_anchor(name: str, tool: str) -> None:
    run_jax_cli(golden_args(name, tool, f"{tool}/jax.vcf")
                + ["--dtype", "float64"])
    want = _body(anchor_path(name))
    assert want and _body(f"{tool}/jax.vcf") == want


def check_port(name: str, port: str, mode: str, monkeypatch) -> None:
    if mode == "card_path":
        monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
        monkeypatch.setattr(executor, "device_post_enabled",
                            lambda device: True)
    out = f"{port}/{mode}.vcf"
    pipeline, counters = cli.run(golden_args(name, port, out)
                                 + ["--dtype", "float64", "--device", "cpu"]
                                 + MODES[mode])
    assert counters.genotype_fail == 0
    if mode == "card_path" and "--def-stutter-model" not in \
            GOLDEN_CONFIGS[name][1]:
        assert pipeline.last_run_stats["em_waves"] > 0
    assert _body(out) == _body(anchor_path(name))


NAMES = ["realistic", "snp"]


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


def write_anchors(names) -> None:
    """Rewrite the anchors of `names` from the JAX CLI's float64 run."""
    for name in names:
        with tempfile.TemporaryDirectory() as d:
            make_tool_dataset(name, d)
            run_jax_cli(golden_args(name, d, f"{d}/jax.vcf")
                        + ["--dtype", "float64"])
            with open(anchor_path(name), "w") as fh:
                fh.writelines(_body(f"{d}/jax.vcf"))


if __name__ == "__main__":
    write_anchors(sys.argv[1:] or list(GOLDEN_CONFIGS))
