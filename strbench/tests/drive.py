"""Drive the harness's run of a cell from a test, past its look for a
card: on the CPU at a size a test run holds, with the card's device EM
and fused posteriors switched on as the card runs them, or on the card at
the cell's own size; faults planted in the program's path underneath."""

from __future__ import annotations

import torch

from strbench import check, harness, spec

CPU_SIZE = dict(samples=3, reads_per_sample=12, read_len=100, loci=400,
                batch_loci=4, warmup_loci=16, em_sample=6,
                dispatch_sample=2, loci_per_dispatch=2, record_every=8,
                record_sample=6)


def card_path_on_cpu(monkeypatch):
    """The device EM and the fused posteriors on CPU tensors (the tests of
    the port do the same: tests/test_torch_workers.py)."""
    from hipstr_tpu_torch.parallel import executor, workers
    for mod in (executor, workers):
        monkeypatch.setattr(mod, "device_em_enabled", lambda opts, dev: (
            opts.def_stutter_model is None and not opts.stutter_in))
        monkeypatch.setattr(mod, "device_post_enabled", lambda dev: True)


def small_cell(name: str) -> dict:
    cell = spec.cell(spec.load(), name)
    cell["config"].update(CPU_SIZE)
    cell["config"]["cli"] = ["--use-unpaired", "--min-reads", "20"]
    cell["traffic"]["params"] = dict(cell["traffic"]["params"], periods=2)
    return cell


def run(cell: dict, name: str, seed: int, seconds: float, device,
        control: bool = False):
    """(result, rows, program numbers, control numbers or None)."""
    seen = {}
    numbers = check.numbers

    def both(hooks, truth, dev, control_=False, record_sample=16):
        seen["program"] = numbers(hooks, truth, dev,
                                  record_sample=record_sample)
        if control:
            seen["control"] = numbers(hooks, truth, dev, control=True,
                                      record_sample=record_sample)
        return seen["program"]
    check.numbers = both
    try:
        result, rows = harness.run_cell(cell, name, seed, seconds, False,
                                        torch.device(device), spec.load())
    finally:
        check.numbers = numbers
    return result, rows, seen["program"], seen.get("control")
