"""The control comes out not correct where the program comes out correct:
the reference computed in bfloat16 (the nearest precision below the
configuration's float32) put in the program's place, on three seeds of
each cell at the cell's own size.  On the card only:
`python -m pytest strbench/tests/test_strbench_control.py -q`, or, to print
the readings that the limits are set from,
`python -m strbench.tests.test_strbench_control <cell> <seconds> <seed>...`."""

import json
import sys

import pytest

from strbench import check, spec
from strbench.tests import drive

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def readings(cell_name: str, seed: int, seconds: float, device="cuda"):
    cell = spec.cell(spec.load(), cell_name)
    result, rows, prog, ctrl = drive.run(cell, cell_name, seed, seconds,
                                         device, control=True)
    return result, prog, ctrl, cell["limits"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", [w["name"] for w in
                                       spec.load()["workloads"]])
def test_control_fails_where_the_program_passes(card, cell_name, seed):
    result, prog, ctrl, limits = readings(cell_name, seed, 10.0)
    assert result["correct"], prog
    ok, rows = check.verdict(ctrl, limits, 0, result["attempted"])
    assert not ok, rows


if __name__ == "__main__":
    name, secs = sys.argv[1], float(sys.argv[2])
    for s in sys.argv[3:]:
        result, prog, ctrl, _ = readings(name, int(s), secs)
        print(json.dumps(dict(cell=name, seed=int(s), correct=result[
            "correct"], attempted=result["attempted"], program=prog,
            control=ctrl)), flush=True)
