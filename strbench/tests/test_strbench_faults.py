"""A run with the timed path broken underneath comes out not correct:
one run for each fault the cells can have, on the CPU at a size a test
run holds (the harness's look for a card skipped; the card's device EM and
fused posteriors switched on).  The cells run on one card, so there is no
exchange between cards to leave out.  Minutes on the CPU: run with
`python -m pytest strbench/tests -q`."""

import pytest
import torch

from strbench.tests import drive

CELL = "trio30x.stutter"


def unchanged_state(monkeypatch):
    """The EM hands back the state it started from: its first model,
    converged."""
    from hipstr_tpu_torch.parallel import workers
    from strbench.reference.em import DEFAULT
    orig = workers.solve_em

    def solve_em(problems, *a, **kw):
        params, conv = orig(problems, *a, **kw)
        params[:] = DEFAULT
        conv[:] = True
        return params, conv
    monkeypatch.setattr(workers, "solve_em", solve_em)


def half_the_batch(monkeypatch):
    """Each dispatch computes half of its reads; the rest take the mean of
    those."""
    from hipstr_tpu_torch.parallel import executor
    orig = executor.batched_forward

    def batched_forward(*a, **kw):
        LL = orig(*a, **kw)
        half = LL.shape[1] // 2
        LL[:, half:] = LL[:, :half].mean(dim=1, keepdim=True)
        return LL
    monkeypatch.setattr(executor, "batched_forward", batched_forward)


def altered_answer(monkeypatch):
    """One log-likelihood of each locus altered where the dispatch
    produces it."""
    from hipstr_tpu_torch.parallel import executor
    orig = executor.batched_forward

    def batched_forward(*a, **kw):
        LL = orig(*a, **kw)
        LL[:, 0, 0] += 0.5
        return LL
    monkeypatch.setattr(executor, "batched_forward", batched_forward)


class _Altered:
    """A worker's end of the pool's pipe as the parent reads it, with each
    settled locus's record changed by `change`."""

    def __init__(self, conn, change):
        self.conn, self.change = conn, change

    def recv(self):
        msg = self.conn.recv()
        if msg[0] == "settled" and msg[2] is not None:
            msg = (msg[0], msg[1], self.change(msg[2]), msg[3])
        return msg

    def __getattr__(self, name):
        return getattr(self.conn, name)


def _on_records(monkeypatch, change):
    from strbench import capture
    init = capture._ParentEnd.__init__

    def altered(self, conn, hooks):
        init(self, _Altered(conn, change), hooks)
    monkeypatch.setattr(capture._ParentEnd, "__init__", altered)


def dropped_record(monkeypatch):
    """Every locus settles, but without its genotype: the worker's record
    is lost on the way to the VCF."""
    _on_records(monkeypatch, lambda rec: None)


def altered_genotype(monkeypatch):
    """Each record's first sample's call changed where the worker wrote
    it: one bp more on its first allele."""
    def change(rec):
        cols = rec[2].split("\t")
        f = cols[9].split(":")
        if f[0] != ".":
            a, b = f[1].split("|")
            f[1] = f"{int(a) + 1}|{b}"
            cols[9] = ":".join(f)
        return (rec[0], rec[1], "\t".join(cols))
    _on_records(monkeypatch, change)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct(monkeypatch):
    drive.card_path_on_cpu(monkeypatch)
    result, rows, nums, _ = drive.run(drive.small_cell(CELL), CELL,
                                      2 ** 32 + 11, 30.0, "cpu")
    assert result["attempted"] > 0, rows
    assert result["correct"], rows


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch,
                                   altered_answer, dropped_record,
                                   altered_genotype],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    drive.card_path_on_cpu(monkeypatch)
    fault(monkeypatch)
    result, rows, nums, _ = drive.run(drive.small_cell(CELL), CELL,
                                      2 ** 32 + 11, 30.0, "cpu")
    assert result["attempted"] > 0, rows
    assert not result["correct"], rows
