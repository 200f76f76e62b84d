"""The sharded dispatch in the host worker pool, and the port's
counterparts of __graft_entry__.py (test_torch_shard.py has the rest of
the sharded dispatch).

* the `default` golden configuration pooled (--host-workers 2) on the
  card's path forced on the CPU, each dispatch sharded over [cpu] * 2,
  writes tests/data/torch_port_golden_default_f64.vcf byte for byte;
* `graft_entry.entry()` equals `__graft_entry__.entry()`'s JAX output in
  float32;
* `graft_entry.dryrun_multichip` runs on CPU shards and refuses `cuda`
  without the cards.
"""

import jax
import numpy as np
import pytest

import __graft_entry__
from hipstr_tpu_torch import graft_entry

from test_torch_shard import check_sharded_golden, golden_default  # noqa: F401
from test_torch_slice import one_torch_thread  # noqa: F401

# float32 entry point against the JAX one (ROADMAP: the float32 tolerance
# of the HMM forward, tests/test_pallas_hmm2.py)
ENTRY_TOL = 1e-5


def test_pooled_sharded_golden_default_is_byte_identical(
        golden_default, monkeypatch, tmp_path):  # noqa: F811
    check_sharded_golden(golden_default, 2, "card_path", 2, monkeypatch,
                         tmp_path)


def test_entry_equals_the_jax_entry():
    # the JAX entry point is float32 throughout: run it without the x64
    # mode that tests/conftest.py turns on
    with jax.enable_x64(False):
        jfn, jargs = __graft_entry__.entry()
        want = np.asarray(jfn(*jargs))
    fn, args = graft_entry.entry("cpu")
    got = fn(*args).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ENTRY_TOL, atol=ENTRY_TOL)


def test_dryrun_multichip_on_cpu_shards(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "2 shards on the CPU" in out and "dryrun_multichip ok" in out


def test_dryrun_multichip_needs_the_cards():
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(2, device="cuda")
    with pytest.raises(RuntimeError):
        graft_entry.entry("cuda")

