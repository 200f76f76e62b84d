"""The batched dispatch sharded over several devices (the JAX executor's
locus mesh) and the per-device kernel launch.

* `executor.shard_bounds` cuts a chunk of G loci as the JAX mesh puts a
  locus axis on n devices (GSPMD's even split, the padding dropped);
* the `default` golden configuration, batched in-process in float64 with
  its dispatches sharded over [cpu] * 2 (an uneven split) and [cpu] * 4
  (an empty shard), on the host path and on the card's path forced on the
  CPU (fused posteriors), writes
  tests/data/torch_port_golden_default_f64.vcf byte for byte;
* `device.local_devices` is what `jax.local_devices()` is to the JAX
  executor; `kernels.stream` and `kernels.launch` use the tensors' card;
  K2, K3 and K4 allow their shared memory per device.
test_torch_shard_b.py holds the pooled sharded run and the port's
counterparts of __graft_entry__.py.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from hipstr_tpu_torch import cli, kernels
from hipstr_tpu_torch.device import local_devices
from hipstr_tpu_torch.parallel import executor, workers
from hipstr_tpu_torch.utils.simdata import golden_args, write_golden

from test_torch_golden_a import anchor_path, card_em_rule
from test_torch_slice import _body, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
MESH_MSG = "Sharding locus batches over {} devices"


def jax_mesh_rows(G: int, n: int):
    """The rows of a locus axis of G that the JAX executor's mesh of n
    devices holds on each device, in the mesh's order, with the padding to
    a multiple of n (hipstr_tpu/parallel/executor.py:_dispatch_chunk)
    dropped."""
    devs = jax.devices()[:n]
    assert len(devs) == n
    padded = -(-G // n) * n
    sharding = NamedSharding(Mesh(np.array(devs), ("loci",)),
                             PartitionSpec("loci"))
    x = jax.device_put(np.arange(padded), sharding)
    rows = {s.device: [int(v) for v in np.asarray(s.data) if v < G]
            for s in x.addressable_shards}
    return [rows[d] for d in devs]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("G", [1, 3, 5, 32])
def test_shard_bounds_match_the_jax_mesh(G, n):
    bounds = executor.shard_bounds(G, n)
    assert len(bounds) == n
    assert [list(range(a, b)) for a, b in bounds] == jax_mesh_rows(G, n)


def test_fetch_joins_the_shards_in_locus_order():
    a, b = torch.arange(6.0).reshape(2, 3), torch.arange(6.0, 9.0)[None]
    assert np.array_equal(executor._fetch([a, b]),
                          np.arange(9.0).reshape(3, 3))
    got = executor._fetch([(a, a[:, :1]), (b, b[:, :1])])
    assert [x.shape for x in got] == [(3, 3), (3, 1)]
    assert np.array_equal(got[1][:, 0], [0.0, 3.0, 6.0])
    assert executor._fetch([a]).shape == (2, 3)


@pytest.fixture(scope="module")
def golden_default(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden_default"))
    write_golden(d, loci=3, samples=3, reads=40)
    return d


def check_sharded_golden(d: str, n: int, path: str, host_workers: int,
                         monkeypatch, tmp_path) -> None:
    """The default golden run (dataset in `d`) with each dispatch sharded
    over n CPU shards writes the anchor; some dispatch is split, and the
    split is logged once."""
    if path == "card_path":
        for mod in (executor, workers):
            monkeypatch.setattr(mod, "device_em_enabled", card_em_rule)
            monkeypatch.setattr(mod, "device_post_enabled",
                                lambda device: True)
    out, log = str(tmp_path / "out.vcf"), str(tmp_path / "run.log")
    args = [a for a in golden_args("default", d, out) if a != "--silent"]
    pipeline, counters = cli.run(
        args + ["--dtype", "float64", "--device", "cpu", "--host-workers",
                str(host_workers), "--log", log], devices=[CPU] * n)
    assert counters.genotype_fail == 0
    assert _body(out) == _body(anchor_path("default"))
    stats = pipeline.last_run_stats
    assert (stats["cards"], stats["shards_per_dispatch"]) == (1, n)
    assert stats["dispatches"] < stats["card_shards"] <= n * stats[
        "dispatches"]
    with open(log) as fh:
        assert fh.read().count(MESH_MSG.format(n)) == 1


@pytest.mark.parametrize("path", ["host", "card_path"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_golden_default_is_byte_identical(golden_default, n, path,
                                                  monkeypatch, tmp_path):
    check_sharded_golden(golden_default, n, path, 1, monkeypatch, tmp_path)


def test_local_devices(monkeypatch):
    assert local_devices("cpu") == [CPU]
    # a --distributed rank's card (parallel/distributed.place) alone
    assert local_devices(torch.device("cuda", 1)) == [torch.device("cuda", 1)]
    with pytest.raises(RuntimeError):
        local_devices("cuda")                 # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert local_devices("cuda") == [torch.device("cuda", i)
                                     for i in range(3)]
    assert executor.dispatch_devices(torch.device("cuda")) == \
        local_devices("cuda")
    assert executor.dispatch_devices(CPU, [CPU, CPU]) == [CPU, CPU]
    with pytest.raises(ValueError):
        executor.dispatch_devices(CPU, [CPU, torch.device("cuda", 0)])


class _Stream:
    cuda_stream = 0x1234


def test_stream_and_launch_use_the_tensors_card(monkeypatch):
    """kernels.stream asks for the stream of the card it is given, and
    kernels.launch makes that card current around the launch and passes
    its stream last."""
    asked, entered, calls = [], [], []

    def current_stream(device=None):
        asked.append(device)
        return _Stream()

    @contextlib.contextmanager
    def device_ctx(device):
        entered.append(device)
        yield

    def fn(*args):
        calls.append((list(entered), args))
        return 0

    card = torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(kernels, "launcher", lambda name, dtype: fn)
    assert kernels.stream(card).value == _Stream.cuda_stream
    assert asked == [card]
    n0 = kernels.LAUNCHES["segment"]
    kernels.launch("segment", torch.float32, card, (1, 2), "a", "b")
    (during, args), = calls
    assert during == [card] and asked == [card, card]
    assert args[:2] == ("a", "b") and args[2].value == _Stream.cuda_stream
    assert kernels.LAUNCHES["segment"] == n0 + 1
    kernels.LAUNCHES["segment"] = n0
    kernels.SHAPES["segment"][(1, 2)] -= 1


def test_a_failed_launch_raises(monkeypatch):
    @contextlib.contextmanager
    def device_ctx(device):
        yield

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(kernels, "launcher", lambda name, dtype:
                        lambda *args: 1)
    n0 = kernels.LAUNCHES["emission"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.launch("emission", torch.float64, torch.device("cuda", 1),
                       (1,))
    assert kernels.LAUNCHES["emission"] == n0


def test_no_process_wide_shared_memory_record_in_csrc():
    """K2, K3 and K4 allow their dynamic shared memory per device
    (dp_warp.cuh's allow_smem); K1 stays under the default 48 KB."""
    from hipstr_tpu_torch.ops.emission import DEFAULT_SMEM, emission_smem
    for name in ("segment", "flank_scan", "segment_scan"):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert "static int configured" not in src
        assert "dpw::allow_smem(kern, smem, allowed)" in src
        assert "static int allowed[dpw::kMaxDevices]" in src
    assert emission_smem(kernels.MAX_LANES, 4096, 8) == DEFAULT_SMEM
