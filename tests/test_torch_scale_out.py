"""The port's scale-out and tracing options on the CPU, in float64 on the
reference dataset (utils.simdata.reference_loci(), REFERENCE_ARGS), held
to tests/data/torch_port_ref_f64.vcf: the JAX CLI's output on those loci,
kept current by tests/test_torch_reference.py.

* `--workers N` (after tests/test_cli_modes.py::test_workers_merge_identical
  and ::test_workers_merge_bgzip_with_tabix): the merged VCF equals the
  JAX CLI's, a .gz target gets its .tbi, no shard file is left; each
  child gets the parent's --device and --host-workers 1 (the user's
  --host-workers wins), with n > 1 cards child i takes card i mod n; a
  child that fails fails the run with nothing merged;
* `--distributed` (after tests/test_distributed.py): two gloo ranks merge
  to the JAX CLI's VCF, every rank logs the summed counters, no
  .dshard file is left; without a rendezvous, or with --locus-shard, the
  run is refused;
* `--profile DIR`: torch.profiler writes a trace named by this process's
  pid and the VCF is still the JAX CLI's; a trace directory that cannot be made
  fails the run.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.io.bgzf import BgzfReader
from hipstr_tpu_torch.io.vcf_read import VCFReader
from hipstr_tpu_torch.parallel import distributed
from hipstr_tpu_torch.utils.simdata import (REFERENCE_ARGS, reference_loci,
                                            write_sim)

from test_torch_slice import ONE_THREAD, ROOT, _body, one_torch_thread  # noqa: F401,E501

ARGS = ["--dtype", "float64", "--device", "cpu"] + REFERENCE_ARGS
REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The reference dataset (8 trio loci, 20 reads per sample) and the JAX
    CLI's float64 VCF body on it."""
    d = str(tmp_path_factory.mktemp("scale_out"))
    locs = reference_loci()
    write_sim(d, locs)
    body = _body(REF_VCF)
    assert len(body) == len(locs)
    return d, locs, body


def inputs(d):
    return ["--bams", f"{d}/sim.bam", "--fasta", f"{d}/sim.fa", "--regions",
            f"{d}/regions.bed"]


def port_cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    return subprocess.run([sys.executable, "-m", "hipstr_tpu_torch.cli",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def gz_body(path):
    return [l + "\n" for l in BgzfReader(path).read_all().decode()
            .splitlines() if l and not l.startswith("#")]


# --------------------------------------------------------------- --workers
def test_workers_merge_identical(sim, tmp_path):
    d, _, want = sim
    out = str(tmp_path / "two.vcf")
    proc = port_cli(inputs(d) + ARGS + ["--str-vcf", out, "--workers", "2",
                                        "--silent"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _body(out) == want
    assert os.listdir(tmp_path) == ["two.vcf"]


def test_workers_merge_bgzip_with_tabix(sim, tmp_path):
    d, locs, want = sim
    out = str(tmp_path / "m.vcf.gz")
    proc = port_cli(inputs(d) + ARGS + ["--str-vcf", out, "--workers", "2",
                                        "--silent"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert gz_body(out) == want
    rd = VCFReader(out)
    assert rd._tbi is not None
    l0 = locs[0]
    hits = list(rd.query(l0.chrom, l0.region.start - 5, l0.region.stop + 5))
    assert len(hits) == 1
    # no shard temporaries left behind
    assert sorted(os.listdir(tmp_path)) == ["m.vcf.gz", "m.vcf.gz.tbi"]


@pytest.mark.parametrize("extra,host_workers", [
    ([], 1), (["--host-workers", "3"], 3), (["--host-workers=0"], 0)])
def test_workers_children_commands(extra, host_workers):
    argv = ["--bams", "a.bam", "--fasta", "f.fa", "--regions", "r.bed",
            "--str-vcf", "o.vcf", "--stutter-out", "m.txt", "--viz-out",
            "v.gz", "--device", "cpu", "--workers", "3"] + extra
    args = cli.build_parser().parse_args(argv)
    children = cli.worker_commands(args, argv)
    assert len(children) == 3
    for i, (cmd, env, paths) in enumerate(children):
        assert cmd[:3] == [sys.executable, "-m", "hipstr_tpu_torch.cli"]
        assert cmd[3:7] == ["--device", "cpu", "--host-workers", "1"]
        child = cli.build_parser().parse_args(cmd[3:])
        assert (child.device, child.host_workers, child.workers,
                child.locus_shard) == ("cpu", host_workers, 1, f"{i}/3")
        assert paths == (f"o.vcf.shard{i}", f"m.txt.shard{i}",
                         f"v.gz.shard{i}")
        assert (child.str_vcf, child.stutter_out, child.viz_out) == paths
        assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
        assert env.get("CUDA_VISIBLE_DEVICES") == \
            os.environ.get("CUDA_VISIBLE_DEVICES")


@pytest.mark.parametrize("visible,want", [
    (None, ["0", "1", "2", "0"]), ("4,5,6", ["4", "5", "6", "4"])])
def test_workers_take_cards_in_turn(monkeypatch, visible, want):
    """With n > 1 cards child i takes card i mod n (of the parent's
    CUDA_VISIBLE_DEVICES, if set), counted without a CUDA context."""
    monkeypatch.setattr(cli, "resolve_device", lambda name: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    argv = ["--fasta", "f.fa", "--regions", "r.bed", "--str-vcf", "o.vcf",
            "--workers", "4"]
    children = cli.worker_commands(cli.build_parser().parse_args(argv), argv)
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env, _ in children] == want
    assert all(cmd[3:5] == ["--device", "cuda"] for cmd, _, _ in children)
    assert not torch.cuda.is_initialized()


def test_a_failing_child_fails_the_run(sim, tmp_path, monkeypatch, capsys):
    d, _, _ = sim
    make = cli.worker_commands

    def second_fails(args, argv):
        children = make(args, argv)
        cmd, env, paths = children[1]
        children[1] = ([sys.executable, "-c", "import sys; sys.exit(3)"],
                       env, paths)
        return children

    monkeypatch.setattr(cli, "worker_commands", second_fails)
    out = str(tmp_path / "w.vcf")
    rc = cli.main(inputs(d) + ARGS + ["--str-vcf", out, "--workers", "2",
                                      "--silent", "--max-regions", "1"])
    assert rc == 1
    assert "(1, 3)" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_workers_refuse_pass_and_filt_bams(capsys, tmp_path):
    assert cli.main(["--bams", "a.bam", "--fasta", "f.fa", "--regions",
                     "r.bed", "--str-vcf", str(tmp_path / "o.vcf"),
                     "--pass-bam", "p.bam", "--workers", "2"]) == 1
    assert "incompatible" in capsys.readouterr().err


# ----------------------------------------------------------- --distributed
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_matches_single(sim, tmp_path):
    """Two ranks merge to the JAX CLI's single run."""
    d, _, want = sim
    out = str(tmp_path / "dist.vcf")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hipstr_tpu_torch.cli"] + inputs(d) + ARGS
        + ["--str-vcf", out, "--quiet", "--distributed", "--coordinator",
           f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
           str(rank)], cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    assert _body(out) == want
    # the counters summed over both ranks, on every rank
    for rank, err in enumerate(errs):
        assert (f"[{rank}/2] global Summary: success={len(want)} fail=0"
                in err), err
    assert os.listdir(tmp_path) == ["dist.vcf"]


@pytest.mark.parametrize("extra,message", [
    ([], "--coordinator host:port"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id in [0, N)"),
    (["--locus-shard", "0/2"], "drop --locus-shard")],
    ids=["no-rendezvous", "bad-rank", "locus-shard"])
def test_distributed_refusals(monkeypatch, capsys, tmp_path, extra, message):
    for var in distributed.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert cli.main(["--bams", "a.bam", "--fasta", "f.fa", "--regions",
                     "r.bed", "--str-vcf", str(tmp_path / "o.vcf"),
                     "--distributed"] + extra) == 1
    assert message in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_env_rendezvous(monkeypatch):
    """torchrun's env:// variables name the group when no coordinator is
    given."""
    for var, value in zip(distributed.ENV_VARS,
                          ("127.0.0.1", "29500", "4", "3")):
        monkeypatch.setenv(var, value)
    assert distributed.init_method("", 0, -1) == ("env://", 4, 3)
    assert distributed.init_method("h:1", 2, 1) == ("tcp://h:1", 2, 1)


# --------------------------------------------------------------- --profile
@pytest.mark.parametrize("mode", [["--host-workers", "1"],
                                  ["--batch-loci", "0"]],
                         ids=["batched", "sequential"])
def test_profile_writes_a_trace(sim, tmp_path, mode):
    d, _, want = sim
    out, trace = str(tmp_path / "prof.vcf"), tmp_path / "trace"
    cli.run(inputs(d) + ARGS + ["--str-vcf", out, "--silent",
                                "--max-regions", "1", "--profile",
                                str(trace)] + mode)
    assert _body(out) == want[:1]
    files = os.listdir(trace)
    assert len(files) == 1 and f"_{os.getpid()}." in files[0]
    assert files[0].endswith(".pt.trace.json")
    assert os.path.getsize(trace / files[0]) > 0


def test_profile_that_cannot_write_fails_the_run(sim, tmp_path):
    d, _, _ = sim
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(RuntimeError, match="directory"):
        cli.run(inputs(d) + ARGS + ["--str-vcf", str(tmp_path / "o.vcf"),
                                    "--silent", "--max-regions", "1",
                                    "--profile", str(blocker)])
