"""The port's batched stutter EM (hipstr_tpu_torch/ops/em_batched.py)
against the JAX package's em_train_batch and the host EM.

* em_train_batch in float64 on the CPU matches the JAX em_train_batch on
  tests/test_em_batched.py's 8 problems (params and LL rtol 1e-10, equal
  converged flags and iteration counts) and the port's host EM at that
  test's tolerance (rtol 1e-8, atol 1e-10);
* padding and haploid loci, as in tests/test_em_batched.py;
* the stutter log-PMF equals the JAX one on negative and positive
  differences (floor-mod, floor and truncating division);
* reading `active` every iteration or every SYNC_EVERY changes nothing;
* a batched run with the device EM (and fused posteriors) forced on the
  CPU writes the VCF body the JAX CLI writes with its host EM.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hipstr_tpu.ops import em_batched as jax_em
from hipstr_tpu_torch.ops import em_batched
from hipstr_tpu_torch.ops.em import EMStutterGenotyper
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline, Logger,
                                                 PipelineOptions)
from hipstr_tpu_torch.utils.simdata import write_sim
from hipstr_tpu_torch.utils.simulate import simulate_locus

from test_em_batched import _simulate_problem
from test_torch_slice import (_body, _cli_args,  # noqa: F401
                              one_torch_thread, run_jax_cli)

CPU = torch.device("cpu")
PARAMS = np.array([[0.92, 0.07, 0.06, 0.9, 0.02, 0.015]])


def _raws(seed=11):
    """tests/test_em_batched.py's problems: periods 1-4, 3 and 7 samples,
    25 reads each."""
    rng = np.random.default_rng(seed)
    return [_simulate_problem(rng, period, n_samples, 25)[1]
            for period in (1, 2, 3, 4) for n_samples in (3, 7)]


def _train(problems, **kw):
    arrays, (_, _, Sm) = em_batched.pack_problems(problems)
    out = em_batched.em_train_batch(arrays, Sm, CPU, torch.float64, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _host(raw):
    return EMStutterGenotyper(*raw, 0).train()


def _model_params(res):
    sm = res.stutter_model
    return [sm.in_geom, sm.in_up, sm.in_down, sm.out_geom, sm.out_up,
            sm.out_down]


def test_matches_jax_em_train_batch():
    problems = [em_batched.EMProblem.build(*raw) for raw in _raws()]
    arrays, (_, _, Sm) = em_batched.pack_problems(problems)
    want = jax_em.em_train_batch(arrays, Sm, dtype_name="float64")
    got = _train(problems)
    np.testing.assert_allclose(got["params"], np.asarray(want["params"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["total_LL"], np.asarray(want["total_LL"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(want["converged"]))
    np.testing.assert_array_equal(got["iters"], np.asarray(want["iters"]))


def test_matches_host_em():
    raws = _raws()
    got = _train([em_batched.EMProblem.build(*raw) for raw in raws])
    for g, raw in enumerate(raws):
        res = _host(raw)
        assert bool(got["converged"][g]) == res.converged, g
        assert int(got["iters"][g]) == res.num_iterations, g
        np.testing.assert_allclose(got["params"][g], _model_params(res),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got["total_LL"][g], res.total_LL,
                                   rtol=1e-9)


def test_padding_invariance():
    rng = np.random.default_rng(5)
    p = em_batched.EMProblem.build(*_simulate_problem(rng, 2, 4, 20)[1])
    big = em_batched.EMProblem.build(*_simulate_problem(rng, 3, 17, 40)[1])
    one, two = _train([p]), _train([big, p])
    np.testing.assert_allclose(two["params"][1], one["params"][0],
                               rtol=1e-10, atol=1e-12)
    assert bool(two["converged"][1]) == bool(one["converged"][0])
    assert int(two["iters"][1]) == int(one["iters"][0])


def test_haploid_batch():
    raw = _simulate_problem(np.random.default_rng(7), 3, 5, 30,
                            haploid=True)[1]
    got = _train([em_batched.EMProblem.build(*raw)])
    res = _host(raw)
    np.testing.assert_allclose(got["params"][0], _model_params(res),
                               rtol=1e-8, atol=1e-10)
    assert bool(got["converged"][0]) == res.converged
    assert int(got["iters"][0]) == res.num_iterations


@pytest.mark.parametrize("period", [1, 2, 3, 4, 5, 6])
def test_log_pmf_matches_jax(period):
    """Every read-minus-allele difference in [-13, 13]: the in-frame test
    floors the modulo, the repeat count floors, the out-of-frame step
    truncates, on negative differences too."""
    diff = np.arange(-13, 14, dtype=np.float64)[None, :, None]
    per = np.full((1, 1, 1), float(period))
    want = jax_em._log_pmf(jnp, jnp.asarray(diff),
                           jax_em._param_logs(jnp, jnp.asarray(PARAMS)),
                           jnp.asarray(per))
    got = em_batched._log_pmf(
        torch.from_numpy(diff), em_batched._param_logs(
            torch.from_numpy(PARAMS)), torch.from_numpy(per))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("max_iter", [100, 5])
def test_sync_cadence_changes_nothing(max_iter, monkeypatch):
    """Frozen loci change nothing, so reading `active` on the host every
    iteration gives exactly the result of reading it every SYNC_EVERY
    (max_iter 5 also cuts loci off unconverged)."""
    problems = [em_batched.EMProblem.build(*raw) for raw in _raws()]
    assert em_batched.SYNC_EVERY > 1
    cadence = _train(problems, max_iter=max_iter)
    monkeypatch.setattr(em_batched, "SYNC_EVERY", 1)
    every = _train(problems, max_iter=max_iter)
    for k in every:
        np.testing.assert_array_equal(cadence[k], every[k], err_msg=k)


# the options of the EM runs below on the command line
EM_ARGS = ["--min-reads", "12", "--use-unpaired", "--dtype", "float64",
           "--batch-loci", "4"]


@pytest.fixture(scope="module")
def em_sim(tmp_path_factory):
    """5 loci, 3 samples x 25 reads, periods 2-4, and the VCF body of the
    JAX CLI's float64 CPU run with its host EM."""
    d = str(tmp_path_factory.mktemp("torch_em"))
    write_sim(d, [simulate_locus(seed=900 + i, n_samples=3,
                                 reads_per_sample=25, period=2 + (i % 3),
                                 ref_units=8, chrom=f"chrE{i}")
                  for i in range(5)])
    run_jax_cli(_cli_args(d, f"{d}/jax.vcf") + EM_ARGS)
    return d, _body(f"{d}/jax.vcf")


def _em_run(d, out):
    p = GenotyperPipeline([f"{d}/sim.bam"], f"{d}/sim.fa", PipelineOptions(
        min_reads=12, use_unpaired=True, dtype="float64"), Logger(quiet=True))
    counters = executor.run_batched(p, f"{d}/regions.bed", out, CPU,
                                    batch_size=4)
    return p, counters


def test_device_em_run_equals_jax_host_em(em_sim, monkeypatch):
    """The card's batched path (device EM and fused posteriors) forced on
    the CPU in float64: the JAX CLI's VCF body."""
    d, want = em_sim
    monkeypatch.setattr(executor, "device_em_enabled", lambda o, dev: True)
    monkeypatch.setattr(executor, "device_post_enabled", lambda dev: True)
    p, counters = _em_run(d, f"{d}/dev.vcf")
    assert p.last_run_stats["em_waves"] == 2      # 5 loci, waves of 4
    assert sum(p.last_run_stats["em_iter_hist"].values()) == 5
    assert counters.genotype_success == len(want) > 0
    assert counters.genotype_fail == 0
    assert _body(f"{d}/dev.vcf") == want


def test_host_em_run_equals_jax_host_em(em_sim):
    """The CPU default: each locus's host EM, no device EM wave."""
    d, want = em_sim
    p, counters = _em_run(d, f"{d}/host.vcf")
    assert p.last_run_stats["em_waves"] == 0
    assert counters.genotype_success == len(want)
    assert _body(f"{d}/host.vcf") == want
