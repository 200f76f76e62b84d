"""The frozen generators write, at the original seeds, the bytes the
program's dataset writers write today; the dataset cache is keyed by seed
and reused."""

import filecmp
import functools
import os

import pytest

from strbench.traffic import generate, stutter_rich


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(f for f in os.listdir(b) if f != "truth.json")
    for f in names:
        assert filecmp.cmp(f"{a}/{f}", f"{b}/{f}", shallow=False), f


def test_stutter_rich_equals_simdata(tmp_path):
    from hipstr_tpu_torch.utils import simdata
    a, b = tmp_path / "a", tmp_path / "b"
    b.mkdir()
    simdata.write_stutter_rich(str(a), simdata.stutter_rich_loci(
        n_loci=7, n_samples=3, reads_per_sample=10, read_len=100,
        base_seed=52000, chrom_prefix="chrU"))
    job = functools.partial(stutter_rich.locus, base_seed=52000, n_samples=3,
                            reads_per_sample=10, read_len=100,
                            chrom_prefix="chrU", params={})
    generate.write_dataset(str(b), stutter_rich, map(job, range(7)))
    same_files(a, b)


@pytest.mark.parametrize("traffic", ["stutter"])
def test_dataset_is_made_from_the_seed_and_cached(tmp_path, traffic):
    import json
    from strbench import spec
    cfg = json.loads((spec.HERE / "configs" / "trio30x.json").read_text())
    cfg.update(loci=6, reads_per_sample=8)
    mix = dict(json.loads((spec.HERE / "traffic" / f"{traffic}.json")
                          .read_text()), name=traffic)
    d1, i1 = generate.dataset(str(tmp_path / "x"), cfg, mix, 2 ** 33 + 5,
                              workers=1)
    d2, i2 = generate.dataset(str(tmp_path / "y"), cfg, mix, 2 ** 33 + 5,
                              workers=2)
    d3, _ = generate.dataset(str(tmp_path / "x"), cfg, mix, 2 ** 33 + 6,
                             workers=1)
    assert not i1["cached"] and not i2["cached"]
    for f in ("sim.bam", "sim.fa", "regions.bed", "truth.json"):
        assert filecmp.cmp(f"{d1}/{f}", f"{d2}/{f}", shallow=False)
    assert not filecmp.cmp(f"{d1}/sim.bam", f"{d3}/sim.bam", shallow=False)
    again, info = generate.dataset(str(tmp_path / "x"), cfg, mix,
                                   2 ** 33 + 5, workers=1)
    assert again == d1 and info["cached"]
