"""The CLI modes of the JAX package's tests on the port, held to float64
anchors.

For each mode of hipstr_tpu_torch.utils.simdata.MODE_CONFIGS (the datasets
and flags of tests/test_cli_modes.py, tests/test_phasing.py and
tests/test_cram.py):
* the port's writer writes the JAX test's dataset, byte for byte;
* the anchors are current: tests/data/torch_port_mode_<name>_f64.vcf holds
  the VCF bodies of the JAX CLI's float64 runs of the mode, in run order,
  and tests/data/torch_port_modes_f64.json the sha256 and size of its other
  outputs (stutter-model files, the pass/filt BAMs and viz file
  decompressed, the page vizaln extracts);
* the port's CLI on the CPU in float64 writes them batched (--host-workers
  1), sequentially (--batch-loci 0) and, for the modes that learn their
  stutter models, on the card's batched code path (the device EM and the
  fused posteriors) forced on the CPU;
* each mode keeps its own claim: the shards' union is the unsharded run,
  the CRAM's VCF is the BAM's, the unspannable locus is skipped.
chip_smoke.py phase 12a holds the port's runs on the card to the same
anchors.  The modes are spread over test_torch_cli_modes_{a,b,c}.py, which
share the helpers here; `python tests/test_torch_cli_modes_a.py [name ...]`
rewrites anchors from the JAX package.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.parallel import executor
from hipstr_tpu_torch.utils.simdata import (CRAM_FIXTURE, MODE_CONFIGS,
                                            mode_products, mode_runs,
                                            mode_vcf_body, product_digest)

from test_torch_golden_a import card_em_rule
from test_torch_slice import (ROOT, _body, one_torch_thread,  # noqa: F401
                              run_jax_cli)

DATA = os.path.join(ROOT, "tests", "data")
PRODUCTS = os.path.join(DATA, "torch_port_modes_f64.json")
RUN_MODES = {"batched": ["--host-workers", "1"],
             "sequential": ["--batch-loci", "0"],
             "card_path": ["--host-workers", "1"]}
# the modes whose runs learn stutter models (no --def-stutter-model or
# --stutter-in in a run): on the card the device EM learns them
LEARNING = ("stutter_roundtrip", "skip_genotyping")


def anchor_path(name: str) -> str:
    return os.path.join(DATA, f"torch_port_mode_{name}_f64.vcf")


def anchor_body(name: str):
    """The anchor's VCF bodies ([] for a mode that writes no VCF)."""
    writes_vcf = any("--skip-genotyping" not in flags
                     for _, flags in MODE_CONFIGS[name].runs)
    return _body(anchor_path(name)) if writes_vcf else []


def cases(names):
    """(name, run mode) pairs: batched and sequential for every mode, the
    card's path for the modes that learn their models."""
    return [(n, m) for n in names for m in RUN_MODES
            if m != "card_path" or n in LEARNING]


# ---------------------------------------------------------------- writers
_SIM1 = dict(n_samples=3, reads_per_sample=30, period=3, ref_units=8)
# the simulate_locus arguments of each JAX test that writes its dataset
# with tests/test_cli_modes.py::_write_inputs
JAX_LOCI = {
    "haploid": dict(_SIM1, seed=123, haploid=True),
    "stutter_roundtrip": dict(_SIM1, seed=207, n_samples=4),
    "skip_genotyping": dict(_SIM1, seed=5),
    "sample_list": dict(_SIM1, seed=19, n_samples=4),
    "viz": dict(_SIM1, seed=311),
    "unspannable": dict(seed=5011, n_samples=3, reads_per_sample=25,
                        period=6, ref_units=12, read_len=70),
    "ref_vcf": dict(_SIM1, seed=91),
}


def write_norg(out: str) -> None:
    """tests/test_cli_modes.py::test_bam_samps_without_read_groups's own
    dataset (written inline there)."""
    from hipstr_tpu.io.bam import BamRecord, BamWriter
    from hipstr_tpu.io.fasta import write_fasta
    from hipstr_tpu.utils.simulate import simulate_locus
    locus = simulate_locus(seed=99, n_samples=1, reads_per_sample=30,
                           period=3, ref_units=8)
    write_fasta(f"{out}/sim.fa", [(locus.chrom, locus.chrom_seq)])
    r = locus.region
    with open(f"{out}/regions.bed", "w") as fh:
        fh.write(f"{r.chrom}\t{r.start + 1}\t{r.stop}\t{r.period}\t8.0\tX\n")
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           f"@SQ\tSN:{locus.chrom}\tLN:{len(locus.chrom_seq)}\n")
    w = BamWriter(f"{out}/norg.bam", [locus.chrom], [len(locus.chrom_seq)],
                  hdr)
    for rd in sorted(locus.raw_reads, key=lambda d: d["start"]):
        w.write(BamRecord(name=rd["name"], flag=0x10 if rd["rev"] else 0,
                          ref_id=0, pos=rd["start"], mapq=60,
                          cigar=[(len(rd["seq"]), "M")], mate_ref_id=-1,
                          mate_pos=-1, tlen=0, seq=rd["seq"],
                          qual=rd["quals"], tags={}))
    w.close()


def write_jax_dataset(name: str, out: str) -> None:
    """The dataset the JAX test of mode `name` genotypes."""
    if name in JAX_LOCI:
        from hipstr_tpu.utils.simulate import simulate_locus
        from test_cli_modes import _write_inputs
        _write_inputs(simulate_locus(**JAX_LOCI[name]), out)
    elif name == "bam_samps":
        write_norg(out)
    elif name == "locus_shard":
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "make_golden_data.py"),
                        out, "--loci", "4", "--samples", "2", "--reads",
                        "30"], check=True, capture_output=True, timeout=300)
    else:
        assert name == "cram"      # the JAX test reads the fixture itself
        for f in CRAM_FIXTURE:
            shutil.copyfile(os.path.join(DATA, f), os.path.join(out, f))


def check_writer(name: str, tmp) -> None:
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    write_jax_dataset(name, str(jax_dir))
    MODE_CONFIGS[name].write(str(port_dir))
    names = sorted(os.listdir(jax_dir))
    if name == "cram":
        # the port adds the BED over the fixture's TTG x 8 repeat
        assert sorted(os.listdir(port_dir)) == sorted(names + ["regions.bed"])
        from hipstr_tpu_torch.io.fasta import FastaReader
        seq = FastaReader(str(port_dir / "cram_fix.fa")).get_sequence("chrT")
        chrom, start, stop = open(port_dir / "regions.bed").read().split(
            "\t")[:3]
        assert (chrom, seq[int(start) - 1:int(stop)]) == ("chrT", "TTG" * 8)
    else:
        assert sorted(os.listdir(port_dir)) == names
    assert any(n.endswith(".bam") for n in names)
    for f in names:
        assert filecmp.cmp(jax_dir / f, port_dir / f, shallow=False), f


# ---------------------------------------------------------------- outputs
def want_products(name: str) -> dict:
    with open(PRODUCTS) as fh:
        return json.load(fh)[name]


def got_products(name: str, d: str, o: str) -> dict:
    return {k: product_digest(k, v)
            for k, v in mode_products(name, d, o).items()}


def check_claims(name: str, o: str) -> None:
    """The JAX test's own claim about its mode's outputs."""
    def body(label):
        return _body(f"{o}/{label}.vcf")
    if name == "locus_shard":
        assert body("shard0") and body("shard1")
        assert sorted(body("shard0") + body("shard1")) == sorted(body("all"))
    elif name == "cram":
        assert body("cram") and body("cram") == body("bam")
    elif name == "unspannable":
        assert body("out") == []
    elif name == "stutter_roundtrip":
        def gts(label):
            return [f.split(":")[0] for f in body(label)[0].split("\t")[9:]]
        assert gts("pass1") == gts("pass2")


def check_outputs(name: str, d: str, o: str) -> None:
    assert mode_vcf_body(name, o) == anchor_body(name)
    assert got_products(name, d, o) == want_products(name)
    check_claims(name, o)


def run_jax_mode(name: str, d: str, o: str) -> None:
    """The JAX CLI's float64 runs of mode `name`: at once when no run reads
    or writes anything in `o` but its VCF, else in order."""
    os.makedirs(o, exist_ok=True)
    runs = [args + ["--dtype", "float64"]
            for _, args in mode_runs(name, d, o)]
    apart = not any("{o}" in f for _, flags in MODE_CONFIGS[name].runs
                    for f in flags)
    with ThreadPoolExecutor(len(runs) if apart else 1) as pool:
        list(pool.map(run_jax_cli, runs))


def check_anchor(name: str, d: str) -> None:
    o = f"{d}/jax"
    run_jax_mode(name, d, o)
    check_outputs(name, d, o)


def check_port(name: str, d: str, mode: str, monkeypatch) -> None:
    if mode == "card_path":
        monkeypatch.setattr(executor, "device_em_enabled", card_em_rule)
        monkeypatch.setattr(executor, "device_post_enabled",
                            lambda device: True)
    o = f"{d}/{mode}"
    os.makedirs(o)
    for _, args in mode_runs(name, d, o):
        pipeline, counters = cli.run(args + ["--dtype", "float64", "--device",
                                             "cpu"] + RUN_MODES[mode])
        assert counters.genotype_fail == 0
        learns = not {"--def-stutter-model", "--stutter-in"} & set(args)
        if mode == "card_path" and learns:
            assert pipeline.last_run_stats["em_waves"] > 0
        if name == "unspannable":      # skipped: no read spans the repeat
            assert (counters.genotype_success, counters.too_few_reads) == \
                (0, 1)
    check_outputs(name, o=o, d=d)


def mode_datasets(tmp_path_factory):
    """name -> the port writer's dataset dir, made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            d = str(tmp_path_factory.mktemp(f"mode_{name}"))
            MODE_CONFIGS[name].write(d)
            cache[name] = d
        return cache[name]
    return get


NAMES = ["haploid", "stutter_roundtrip", "skip_genotyping", "sample_list",
         "unspannable"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    return mode_datasets(tmp_path_factory)


def test_the_modes_are_spread_over_the_files():
    from test_torch_cli_modes_b import NAMES as B
    from test_torch_cli_modes_c import NAMES as C
    assert sorted(NAMES + B + C) == sorted(MODE_CONFIGS)
    with open(PRODUCTS) as fh:
        assert sorted(json.load(fh)) == sorted(MODE_CONFIGS)


@pytest.mark.parametrize("name", NAMES)
def test_mode_writer_equals_the_jax_test(name, tmp_path):
    check_writer(name, tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_mode_anchor_is_current(datasets, name):
    check_anchor(name, datasets(name))


@pytest.mark.parametrize("name,mode", cases(NAMES))
def test_port_writes_the_mode_anchor(datasets, name, mode, monkeypatch):
    check_port(name, datasets(name), mode, monkeypatch)


def write_anchors(names) -> None:
    """Rewrite the anchors of `names` from the JAX CLI's float64 runs."""
    products = {}
    if os.path.exists(PRODUCTS):
        with open(PRODUCTS) as fh:
            products = json.load(fh)
    for name in names:
        with tempfile.TemporaryDirectory() as d:
            MODE_CONFIGS[name].write(d)
            run_jax_mode(name, d, f"{d}/jax")
            if any("--skip-genotyping" not in flags
                   for _, flags in MODE_CONFIGS[name].runs):
                with open(anchor_path(name), "w") as fh:
                    fh.writelines(mode_vcf_body(name, f"{d}/jax"))
            products[name] = got_products(name, d, f"{d}/jax")
    with open(PRODUCTS, "w") as fh:
        json.dump(dict(sorted(products.items())), fh, indent=1,
                  sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    write_anchors(sys.argv[1:] or list(MODE_CONFIGS))
