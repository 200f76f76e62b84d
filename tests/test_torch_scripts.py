"""The port's copies of the last host entry points against the JAX
package's, on the outputs of a port run.

The port's CLI genotypes three simulated loci (periods 2-4, a trio at 25
reads each, each locus's stutter model learned) in float64 on the CPU with
--viz-out; then on that VCF and viz file:
* pipeline/pdf.py (vizaln-pdf): `html_to_pdf` writes the JAX function's
  bytes for every locus's page (after tests/test_viz_pdf.py), and `python
  -m hipstr_tpu_torch.pipeline.pdf` writes them to a file;
* scripts/filter_vcf.py: the JAX script's output under each filter;
* scripts/get_stutter_models.py: the JAX script's models file, which reads
  back as the run's own --stutter-out.
"""

import gzip
import os
import subprocess
import sys

import pytest

from hipstr_tpu_torch import cli
from hipstr_tpu_torch.io.regions import read_regions
from hipstr_tpu_torch.models.stutter import read_stutter_models
from hipstr_tpu_torch.pipeline import pdf, viz
from hipstr_tpu_torch.scripts import filter_vcf, get_stutter_models
from hipstr_tpu_torch.utils.simdata import write_sim
from hipstr_tpu_torch.utils.simulate import simulate_locus

from test_torch_slice import (ONE_THREAD, ROOT, _cli_args,  # noqa: F401
                              one_torch_thread)


LOCI = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The dataset dir, holding the port run's str.vcf, viz.gz and
    models.txt."""
    d = str(tmp_path_factory.mktemp("scripts"))
    write_sim(d, [simulate_locus(seed=900 + i, n_samples=3,
                                 reads_per_sample=25, period=2 + i,
                                 ref_units=8, chrom=f"chrB{i}")
                  for i in range(LOCI)])
    cli.run(_cli_args(d, f"{d}/str.vcf") + [
        "--min-reads", "20", "--use-unpaired", "--dtype", "float64",
        "--device", "cpu", "--host-workers", "1", "--viz-out",
        f"{d}/viz.gz", "--stutter-out", f"{d}/models.txt"])
    return d


def pages(d):
    """(chrom, 1-based start, vizaln's page) of every locus."""
    return [(r.chrom, r.start + 1,
             viz.extract_locus_html(f"{d}/viz.gz", r.chrom, r.start + 1))
            for r in read_regions(f"{d}/regions.bed")]


@pytest.mark.parametrize("font_size", [8.0, 6.5])
def test_html_to_pdf_equals_jax(run, font_size):
    from hipstr_tpu.pipeline import pdf as jax_pdf
    from hipstr_tpu.pipeline import viz as jax_viz
    found = pages(run)
    assert len(found) == LOCI
    for chrom, start, page in found:
        assert page and page == jax_viz.extract_locus_html(
            f"{run}/viz.gz", chrom, start)
        got = pdf.html_to_pdf(page, font_size)
        assert got.startswith(b"%PDF-1.4") and got.endswith(b"%%EOF\n")
        assert got == jax_pdf.html_to_pdf(page, font_size)


def port_module(module, args):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_vizaln_pdf_entry_point(run, tmp_path):
    from hipstr_tpu.pipeline import pdf as jax_pdf
    chrom, start, page = pages(run)[1]
    out = tmp_path / "locus.pdf"
    proc = port_module("hipstr_tpu_torch.pipeline.pdf",
                       [f"{run}/viz.gz", chrom, str(start), str(out)])
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == jax_pdf.html_to_pdf(page)
    proc = port_module("hipstr_tpu_torch.pipeline.pdf",
                       [f"{run}/viz.gz", chrom, "1", str(out)])
    assert proc.returncode == 1 and "not found" in proc.stderr


def read_text(path: str) -> str:
    if path.endswith(".gz"):
        return gzip.decompress(open(path, "rb").read()).decode()
    return open(path).read()


@pytest.mark.parametrize("flags", [
    [],
    ["--min-call-depth", "14", "--min-call-qual", "0.9"],
    ["--min-call-allele-depth", "5", "--min-call-allele-ratio", "0.5",
     "--min-loc-calls", "2"],
    ["--max-call-flank-indel", "0.05", "--max-call-stutter", "0.1",
     "--min-loc-depth", "40", "--max-loc-depth", "80"],
    ["--min-call-allele-bias", "-2", "--min-call-strand-bias", "-2",
     "--min-call-spanning-depth", "3"],
    ["--haploid", "--min-call-depth", "10"]],
    ids=["none", "depth-qual", "allele", "fractions-locus-depth",
         "bias-spanning", "haploid"])
@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_filter_vcf_equals_jax(run, tmp_path, flags, suffix):
    from hipstr_tpu.scripts import filter_vcf as jax_filter_vcf
    got, want = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    assert filter_vcf.main(["--vcf", f"{run}/str.vcf", "--out", got]
                           + flags) == 0
    assert jax_filter_vcf.main(["--vcf", f"{run}/str.vcf", "--out", want]
                               + flags) == 0
    assert read_text(got) == read_text(want)
    assert [l for l in read_text(got).splitlines() if l[0] != "#"]


def test_filter_vcf_blanks_calls(run, tmp_path):
    """A filter that some calls fail blanks them and counts them in
    NFILT, through the entry point."""
    out = tmp_path / "f.vcf"
    proc = port_module("hipstr_tpu_torch.scripts.filter_vcf",
                       ["--vcf", f"{run}/str.vcf", "--out", str(out),
                        "--min-call-depth", "14"])
    assert proc.returncode == 0, proc.stderr
    body = [l.split("\t") for l in out.read_text().splitlines()
            if not l.startswith("#")]
    blanked = sum(s == "." for rec in body for s in rec[9:])
    nfilt = sum(int(kv.split("=")[1]) for rec in body
                for kv in rec[7].split(";") if kv.startswith("NFILT="))
    assert 0 < blanked == nfilt < 3 * len(body)


def test_get_stutter_models_equals_jax(run, tmp_path):
    from hipstr_tpu.scripts import get_stutter_models as jax_get
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert get_stutter_models.main(["--vcf", f"{run}/str.vcf", "--out",
                                    str(got)]) == 0
    assert jax_get.main(["--vcf", f"{run}/str.vcf", "--out", str(want)]) == 0
    assert got.read_text() == want.read_text()
    with open(got) as fh:
        models = read_stutter_models(fh)
    with open(f"{run}/models.txt") as fh:
        learned = read_stutter_models(fh)
    assert len(models) == LOCI and models.keys() == learned.keys()
    proc = port_module("hipstr_tpu_torch.scripts.get_stutter_models",
                       ["--vcf", f"{run}/str.vcf"])
    assert proc.returncode == 0 and proc.stdout == got.read_text()
