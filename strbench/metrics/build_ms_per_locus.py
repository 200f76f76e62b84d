"""The genotyper's construction in the workers ("Genotyper build": the
haplotypes and candidate alleles, genotype_prepare), summed over the
workers, per locus of the whole traced run."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "Genotyper build (workers)")
