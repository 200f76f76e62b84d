"""The adaptive rounds in the workers ("Genotyping (adaptive)": installing
each round's posteriors, the host's own posteriors of unfused rounds, the
next round's decision), summed over the workers, per locus of the whole
traced run."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "Genotyping (adaptive) (workers)")
