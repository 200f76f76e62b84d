"""Host prep in the pool's workers: read filtering, SNP phasing and left
alignment, summed over the workers, per locus of the whole traced run (the
workers report their timers only at the run's end)."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "Read filtering (workers)",
                        "SNP info extraction (workers)",
                        "Left alignment (workers)")
