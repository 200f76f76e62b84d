"""The pool's workers' native ML traces ("ML traces", the seconds of
their trace batches on either of a worker's threads, handed over beside
their timers), summed over the workers, per locus of the whole traced run.
None where the workers do not hand the span over."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "ML traces (workers)")
