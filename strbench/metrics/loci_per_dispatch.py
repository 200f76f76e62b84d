"""Loci a batched dispatch carries: locus-rounds dispatched over the
executor's dispatches (chunks), whole traced run."""


def read(run):
    n = run["stats"].get("dispatches", 0)
    return run["locus_rounds"] / n if n else None
