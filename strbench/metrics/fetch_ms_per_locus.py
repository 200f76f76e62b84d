"""The batched executor's device-to-host fetches ("Device fetch", summed
over the parent's fetch threads) per locus of the whole traced run."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "Device fetch")
