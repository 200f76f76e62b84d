"""The batched stutter EM on the card ("Stutter estimation (device)", the
parent's waves) per locus of the whole traced run."""

from . import per_locus_ms


def read(run):
    return per_locus_ms(run, "Stutter estimation (device)")
