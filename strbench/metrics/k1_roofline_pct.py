"""K1 (csrc/emission.cu) against its roofline in the measured window: the
bound of each captured launch (strbench/roofline/emission.py, the card's
published peaks) over the launches' device time from torch.profiler."""

from ..roofline import emission
from . import roofline_pct


def read(run):
    return roofline_pct(run, emission)
