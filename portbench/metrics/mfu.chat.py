"""The whole model call's share of the chip's peak: each model call's
operations at the bf16 peak or its bytes at the HBM bandwidth, whichever is
longer, summed over the window, over the window's seconds."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
