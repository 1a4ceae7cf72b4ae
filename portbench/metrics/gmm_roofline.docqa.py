"""The grouped matmul kernels' (``kernels/moe_gmm``) share of their roofline:
the least time of every launch in the traced window (its operations or bytes at
the H100's peak) over the device time of those kernels in the trace."""
from portbench.readers import gmm_roofline


def read(run):
    return gmm_roofline(run)
