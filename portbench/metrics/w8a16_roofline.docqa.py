"""The w8a16 kernels' (``kernels/quant_matmul``) share of their roofline, as
gmm_roofline's."""
from portbench.readers import w8a16_roofline


def read(run):
    return w8a16_roofline(run)
