"""Chunked paged attention's (``kernels/paged_attention``) share of its
roofline, counting only the keys each query can see."""
from portbench.readers import attn_roofline


def read(run):
    return attn_roofline(run)
