"""The paper's gateway latency (t2 - t0) + (t5 - t3), median over the
requests whose first token reached the client in the window (the
program's Figure-4 stamps joined with the client's)."""
from portbench.readers import gateway_ms


def read(run):
    return gateway_ms(run)
