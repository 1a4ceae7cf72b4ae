"""90th percentile of client submit -> first token received, over every
request of the document-QA traffic submitted in the window; one still waiting at the
close counts with the time it waited, a failed one beyond every tail (host
clock). A per-layer metric: from run to run it spreads wider than a bound
can hold (PERF.md)."""
from portbench.readers import ttft_ms


def read(run):
    return ttft_ms(run)
