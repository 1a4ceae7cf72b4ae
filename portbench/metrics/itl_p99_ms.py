"""99th percentile of the gaps between consecutive tokens of a request as
its client received them, over every gap that ends in the window and the
open gap of each request still streaming at its close (host clock)."""
from portbench.stats import gaps, percentile


def read(run):
    p = percentile(gaps(run.records, run.t_open, run.t_close), 99)
    return None if p is None else 1e3 * p
