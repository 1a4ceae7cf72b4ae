"""Output tokens the clients received inside the window, over the window's
seconds (host clock)."""
from portbench.stats import tokens_in


def read(run):
    return tokens_in(run.records, run.t_open, run.t_close) / run.window_s
