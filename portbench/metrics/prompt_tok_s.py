"""Prompt tokens of every request whose first token reached its client
inside the window, over the window's seconds (host clock)."""


def read(run):
    n = sum(r.prompt_len for r in run.records
            if r.times and run.t_open <= r.times[0] <= run.t_close)
    return n / run.window_s
