"""t2 - t1, the wait between the gateway and the engine's admission (the
scheduler and the KV allocator), 90th percentile over the window's
requests."""
from portbench.readers import queue_wait_ms


def read(run):
    return queue_wait_ms(run)
