"""The share of the traced window in which no device operation ran."""
from portbench.readers import device_idle


def read(run):
    return device_idle(run)
