"""Percent of the traced window in which no operation ran on the device
(one minus the union of device intervals over the window's length)."""
from perfbench import trace


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - trace.busy(rec.trace) / rec.trace.seconds)
