"""Percent: the least time of the window's decodes at the chip's peaks
(``roofline.decode_step`` of the running rows and the cache entries each
reads) over their engine time (``iteration_log`` dt)."""
from perfbench import roofline


def read(rec):
    least = spent = 0.0
    for i, it in rec.window_steps("decode"):
        keys = rec.decode_keys(i, active_only=True)
        least += roofline.least(*roofline.decode_step(rec.model, keys))
        spent += it.dt
    return 100.0 * least / spent if spent > 0 else None
