"""Percent: the least time of the window's prefills at the chip's peaks
(``roofline.prefill_step`` of each prompt's own tokens) over their engine
time (``iteration_log`` dt)."""
from perfbench import roofline


def read(rec):
    least = spent = 0.0
    for _, it in rec.window_steps("prefill"):
        least += roofline.least(*roofline.prefill_step(rec.model,
                                                       it.prompt_len))
        spent += it.dt
    return 100.0 * least / spent if spent > 0 else None
