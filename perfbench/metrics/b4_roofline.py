"""Percent: B4b + B4a's (the grouped expert kernels) least time over their
traced time in the window's decodes, one of each an MoE layer over every
slot's tokens; nothing for a model without experts."""
from perfbench import roofline


def read(rec):
    m = rec.model
    if m["family"] != "moe":
        return None
    slots = rec.serve["slots"]
    return rec.roofline_share(
        "decode", "b4", 2 * m["n_layers"],
        lambda i, it: m["n_layers"] * roofline.least(
            *roofline.b4_layer(m, slots)))
