"""Percent: B2's (flash attention) least time over its traced time in the
window's prefills, one launch a layer over the padded bucket."""
from perfbench import roofline


def read(rec):
    m = rec.model
    return rec.roofline_share(
        "prefill", "b2", m["n_layers"],
        lambda i, it: m["n_layers"] * roofline.least(
            *roofline.b2_launch(m, it.bucket)))
