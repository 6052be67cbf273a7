"""Percent: B3's (decode attention) least time over its traced time (its
split-merge launches included) in the window's decodes, one launch a
layer over every slot's valid cache entries."""
from perfbench import roofline


def read(rec):
    m = rec.model
    return rec.roofline_share(
        "decode", "b3", m["n_layers"],
        lambda i, it: m["n_layers"] * roofline.least(
            *roofline.b3_launch(m, rec.decode_keys(i))))
