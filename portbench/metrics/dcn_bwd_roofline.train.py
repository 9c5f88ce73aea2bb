"""dcn_bwd_roofline.train: the least time of the DCN backward layers at
the cell's shapes (``counts.dcn_bwd_bound_s``) over the traced time of the
kernels whose names hold ``dcn_bwd`` (two a launch), in %."""

from portbench.metrics._device import roofline

PATTERN = "dcn_bwd"


def read(r):
    if r.kind != "train":
        return None
    return roofline(r, PATTERN, r.counts.dcn_bwd_bound_s)
