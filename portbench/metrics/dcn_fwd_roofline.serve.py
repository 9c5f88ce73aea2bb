"""dcn_fwd_roofline.serve: the least time of the DCN forward layers at the
cell's shapes (``counts.dcn_fwd_bound_s``) over the traced time of the
kernels whose names hold ``dcn_fwd``, in %."""

from portbench.metrics._device import roofline

PATTERN = "dcn_fwd"


def read(r):
    if r.kind != "serve":
        return None
    return roofline(r, PATTERN, r.counts.dcn_fwd_bound_s)
