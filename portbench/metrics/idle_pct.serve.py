"""idle_pct.serve: the device's idle share over a traced stretch of
requests, 100 x (1 - union of the kernels' intervals / the stretch's wall
time), both from the same stretch; not reported where the profile holds
fewer DCN kernels than the program launched."""

from portbench.metrics._device import idle_pct


def read(r):
    return idle_pct(r) if r.kind == "serve" else None
