"""serve_img_per_s: images whose detections reached the host inside the
window, over the window's seconds."""

from portbench.metrics._device import rate


def read(r):
    return rate(r) if r.kind == "serve" else None
