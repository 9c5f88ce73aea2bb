"""hg_pre_ms.serve: the device time of the hourglass serving graph's
``backbone/pre`` span (the 7x7 stride-2 conv and the stride-2 residual),
from the program's readings of its replays under the traced stretch: the
median ms a replay."""

from portbench.metrics._spans import device_ms

KEY = "serve/backbone/pre"


def read(r):
    return device_ms(r, KEY) if r.kind == "serve" else None
