"""neck_ms.serve: the device time of the serving graph's ``neck`` span
(``dla_up`` and ``ida_up``: the 16 DCN forwards and the depthwise transpose
convolutions), from the program's readings of its replays under the traced
stretch: the median ms a replay."""

from portbench.metrics._spans import device_ms

KEY = "serve/neck"


def read(r):
    return device_ms(r, KEY) if r.kind == "serve" else None
