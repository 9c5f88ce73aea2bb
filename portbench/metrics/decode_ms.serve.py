"""decode_ms.serve: the device time of the serving graph's ``decode`` span
(the decode), from the program's readings of its replays under the traced
stretch: the median ms a replay."""

from portbench.metrics._spans import device_ms

KEY = "serve/decode"


def read(r):
    return device_ms(r, KEY) if r.kind == "serve" else None
