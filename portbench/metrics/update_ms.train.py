"""update_ms.train: the device time of the train step graph's ``update`` span
(the clip and the fused Adam update), from the program's readings of its
replays under the traced stretch: the median ms a replay."""

from portbench.metrics._spans import device_ms

KEY = "train/update"


def read(r):
    return device_ms(r, KEY) if r.kind == "train" else None
