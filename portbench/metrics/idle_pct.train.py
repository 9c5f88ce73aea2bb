"""idle_pct.train: idle_pct.serve's measure over a traced stretch of
training steps."""

from portbench.metrics._device import idle_pct


def read(r):
    return idle_pct(r) if r.kind == "train" else None
