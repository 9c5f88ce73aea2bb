"""copy_in_idle_pct.train: copy_in_idle_pct.serve's measure over a traced
stretch of training steps (the copies of a step's batch and annotations
into the train graph's buffers); not reported where the profile lost
records."""

from portbench.metrics._spans import idle_pct_in

SPANS = ("graphs.copy_in",)


def read(r):
    return idle_pct_in(r, SPANS) if r.kind == "train" else None
