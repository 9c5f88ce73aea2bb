"""launch_idle_pct.serve: the card's idle time inside the program's
``graphs.refresh`` (the cast-cache refresh before a replay) and
``graphs.replay`` (the graph's launch) spans over a traced stretch of
requests, as a share of the stretch's wall time, in %; not reported where
the profile lost records."""

from portbench.metrics._spans import idle_pct_in

SPANS = ("graphs.refresh", "graphs.replay")


def read(r):
    return idle_pct_in(r, SPANS) if r.kind == "serve" else None
