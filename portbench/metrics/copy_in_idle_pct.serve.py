"""copy_in_idle_pct.serve: the card's idle time inside the program's
``graphs.copy_in`` spans (the copies of a request's uint8 batch into the
serving graph's buffers: the pageable upload) over a traced stretch of
requests, as a share of the stretch's wall time, in %; not reported where
the profile lost records."""

from portbench.metrics._spans import idle_pct_in

SPANS = ("graphs.copy_in",)


def read(r):
    return idle_pct_in(r, SPANS) if r.kind == "serve" else None
