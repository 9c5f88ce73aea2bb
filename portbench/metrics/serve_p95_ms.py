"""serve_p95_ms: the 95th percentile, over every request of the window, of
the time from the request's start to its answers on the host, in ms (one
request in flight: a whole batch's service time)."""

import statistics


def read(r):
    if r.kind != "serve" or len(r.requests) < 2:
        return None
    return 1e3 * statistics.quantiles(
        [e - s for s, e in r.requests], n=20, method="inclusive")[18]
