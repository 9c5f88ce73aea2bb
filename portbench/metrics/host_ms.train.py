"""host_ms.train: the median host time of one train-step call made with the
card idle (the benchmark synchronises before each), in ms: the feed's
copies, the graph's replay launch and the host work around it."""

import statistics


def read(r):
    if r.kind != "train" or not r.host_s:
        return None
    return 1e3 * statistics.median(r.host_s)
