"""hg_stacks_ms.serve: the device time of the hourglass serving graph's
stacks, the sum over the configuration's ``num_stacks`` of the median ms a
replay of its ``backbone/stack{i}`` span (a stack's hourglass and 3x3
conv; the merges between stacks are left out). None where any stack's
span has no reading."""

from portbench.metrics._spans import device_ms


def read(r):
    if r.kind != "serve":
        return None
    total = 0.0
    for i in range(r.config.get("num_stacks", 1)):
        ms = device_ms(r, f"serve/backbone/stack{i}")
        if ms is None:
            return None
        total += ms
    return total
