"""mfu.serve: the whole forward's share of the chip's bf16 peak at the
window's served images per second (the benchmark's operation count)."""

from portbench.metrics._device import mfu


def read(r):
    return mfu(r, 1) if r.kind == "serve" else None
