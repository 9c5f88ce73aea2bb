"""mfu.train: the whole step's share of the chip's bf16 peak at the
window's training images per second, counting three forwards a step."""

from portbench.metrics._device import mfu


def read(r):
    return mfu(r, r.counts.TRAIN_FACTOR) if r.kind == "train" else None
