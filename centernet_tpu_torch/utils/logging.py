"""Metrics logging, PyTorch port of ``centernet_tpu/utils/logging.py``
(reference: TensorBoardLogger + self.log, centernet_detection.py:393,
centernet.py:75-90).

Writes a JSONL event stream, ``<log_dir>/metrics.jsonl``: one record per
logged step or epoch, each with its wall-clock ``time``. Scalar-only,
append-only, host-side. Unlike the JAX package's logger it writes no
TensorBoard summaries: ``torch.utils.tensorboard`` needs the ``tensorboard``
package, which the card's machine does not have and which, where it is
installed, imports TensorFlow and JAX into the process.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_step(self, step: int, metrics: Mapping[str, float]) -> None:
        self._write({"step": step, **metrics})

    def log_epoch(self, epoch: int, metrics: Mapping[str, float]) -> None:
        self._write({"epoch": epoch, **metrics})

    def _write(self, record: Dict) -> None:
        if self._jsonl is not None:
            record = {"time": time.time(), **record}
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
