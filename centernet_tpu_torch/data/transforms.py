"""Image transforms, PyTorch port of ``centernet_tpu/data/transforms.py``.

Only ``normalize_coeffs`` is ported so far (a copy: the JAX package's data
package imports JAX).
"""

from __future__ import annotations

import numpy as np


def normalize_coeffs(mean, std):
    """Fused coefficients for ``(x/255 - mean)/std == x*scale + bias``."""
    std = np.asarray(std, np.float32)
    mean = np.asarray(mean, np.float32)
    return (
        (1.0 / (255.0 * std)).astype(np.float32),
        (-mean / std).astype(np.float32),
    )
