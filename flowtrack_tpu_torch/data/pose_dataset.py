"""Image loading of the data pipeline.

Port of ``flowtrack_tpu/data/pose_dataset.py::load_image`` (pose_dataset.py
:42), the port's own copy: the video reader's default loader. The datasets
and their augmentation are not ported yet.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3). cv2 if available, PIL otherwise; cv2 is
    imported here, not when the module is."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
