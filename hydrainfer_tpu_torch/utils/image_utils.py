"""Image helpers (port of hydrainfer_tpu/utils/image_utils.py)."""
import numpy as np
from PIL import Image


def make_random_image(height: int, width: int, n_channel: int = 3,
                      seed: int = 0) -> Image.Image:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (height, width, n_channel), dtype=np.uint8)
    return Image.fromarray(arr.squeeze() if n_channel == 1 else arr)
