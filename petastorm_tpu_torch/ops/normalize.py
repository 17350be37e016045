"""Image normalisation: uint8 NHWC batches to scaled bfloat16 or float32.

Counterpart of ``petastorm_tpu/ops/normalize.py`` ``normalize_images``
(:26-56). The classic first op of a vision input pipeline, run on the card
right after staging, so the host-to-device copy moves uint8 at 1 byte per
pixel. A CUDA tensor launches kernel K4 (``csrc/normalize.cu``); a CPU
tensor runs its plain twin (:func:`petastorm_tpu_torch.ops.kernels.
normalize_plain`).
"""

from __future__ import annotations

import torch

from petastorm_tpu_torch.ops import kernels

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``((images / 255) - mean) / std`` per channel, as ``dtype``, for a
    uint8 batch ``(N, H, W, C)``. The scale is ``x * (1/255)`` and the
    division by ``std`` is a multiplication by ``1 / std`` taken on float32
    values, as the JAX reference computes them."""
    mean_t = torch.tensor(mean, dtype=torch.float32)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32)
    return kernels.normalize(images, mean_t, inv_std, dtype)
