"""Input normalisation of mouth frames and face crops (PyTorch).

Counterpart of ``normalize_mouth`` and ``normalize_face`` in
``lip2speech_tpu/ops/image.py:27-36``.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_mouth(img: torch.Tensor) -> torch.Tensor:
    """uint8-range mouth frames (..., H, W, 3) -> ImageNet-normalised f32."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img.float() / 255.0 - mean) / std


def normalize_face(img: torch.Tensor) -> torch.Tensor:
    """facenet normalisation (x - 127.5) / 128."""
    return (img.float() - 127.5) / 128.0
