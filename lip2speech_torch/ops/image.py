"""Batched image ops and face-alignment math (PyTorch).

Counterpart of ``lip2speech_tpu/ops/image.py``: the input normalisation of
mouth frames and face crops (``:27-36``), the horizontal flips (``:39-50``)
and the eye-line alignment (``:53-116``) as batched tensor ops, so the
transforms can run on the device. A flip's draw comes from a
``torch.Generator`` or is handed in (``flips``), so a test can give both
packages the same draw.
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


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Horizontal flip over the width axis of (..., H, W, C)."""
    return img.flip(-2)


def batched_random_hflip(generator: torch.Generator | None, video: torch.Tensor,
                         p: float = 0.5, flips: torch.Tensor | None = None) -> torch.Tensor:
    """Each clip of (B, T, H, W, C) videos flipped horizontally with
    probability ``p`` (``FaceAugmentation`` on the device, on the whole
    frame list of a clip): the clips whose U[0, 1) draw from ``generator``
    is below ``p``, or those ``flips`` (B,) bool marks."""
    if flips is None:
        flips = torch.rand(video.shape[0], generator=generator, device=video.device) < p
    return torch.where(flips.to(video.device).view(-1, 1, 1, 1, 1), hflip(video), video)


def eye_alignment_angle(landmarks: torch.Tensor) -> torch.Tensor:
    """The angle (radians) that levels the eye line, from 68-point
    landmarks (..., 68, 2): each eye's bounding-rect midpoint, in integers
    as ``cv2.boundingRect`` gives it (``x + w // 2``, ``w = hi - lo + 1``)
    for integer landmarks, ``(lo + hi) / 2`` for float ones."""

    def mid(roi):
        lo, hi = roi.amin(-2), roi.amax(-2)
        if roi.is_floating_point():
            return (lo + hi) / 2.0
        return lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")

    d = mid(landmarks[..., 42:48, :]) - mid(landmarks[..., 36:42, :])
    if not d.is_floating_point():
        d = d.float()
    return torch.atan2(d[..., 1], d[..., 0])


def rotate_image(img: torch.Tensor, angle) -> torch.Tensor:
    """(..., H, W, C) images each rotated by its ``angle`` (radians; one per
    image, or one for all) about the center ``(W // 2, H // 2)`` with
    bilinear sampling and zeros outside, as ``cv2.getRotationMatrix2D`` +
    ``warpAffine``; f32, one batched gather for every image."""
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).float()
    n = x.shape[0]
    a = torch.as_tensor(angle, dtype=torch.float32, device=img.device).reshape(-1).expand(n)
    yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device), indexing="ij")
    x0, y0 = (xx - w // 2).float(), (yy - h // 2).float()
    cos, sin = torch.cos(a).view(-1, 1, 1), torch.sin(a).view(-1, 1, 1)
    # inverse mapping: the output pixel (x, y) samples the source rotated by -angle
    sx = cos * x0 - sin * y0 + w // 2
    sy = sin * x0 + cos * y0 + h // 2
    x1 = torch.clamp(torch.floor(sx).long(), 0, w - 1)
    y1 = torch.clamp(torch.floor(sy).long(), 0, h - 1)
    x2, y2 = torch.clamp(x1 + 1, max=w - 1), torch.clamp(y1 + 1, max=h - 1)
    fx = torch.clamp(sx - x1, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y1, 0.0, 1.0)[..., None]
    b = torch.arange(n, device=img.device).view(-1, 1, 1)
    out = (x[b, y1, x1] * (1 - fx) * (1 - fy) + x[b, y1, x2] * fx * (1 - fy)
           + x[b, y2, x1] * (1 - fx) * fy + x[b, y2, x2] * fx * fy)
    inside = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    return torch.where(inside, out, 0.0).reshape(img.shape[:-3] + (h, w, c))


def align_face_batched(crops: torch.Tensor, landmarks: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) face crops + (B, 68, 2) landmarks -> the crops with their
    eye lines levelled (the on-device form of the per-frame host alignment,
    ``data/face_align.py``)."""
    return rotate_image(crops, eye_alignment_angle(landmarks.float()))
