"""Host-side face alignment (numpy and cv2).

Counterpart of ``lip2speech_tpu/data/face_align.py:21-53``: the eye line
from the integer bounding-rect midpoints of the 68-point landmarks' eyes,
then a rotation of the face crop about its centre that makes it horizontal.
"""

from __future__ import annotations

import cv2
import numpy as np

EYE1 = slice(36, 42)
EYE2 = slice(42, 48)


def eye_angle_degrees(landmarks) -> float:
    """Angle of the eye line in degrees, from the integer midpoints of each
    eye's bounding rectangle; 0 when the midpoints share a column."""
    lm = np.asarray(landmarks)

    def mid(roi):
        x, y = roi[:, 0], roi[:, 1]
        x0, y0 = int(x.min()), int(y.min())
        w, h = int(x.max()) - x0 + 1, int(y.max()) - y0 + 1
        return x0 + w // 2, y0 + h // 2

    lx, ly = mid(lm[EYE1])
    rx, ry = mid(lm[EYE2])
    dx, dy = rx - lx, ry - ly
    if dx == 0:
        return 0.0
    return float(np.degrees(np.arctan(dy / dx)))


def align_and_crop_face(frame: np.ndarray, face_coords, landmarks) -> np.ndarray:
    """frame (H, W, 3) uint8, face_coords (x1, y1, x2, y2) -> the crop,
    rotated about ``(w // 2, h // 2)`` so the eye line is horizontal. An
    empty crop comes back as it is."""
    x1, y1, x2, y2 = [max(int(v), 0) for v in face_coords]
    crop = frame[y1:y2, x1:x2]
    if crop.size == 0:
        return crop
    h, w = crop.shape[:2]
    m = cv2.getRotationMatrix2D((w // 2, h // 2), eye_angle_degrees(landmarks), 1.0)
    return cv2.warpAffine(crop, m, (w, h))
