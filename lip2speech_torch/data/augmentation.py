"""Host-side clip augmentation.

Counterpart of ``lip2speech_tpu/data/augmentation.py``: a p=0.5 horizontal
flip applied to every frame of a clip and to its face frames alike.
"""

from __future__ import annotations

import numpy as np

from lip2speech_torch.data.rng import LockedRng


class FaceAugmentation:
    def __init__(self, p_flip: float = 0.5, rng: np.random.Generator | None = None):
        self.p_flip = p_flip
        self.rng = LockedRng(rng)  # Loader threads share this generator

    def __call__(self, mouth: np.ndarray, faces: np.ndarray):
        if self.rng.random() < self.p_flip:
            mouth = mouth[:, :, ::-1, :].copy()
            faces = faces[:, :, ::-1, :].copy()
        return mouth, faces
