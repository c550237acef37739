"""WILD corpus reader (precomputed 2-second segments).

Counterpart of ``lip2speech_tpu/data/wild.py:31-103``. Each segment is a
video file (only its name is read) beside ``<id>.wav`` (16 kHz),
``<id>.json`` (face coordinates and landmarks) and ``<id>_face.npz``
(bz2-pickled JPEGs of the aligned faces). The mouth is the lower half of
each face, resized; the mel is computed from the waveform on the device.
Every segment under ``root`` is read whatever the split.
"""

from __future__ import annotations

import os

import cv2
import numpy as np

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.lrw import load_jpeg_stack
from lip2speech_torch.data.rng import LockedRng

VIDEO_EXTS = (".mp4", ".mov", ".mpg", ".avi")


def load_wav(path: str) -> tuple[int, np.ndarray]:
    """A wav file -> (sample rate, float32 samples in [-1, 1]): int16,
    int32 and uint8 scaled as torchaudio's ``normalize=True``, floats as
    they are; of several channels the first."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data[:, 0]
    return sr, data


def face_crops_and_mouth(faces, cfg: DataConfig, rng) -> tuple[np.ndarray, np.ndarray]:
    """(``cfg.n_face_crops`` faces drawn from ``rng`` and resized to
    ``face_size``, the lower half of every face resized to ``mouth_size``)."""
    ids = (rng.random(cfg.n_face_crops) * len(faces)).astype(np.int64)
    crops = np.stack([cv2.resize(faces[i], cfg.face_size[::-1]) for i in ids])
    mouth = np.stack([cv2.resize(f[f.shape[0] // 2:], cfg.mouth_size[::-1]) for f in faces])
    return crops, mouth


class WILD:
    def __init__(self, root: str, mode: str = "train", cfg: DataConfig = DataConfig(),
                 augmentation=None, rng: np.random.Generator | None = None):
        assert mode in ("train", "test")
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = LockedRng(rng)  # Loader threads share this generator

        self.items: list[tuple[str, str, str]] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                stem, ext = os.path.splitext(fn)
                if ext not in VIDEO_EXTS:
                    continue
                base = os.path.join(dirpath, stem)
                wav, info, face = base + ".wav", base + ".json", base + "_face.npz"
                if all(os.path.isfile(p) for p in (wav, info, face)):
                    self.items.append((wav, face, info))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        wav_path, face_path, _ = self.items[idx]
        _, audio = load_wav(wav_path)
        faces = load_jpeg_stack(face_path)  # aligned by the preprocessing
        if self.augmentation is not None:
            faces, _ = self.augmentation(faces, faces[:1])
        crops, mouth = face_crops_and_mouth(faces, self.cfg, self.rng)
        return {"mouth": mouth, "faces": crops, "audio": audio, "path": wav_path}
