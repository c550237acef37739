"""Synthetic LRW fixture in the corpus's on-disk format.

Counterpart of ``lip2speech_tpu/data/fixtures.py``: bz2-pickled lists of
JPEG-encoded frames for the mouth and face stacks and a raw-audio ``.npz``
per clip (see ``data/lrw.py``), so tests and smoke runs need no corpus.
The audio is a two-tone chirp, so the mel and ESTOI paths see structure.
"""

from __future__ import annotations

import bz2
import os
import pickle

import cv2
import numpy as np


def _encode_stack(frames: np.ndarray) -> bytes:
    enc = [cv2.imencode(".jpg", f[:, :, ::-1])[1] for f in frames]
    return bz2.compress(pickle.dumps(enc))


def make_sample_lrw(root: str, word: str = "ABOUT", split: str = "test", n_clips: int = 4,
                    n_frames: int = 29, n_samples: int = 19456, seed: int = 0) -> str:
    """Write ``n_clips`` clips of ``word`` into ``split`` under ``root``;
    returns ``root``."""
    rng = np.random.default_rng(seed)
    faces_dir = os.path.join(root, "LRW_Faces", word, split)
    audio_dir = os.path.join(root, "lipread_audio", word, split)
    os.makedirs(faces_dir, exist_ok=True)
    os.makedirs(audio_dir, exist_ok=True)

    sr = 16000
    t = np.arange(n_samples) / sr
    for i in range(1, n_clips + 1):
        name = f"{word}_{i:05d}"
        mouth = rng.integers(0, 255, (n_frames, 96, 96, 3), dtype=np.uint8)
        face = rng.integers(0, 255, (n_frames, 146, 120, 3), dtype=np.uint8)
        f0 = 200 + 50 * i
        wav = (0.4 * np.sin(2 * np.pi * f0 * t)
               + 0.2 * np.sin(2 * np.pi * 2 * f0 * t * (1 + 0.1 * t))).astype(np.float32)
        with open(os.path.join(faces_dir, f"{name}_mouth.npz"), "wb") as f:
            f.write(_encode_stack(mouth))
        with open(os.path.join(faces_dir, f"{name}_face.npz"), "wb") as f:
            f.write(_encode_stack(face))
        np.savez(os.path.join(audio_dir, f"{name}.npz"), data=wav)
    return root
