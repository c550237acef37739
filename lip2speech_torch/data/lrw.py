"""LRW corpus reader (the precomputed on-disk format).

Counterpart of ``lip2speech_tpu/data/lrw.py``. Per clip it reads
``LRW_Faces/<word>/<split>/<id>_face.npz`` and ``..._mouth.npz`` (bz2-pickled
lists of encoded JPEG frames) and ``lipread_audio/<word>/<split>/<id>.npz``
(16 kHz float waveform under ``data``). The index comes from
``lrw500_detected_face.csv`` when present, else from walking ``LRW_Faces``.

Host work is decoding only (bz2, then JPEG through ``cv2.imdecode``);
normalisation and mel extraction run batched on the device
(``collate.prepare_batch``). The JAX package decodes JPEG through its own
libjpeg module where it builds and through cv2 elsewhere; this reader uses
cv2 alone, and a frame that does not decode raises.
"""

from __future__ import annotations

import bz2
import os
import pickle
import threading

import cv2
import numpy as np

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.rng import LockedRng


def load_jpeg_stack(path: str) -> np.ndarray:
    """bz2-pickled list of encoded JPEGs -> (T, H, W, 3) RGB uint8.

    The file is decompressed in one call, which releases the GIL for all of
    it (unpickling from a ``bz2.BZ2File`` reads it in small pieces, each
    taking the GIL again)."""
    with open(path, "rb") as f:
        data = pickle.loads(bz2.decompress(f.read()))
    frames = []
    for i, buf in enumerate(data):
        img = cv2.imdecode(np.asarray(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: frame {i} is not a decodable JPEG")
        frames.append(img[:, :, ::-1])
    return np.ascontiguousarray(np.stack(frames))


class LRW:
    """Map-style dataset; ``__getitem__`` returns the sample dict ``collate``
    takes: ``mouth (T, 96, 96, 3)``, ``faces (n_crops, 160, 160, 3)`` (two
    random face frames resized), ``audio (S,)`` and ``path``.

    ``cache_bytes`` > 0 keeps decoded (faces, mouth, audio) in memory up to
    that many bytes, first come first kept: decoding is the host's main cost
    and is the same every epoch, while augmentation and the face crops stay
    after the cache and are drawn anew each time."""

    def __init__(self, root: str, mode: str = "train", cfg: DataConfig = DataConfig(),
                 augmentation=None, rng: np.random.Generator | None = None,
                 cache_bytes: int = 0):
        assert mode in ("train", "test", "val")
        self.root = root
        self.mode = mode
        self.cfg = cfg
        self.augmentation = augmentation
        self.rng = LockedRng(rng)  # Loader threads share this generator
        self._cache: dict[int, tuple] = {}
        self._cache_lock = threading.Lock()
        self._cache_bytes = 0
        self._cache_budget = int(cache_bytes)

        names: list[str] = []
        csv_path = os.path.join(root, "lrw500_detected_face.csv")
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                for line in f.read().splitlines():
                    name = line.split(",")[0]
                    if name.split("/")[-2] == mode:
                        names.append(name)
        else:  # no csv: walk LRW_Faces for this split's *_face.npz
            faces_root = os.path.join(root, "LRW_Faces")
            for dirpath, _, files in sorted(os.walk(faces_root)):
                if os.path.basename(dirpath) != mode:
                    continue
                for fn in sorted(files):
                    if fn.endswith("_face.npz"):
                        names.append(os.path.relpath(
                            os.path.join(dirpath, fn[: -len("_face.npz")]), faces_root))
        self.items = [(os.path.join(root, "LRW_Faces", f"{n}_face.npz"),
                       os.path.join(root, "LRW_Faces", f"{n}_mouth.npz"),
                       os.path.join(root, "lipread_audio", f"{n}.npz")) for n in names]

    def __len__(self) -> int:
        return len(self.items)

    def _decode(self, idx: int) -> tuple:
        with self._cache_lock:
            hit = self._cache.get(idx)
        if hit is not None:
            return hit
        face_path, mouth_path, audio_path = self.items[idx]
        faces = load_jpeg_stack(face_path)
        mouth = load_jpeg_stack(mouth_path)
        audio = np.load(audio_path)["data"].astype(np.float32)
        entry = (faces, mouth, audio, audio_path)
        size = faces.nbytes + mouth.nbytes + audio.nbytes
        with self._cache_lock:
            if idx not in self._cache and self._cache_bytes + size <= self._cache_budget:
                self._cache[idx] = entry  # no eviction: a shuffled order would churn
                self._cache_bytes += size
        return entry

    def __getitem__(self, idx: int) -> dict:
        faces, mouth, audio, audio_path = self._decode(idx)
        if self._cache_budget:  # never hand the cached arrays out for writing
            faces, mouth = faces.copy(), mouth.copy()
        if self.augmentation is not None:
            mouth, faces = self.augmentation(mouth, faces)

        n = self.cfg.n_face_crops
        ids = (self.rng.random(n) * len(faces)).astype(np.int64)
        crops = np.stack([cv2.resize(faces[i], self.cfg.face_size[::-1]) for i in ids])
        if mouth.shape[1:3] != tuple(self.cfg.mouth_size):
            mouth = np.stack([cv2.resize(f, self.cfg.mouth_size[::-1]) for f in mouth])
        return {"mouth": mouth, "faces": crops, "audio": audio, "path": audio_path}
