"""Streaming windowed video readers: GRID and AVSpeech.

Counterpart of ``lip2speech_tpu/data/streaming.py:41-222``. The corpus is
walked for videos with ``.wav`` and ``.json`` sidecars (face coordinates and
68-point landmarks by absolute frame index). A cursor goes through the
clips in a shuffled order, and within a clip through windows of a duration
drawn from ``np.arange(0.5, duration + 0.2, 0.2)`` s that overlap by
0.2 s. Each frame of a window is aligned and cropped to the face, whose
lower half is the mouth. A window that cannot be read is replaced by the
next one (``reset_item``, at most 16 deep). Frames are decoded with
``cv2.VideoCapture``, seeking by ``CAP_PROP_POS_MSEC``.

The cursor is shared state: the threaded ``Loader`` calls ``__getitem__``
from several threads, so every read and update of it, the drawn window
included, happens under one re-entrant lock (``reset_item`` recurses under
it). The index passed to ``__getitem__`` is ignored.
"""

from __future__ import annotations

import json
import os
import threading

import cv2
import numpy as np

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.face_align import align_and_crop_face
from lip2speech_torch.data.rng import LockedRng
from lip2speech_torch.data.wild import face_crops_and_mouth, load_wav

FPS = 25
SR = 16000
OVERLAP = 0.2


class StreamingWindowDataset:
    """The machinery GRID and AVSpeech share; a subclass sets
    ``VIDEO_EXTS`` and the directory it walks."""

    VIDEO_EXTS: tuple = ()

    def __init__(self, root: str, mode: str = "train", cfg: DataConfig = DataConfig(),
                 duration: float = 1.0, augmentation=None,
                 rng: np.random.Generator | None = None, samples_per_epoch: int | None = None):
        self.cfg = cfg
        self.duration = duration
        self.augmentation = augmentation
        self.rng = LockedRng(rng)  # Loader threads share this generator

        self.items: list[tuple[str, str, str]] = []
        for dirpath, _, files in sorted(os.walk(self._walk_root(root, mode))):
            for fn in sorted(files):
                stem, ext = os.path.splitext(fn)
                if ext not in self.VIDEO_EXTS:
                    continue
                base = os.path.join(dirpath, stem)
                wav, info = base + ".wav", base + ".json"
                if os.path.isfile(wav) and os.path.isfile(info):
                    self.items.append((os.path.join(dirpath, fn), wav, info))
        self._n = samples_per_epoch or max(len(self.items), 1)
        self._order = list(range(len(self.items)))
        self.rng.shuffle(self._order)
        self._cursor = 0
        self._clip = None
        self._time = 0.0
        self._end = 0.0
        self._depth = 0
        self._lock = threading.RLock()

    def _walk_root(self, root: str, mode: str) -> str:
        return root

    def __len__(self) -> int:
        return self._n

    def _next_clip(self):
        if not self.items:
            raise RuntimeError("empty streaming dataset")
        if self._cursor >= len(self._order):
            self.rng.shuffle(self._order)
            self._cursor = 0
        idx = self._order[self._cursor]
        self._cursor += 1
        video, wav, info = self.items[idx]
        cap = cv2.VideoCapture(video)
        n_frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        fps = cap.get(cv2.CAP_PROP_FPS) or FPS
        cap.release()
        self._clip = (video, wav, info)
        self._time = 0.0
        self._end = round(float(n_frames / max(fps, 1e-6)), 1)

    def reset_item(self) -> dict:
        """The next window in place of one that could not be read."""
        with self._lock:
            self._clip = None
            self._depth += 1
            if self._depth > 16:
                self._depth -= 1
                raise RuntimeError("too many consecutive decode failures")
            try:
                return self[0]
            finally:
                self._depth -= 1

    def __getitem__(self, _) -> dict:
        with self._lock:
            if self._clip is None:
                self._next_clip()
            video, wav_path, info_path = self._clip
            start = max(self._time - OVERLAP, 0.0)
            if start > self._end:
                return self.reset_item()
            dur = float(self.rng.choice(np.arange(0.5, self.duration + OVERLAP, OVERLAP)))
            self._time += dur

        try:
            sr, audio_full = load_wav(wav_path)
            a0 = int(SR * start)
            audio = audio_full[a0: a0 + int(SR * dur)]
        except (OSError, ValueError):
            return self.reset_item()
        if sr != SR or audio.shape[-1] == 0:
            return self.reset_item()

        frames = self._read_frames(video, start, dur)
        if frames is None or not len(frames):
            return self.reset_item()

        with open(info_path) as f:
            frame_info = json.load(f)

        first_abs = int(start * FPS)
        faces = []
        for i, frame in enumerate(frames):
            key = str(first_abs + i)
            if key not in frame_info:
                continue
            coords = np.asarray(frame_info[key]["face_coords"], np.int64)
            coords[coords < 0] = 0
            face = align_and_crop_face(frame, coords, frame_info[key]["landmarks"])
            if face.shape[0] < 16 or face.shape[1] < 16:
                return self.reset_item()
            faces.append(face)
        if not faces:
            return self.reset_item()

        if self.augmentation is not None:
            # one flip for every frame of the window
            if self.rng.random() < getattr(self.augmentation, "p_flip", 0.5):
                faces = [f[:, ::-1] for f in faces]

        crops, mouth = face_crops_and_mouth(faces, self.cfg, self.rng)
        return {"mouth": mouth, "faces": crops, "audio": audio.astype(np.float32),
                "path": wav_path}

    def _read_frames(self, video: str, start: float, dur: float):
        """RGB frames of the window, or None when the video does not open."""
        cap = cv2.VideoCapture(video)
        if not cap.isOpened():
            return None
        try:
            cap.set(cv2.CAP_PROP_POS_MSEC, start * 1000.0)
            frames = []
            want = int(dur * FPS) + 1
            while len(frames) < want:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame[:, :, ::-1])  # BGR -> RGB
        finally:
            cap.release()
        return frames


class GRID(StreamingWindowDataset):
    """GRID: videos anywhere under ``root``."""

    VIDEO_EXTS = (".mov", ".mpg", ".avi", ".mp4")


class AVSpeech(StreamingWindowDataset):
    """AVSpeech: videos under ``root/<mode>`` when it exists, else ``root``."""

    VIDEO_EXTS = (".mp4", ".avi")

    def _walk_root(self, root: str, mode: str) -> str:
        sub = os.path.join(root, mode)
        return sub if os.path.isdir(sub) else root
