"""AVSpeechFace: a 2-second speech window and one aligned face crop.

Counterpart of ``lip2speech_tpu/speaker/dataset.py:34-137``. Under
``root/<mode>/`` each clip has ``<id>.mp4|.mov|.mpg`` (only its name is
read), ``<id>.wav`` (16 kHz), ``<id>.json`` (face coordinates and
landmarks by absolute frame) and the frame dumps ``<id>/frames/<n>.jpg``.
A sample is a window starting on a 0.25 s grid, a frame drawn within the
window's first 0.25 s, aligned, cropped and resized to ``face_size``
(uint8, RGB), and the window's speech. Frames and wavs that fail are
remembered and another clip is drawn (``reset_item``, at most 32 deep).

The generator is a plain ``np.random.Generator``, not shared between
threads: the pretraining loop reads samples one by one.
"""

from __future__ import annotations

import collections
import glob
import json
import os

import cv2
import numpy as np

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.face_align import align_and_crop_face
from lip2speech_torch.data.wild import load_wav

FPS = 25
SR = 16000


class AVSpeechFace:
    def __init__(self, root: str, mode: str = "train", cfg: DataConfig = DataConfig(),
                 duration: float = 2.0, rng: np.random.Generator | None = None):
        assert mode in ("train", "test")
        self.root = os.path.join(root, mode)
        self.cfg = cfg
        self.duration = duration
        self.rng = rng if rng is not None else np.random.default_rng(0)

        self.items: list[tuple[str, str, str]] = []
        for fmt in ("mp4", "mov", "mpg"):
            for video in sorted(glob.glob(f"{self.root}/*.{fmt}")):
                stem = video[:-4]
                wav, js = stem + ".wav", stem + ".json"
                if os.path.isfile(wav) and os.path.isfile(js):
                    self.items.append((stem, wav, js))

        self.invalid_frame: dict[str, set] = collections.defaultdict(set)
        self.invalid_audio: set = set()
        self._depth = 0

    def __len__(self) -> int:
        return len(self.items)

    def reset_item(self) -> dict:
        """A sample of a clip drawn at random, in place of one that failed."""
        self._depth += 1
        try:
            if self._depth > 32:
                raise RuntimeError("too many invalid samples")
            return self[int(self.rng.integers(len(self)))]
        finally:
            self._depth -= 1

    def __getitem__(self, idx: int) -> dict:
        stem, wav_path, json_path = self.items[idx]
        if wav_path in self.invalid_audio:
            return self.reset_item()

        frames_dir = os.path.join(stem, "frames")
        frame_files = glob.glob(f"{frames_dir}/*.jpg")
        if not frame_files:
            return self.reset_item()
        end_time = len(frame_files) / FPS

        start = float(self.rng.choice(np.arange(0, max(end_time, 0.25), 0.25)))
        if start + self.duration > end_time:
            start = max(0.0, start - self.duration)
        dur = min(end_time, start + self.duration) - start

        frame_time = start + float(self.rng.uniform(0, 0.25))
        frame_idx = str(int(frame_time * FPS))
        if frame_idx in self.invalid_frame[json_path]:
            return self.reset_item()

        with open(json_path) as f:
            info = json.load(f)
        if frame_idx not in info:
            self.invalid_frame[json_path].add(frame_idx)
            return self.reset_item()

        frame = cv2.imread(os.path.join(frames_dir, f"{frame_idx}.jpg"))
        if frame is None:
            self.invalid_frame[json_path].add(frame_idx)
            return self.reset_item()
        frame = frame[:, :, ::-1]

        coords = np.asarray(info[frame_idx]["face_coords"], np.int64)
        coords[coords < 0] = 0
        face = align_and_crop_face(frame, coords, info[frame_idx]["landmarks"])
        if face.shape[0] < 16 or face.shape[1] < 16:
            return self.reset_item()
        face = cv2.resize(face, self.cfg.face_size[::-1])

        try:
            _, audio = load_wav(wav_path)
        except (OSError, ValueError):
            self.invalid_audio.add(wav_path)
            return self.reset_item()
        a0 = int(SR * start)
        speech = audio[a0: a0 + int(SR * dur)].astype(np.float32)
        if speech.shape[-1] < SR // 2:
            return self.reset_item()
        return {"speech": speech, "face": face}


def collate_speaker(samples, n_samples: int = 32000) -> dict[str, np.ndarray]:
    """Trim every speech window to the shortest (at most ``n_samples``),
    then zero-pad to ``n_samples``: ``speech`` (B, n_samples) float32 and
    ``faces_u8`` (B, H, W, 3)."""
    min_s = min(min(s["speech"].shape[-1] for s in samples), n_samples)
    speech = np.stack([s["speech"][:min_s] for s in samples])
    if min_s < n_samples:
        speech = np.pad(speech, ((0, 0), (0, n_samples - min_s)))
    faces = np.stack([s["face"] for s in samples])
    return {"speech": speech.astype(np.float32), "faces_u8": faces}
