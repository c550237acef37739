"""Synthetic corpora in their on-disk formats, so tests and smoke runs
need no corpus.

``make_sample_lrw`` is the counterpart of ``lip2speech_tpu/data/fixtures.py``:
bz2-pickled lists of JPEG-encoded frames for the mouth and face stacks and a
raw-audio ``.npz`` per clip (see ``data/lrw.py``). ``make_sample_wild``,
``make_sample_streaming`` and ``make_sample_avspeech_face`` write the WILD,
GRID / AVSpeech and speaker-pretraining layouts (``data/wild.py``,
``data/streaming.py``, ``speaker/dataset.py``): videos written by cv2
(MPEG-4 Part 2 in ``.mp4``, MJPG in ``.avi``), 16-bit wavs, landmark
sidecars whose eye line is tilted, and JPEG frames.
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

    for i in range(1, n_clips + 1):
        name = f"{word}_{i:05d}"
        mouth = rng.integers(0, 255, (n_frames, 96, 96, 3), dtype=np.uint8)
        face = rng.integers(0, 255, (n_frames, 146, 120, 3), dtype=np.uint8)
        wav = _chirp(n_samples, 200 + 50 * i)
        with open(os.path.join(faces_dir, f"{name}_mouth.npz"), "wb") as f:
            f.write(_encode_stack(mouth))
        with open(os.path.join(faces_dir, f"{name}_face.npz"), "wb") as f:
            f.write(_encode_stack(face))
        np.savez(os.path.join(audio_dir, f"{name}.npz"), data=wav)
    return root


FPS, SR = 25, 16000


def _frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB: a smooth gradient that drifts over time plus
    noise, so the JPEGs are neither trivial nor incompressible."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(h + w - 2, 1)], -1).astype(np.int32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        noise = rng.integers(-24, 25, (h, w, 3))
        out[i] = np.clip(base + 3 * i + noise, 0, 255).astype(np.uint8)
    return out


def _chirp(n_samples: int, f0: float) -> np.ndarray:
    t = np.arange(n_samples) / SR
    return (0.4 * np.sin(2 * np.pi * f0 * t)
            + 0.2 * np.sin(2 * np.pi * 2 * f0 * t * (1 + 0.1 * t))).astype(np.float32)


def _write_wav(path: str, wav: np.ndarray):
    from scipy.io import wavfile

    wavfile.write(path, SR, np.round(wav * 32767).astype(np.int16))


def landmarks_with_tilt(box, rng: np.random.Generator) -> np.ndarray:
    """68 (x, y) landmarks inside ``box`` (x1, y1, x2, y2) whose eye line is
    tilted: the right eye sits lower than the left, so the eye angle is not
    0 and the alignment rotates."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    lm = np.zeros((68, 2), np.int64)
    lm[:] = [x1 + w // 2, y1 + (3 * h) // 4]  # jaw, nose and mouth near the centre-bottom
    tilt = int(rng.integers(h // 10, h // 5))
    # the eyes' bounding rectangles are 13x5 and 14x6: one odd, one even, so
    # the integer midpoints differ from the exact ones by different amounts
    left = np.array([[-6, 0], [-3, -2], [3, -2], [6, 0], [3, 2], [-3, 2]])
    right = np.array([[-7, 0], [-3, -2], [3, -2], [6, 0], [3, 3], [-3, 3]])
    lm[36:42] = left + [x1 + w // 3, y1 + h // 3]
    lm[42:48] = right + [x1 + (2 * w) // 3, y1 + h // 3 + tilt]
    return lm


def _write_video(path: str, frames_rgb: np.ndarray):
    """Frames at 25 fps through cv2's writer: MPEG-4 Part 2 in an ``.mp4``,
    MJPG in any other container."""
    h, w = frames_rgb.shape[1:3]
    fourcc = "mp4v" if path.endswith(".mp4") else "MJPG"
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    try:
        for f in frames_rgb:
            vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    finally:
        vw.release()


def _frame_info(n_frames: int, box, rng: np.random.Generator) -> dict:
    """The ``.json`` sidecar: face coordinates and landmarks by frame."""
    return {str(i): {"face_coords": list(map(int, box)),
                     "landmarks": landmarks_with_tilt(box, rng).tolist()} for i in range(n_frames)}


def _write_json(path: str, info: dict):
    import json

    with open(path, "w") as f:
        json.dump(info, f)


def make_sample_wild(root: str, n_clips: int = 4, n_frames: int = 50, seed: int = 0) -> str:
    """WILD segments under ``root``: ``<id>.mp4`` beside ``<id>.wav`` (2 s
    at 16 kHz for 50 frames), ``<id>.json`` and ``<id>_face.npz`` (the
    aligned 128x128 faces as bz2-pickled JPEGs). Returns ``root``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    h = w = 128
    box = (0, 0, w, h)
    for i in range(n_clips):
        base = os.path.join(root, f"seg{i:05d}")
        faces = _frames(rng, n_frames, h, w)
        _write_video(base + ".mp4", faces[: min(n_frames, 8)])
        _write_wav(base + ".wav", _chirp(n_frames * SR // FPS, 180 + 40 * (i % 16)))
        _write_json(base + ".json", _frame_info(n_frames, box, rng))
        with open(base + "_face.npz", "wb") as f:
            f.write(_encode_stack(faces))
    return root


def make_sample_streaming(root: str, n_clips: int = 4, n_frames: int = 50, frame_hw=(176, 176),
                          ext: str = ".avi", seed: int = 0) -> str:
    """GRID or AVSpeech clips in ``root`` (for AVSpeech, pass
    ``<corpus>/<mode>``): a video of ``n_frames`` at 25 fps beside
    ``<id>.wav`` and ``<id>.json`` with a face box and tilted landmarks in
    every frame. Returns ``root``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    h, w = frame_hw
    for i in range(n_clips):
        base = os.path.join(root, f"clip{i:05d}")
        box = (w // 8 + int(rng.integers(0, 8)), h // 8 + int(rng.integers(0, 8)),
               (7 * w) // 8, (7 * h) // 8)
        _write_video(base + ext, _frames(rng, n_frames, h, w))
        _write_wav(base + ".wav", _chirp(n_frames * SR // FPS, 180 + 40 * (i % 16)))
        _write_json(base + ".json", _frame_info(n_frames, box, rng))
    return root


def make_sample_avspeech_face(root: str, mode: str = "train", n_clips: int = 4,
                              n_frames: int = 75, frame_hw=(176, 176), seed: int = 0) -> str:
    """The speaker-pretraining layout under ``root/<mode>``: ``<id>.mp4``,
    ``<id>.wav``, ``<id>.json`` and the frame dumps ``<id>/frames/<n>.jpg``.
    Returns ``root``."""
    rng = np.random.default_rng(seed)
    sub = os.path.join(root, mode)
    os.makedirs(sub, exist_ok=True)
    h, w = frame_hw
    for i in range(n_clips):
        base = os.path.join(sub, f"clip{i:05d}")
        box = (w // 8 + int(rng.integers(0, 8)), h // 8 + int(rng.integers(0, 8)),
               (7 * w) // 8, (7 * h) // 8)
        frames = _frames(rng, n_frames, h, w)
        _write_video(base + ".mp4", frames[: min(n_frames, 8)])
        _write_wav(base + ".wav", _chirp(n_frames * SR // FPS, 180 + 40 * (i % 16)))
        _write_json(base + ".json", _frame_info(n_frames, box, rng))
        os.makedirs(os.path.join(base, "frames"), exist_ok=True)
        for n, f in enumerate(frames):
            cv2.imwrite(os.path.join(base, "frames", f"{n}.jpg"), f[:, :, ::-1])
    return root
