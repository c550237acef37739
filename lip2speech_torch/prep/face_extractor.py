"""Face and landmark extraction over a video corpus -> .json sidecars.

Counterpart of ``lip2speech_tpu/prep/face_extractor.py``: the frames of
each video go through the port's ``FaceDetector`` in batches (the two
graphs on its device), the face nearest the frame centre is kept with its
68 landmarks, and ``{frame_idx: {face_coords, landmarks}}`` is written as
``<stem>.json`` beside the video. Resumable: frames already in a sidecar
are not detected again.

Usage: python -m lip2speech_torch.prep.face_extractor --root <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import cv2
import numpy as np

VIDEO_EXTS = (".mp4", ".mov", ".mpg", ".avi")


def extract_faces_for_video(detector, video_path: str, json_path: str,
                            batch_size: int = 32) -> int:
    cap = cv2.VideoCapture(video_path)
    info: dict[str, dict] = {}
    if os.path.isfile(json_path):
        with open(json_path) as f:
            info = json.load(f)
    idx = 0
    frames, ids = [], []

    def flush():
        nonlocal frames, ids
        if not frames:
            return
        results = detector(np.stack(frames))
        for fid, res in zip(ids, results):
            if res is None:
                continue
            box, lm = res
            info[str(fid)] = {
                "face_coords": [int(v) for v in box],
                "landmarks": lm.astype(int).tolist(),
            }
        frames, ids = [], []

    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if str(idx) not in info:
            frames.append(frame[:, :, ::-1])
            ids.append(idx)
            if len(frames) == batch_size:
                flush()
        idx += 1
    flush()
    cap.release()
    with open(json_path, "w") as f:
        json.dump(info, f)
    return len(info)


def extract_faces_for_videos(root: str, model_dir: str | None = None,
                             batch_size: int = 32, device=None):
    """Every video under ``root``; the detector runs on ``device`` (CUDA
    unless the caller names another)."""
    from lip2speech_torch.detect import FaceDetector

    det = FaceDetector(model_dir=model_dir, device=device)
    done = 0
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            stem, ext = os.path.splitext(fn)
            if ext not in VIDEO_EXTS:
                continue
            video = os.path.join(dirpath, fn)
            sidecar = os.path.join(dirpath, stem + ".json")
            n = extract_faces_for_video(det, video, sidecar, batch_size)
            done += 1
            print(f"{video}: {n} frames with faces")
    return done


def main(argv=None):
    p = argparse.ArgumentParser("face extractor")
    p.add_argument("--root", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    extract_faces_for_videos(args.root, batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
