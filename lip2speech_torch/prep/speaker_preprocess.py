"""Speaker-encoder corpus preprocessing: frame dumps + face sidecars.

Counterpart of ``lip2speech_tpu/prep/speaker_preprocess.py``: every frame
of each AVSpeech clip is dumped to ``<stem>/frames/<idx>.jpg`` and a
face-detection sidecar ``<stem>.json`` is written (the layout the
AVSpeechFace reader consumes).

Usage: python -m lip2speech_torch.prep.speaker_preprocess --root <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import cv2

from lip2speech_torch.prep.face_extractor import extract_faces_for_video


def video_to_frames(video_path: str) -> int:
    stem = os.path.splitext(video_path)[0]
    out_dir = os.path.join(stem, "frames")
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out = os.path.join(out_dir, f"{idx}.jpg")
        if not os.path.isfile(out):
            cv2.imwrite(out, frame)
        idx += 1
    cap.release()
    return idx


def main(argv=None):
    p = argparse.ArgumentParser("speaker-encoder preprocess")
    p.add_argument("--root", required=True)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from lip2speech_torch.detect import FaceDetector

    det = FaceDetector(device=args.device)
    for dirpath, _, files in sorted(os.walk(args.root)):
        for fn in sorted(files):
            if not fn.endswith((".mp4", ".mov", ".mpg")):
                continue
            video = os.path.join(dirpath, fn)
            n = video_to_frames(video)
            sidecar = os.path.splitext(video)[0] + ".json"
            m = extract_faces_for_video(det, video, sidecar)
            print(f"{video}: {n} frames, {m} with faces")


if __name__ == "__main__":
    main()
