"""LRW corpus preprocessing.

Counterpart of ``lip2speech_tpu/prep/lrw_preprocess.py``: per word and
split, (1) extract mono 16 kHz audio from each mp4 (ffmpeg-gated) and store
it as the raw-waveform ``.npz`` the LRW reader consumes, and (2) run the
port's ``FaceDetector`` over all of a clip's frames at once, writing the
per-frame ``face_coords`` and landmarks json.

Usage: python -m lip2speech_torch.prep.lrw_preprocess --root <mp4 root>
       --out <corpus root> [--skip_audio] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import cv2
import numpy as np


def preprocess_clip(video_path: str, detector, out_audio: str | None,
                    out_json: str, sr: int = 16000):
    if out_audio and not os.path.isfile(out_audio):
        import tempfile

        from lip2speech_torch.data.wild import load_wav
        from lip2speech_torch.prep.common import extract_wav

        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            extract_wav(video_path, tmp.name, sr)
            _, wav = load_wav(tmp.name)
        os.makedirs(os.path.dirname(out_audio), exist_ok=True)
        np.savez(out_audio, data=wav.astype(np.float32))

    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    cap.release()
    if not frames:
        return 0
    results = detector(np.stack(frames))
    info = {
        str(i): {"face_coords": [int(v) for v in res[0]],
                 "landmarks": res[1].astype(int).tolist()}
        for i, res in enumerate(results)
        if res is not None
    }
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(info, f)
    return len(info)


def main(argv=None):
    p = argparse.ArgumentParser("LRW preprocess")
    p.add_argument("--root", required=True, help="LRW mp4 root (word/split/*.mp4)")
    p.add_argument("--out", required=True, help="output corpus root")
    p.add_argument("--skip_audio", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from lip2speech_torch.detect import FaceDetector

    det = FaceDetector(device=args.device)
    n = 0
    for dirpath, _, files in sorted(os.walk(args.root)):
        for fn in sorted(files):
            if not fn.endswith(".mp4"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn[:-4]), args.root)
            preprocess_clip(
                os.path.join(dirpath, fn),
                det,
                None if args.skip_audio else os.path.join(args.out, "lipread_audio", rel + ".npz"),
                os.path.join(args.out, "face_info", rel + ".json"),
            )
            n += 1
    print(f"processed {n} clips")


if __name__ == "__main__":
    main()
