"""WILD corpus preprocessing: long videos -> 2 s training segments.

Counterpart of ``lip2speech_tpu/prep/wild_preprocess.py``: split source
videos into 2 s segments (ffmpeg ``-segment_time``, ffmpeg-gated), then per
segment write the mel ``.npz``, the aligned-face JPEG stack (``_face.npz``,
bz2-pickled), the landmark ``.json`` and a ``.done`` marker; segments run
through a thread pool, and a target-face embedding can filter which face
is kept. The mel is the port's ``ops.mel.melspectrogram`` on the
detector's device; the faces are cropped by ``data.face_align``.

Usage: python -m lip2speech_torch.prep.wild_preprocess --root <segments>
       [--split_from <long video>] [--workers 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import bz2
import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch

from lip2speech_torch.config import AudioConfig
from lip2speech_torch.data.face_align import align_and_crop_face
from lip2speech_torch.data.wild import load_wav
from lip2speech_torch.prep.common import run_ffmpeg


def split_video(video_path: str, out_dir: str, segment_time: int = 2):
    """ffmpeg stream-copy split into ``segment_time``-second mp4s."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(video_path))[0]
    run_ffmpeg(
        [
            "-i", video_path,
            "-c", "copy", "-map", "0",
            "-segment_time", str(segment_time),
            "-f", "segment",
            "-reset_timestamps", "1",
            os.path.join(out_dir, f"{stem}_%05d.mp4"),
        ]
    )


def write_segment(
    video_path: str,
    detector=None,
    audio_cfg: AudioConfig = AudioConfig(),
    target_face_embedding=None,
    device=None,
) -> bool:
    """Produce <stem>.npz (mel), <stem>_face.npz, <stem>.json, <stem>.done
    next to the segment. Without ``detector``, a ``FaceDetector`` on
    ``device`` (CUDA unless the caller names another) is made."""
    stem = os.path.splitext(video_path)[0]
    done = stem + ".done"
    if os.path.isfile(done):
        return True
    if detector is None:
        from lip2speech_torch.detect import FaceDetector

        detector = FaceDetector(target_face_embedding=target_face_embedding, device=device)

    wav_path = stem + ".wav"
    if not os.path.isfile(wav_path):
        from lip2speech_torch.prep.common import extract_wav

        extract_wav(video_path, wav_path, audio_cfg.sample_rate)
    sr, audio = load_wav(wav_path)

    # mel npz (the training pipeline's mel, on the detector's device)
    from lip2speech_torch.ops import mel as mel_ops

    with torch.no_grad():
        mel = mel_ops.melspectrogram(torch.from_numpy(audio).to(detector.device), audio_cfg)
    np.savez(stem + ".npz", data=mel.cpu().numpy()[None])

    # face pass
    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])
    cap.release()
    if not frames:
        return False

    results = detector(np.stack(frames))

    encoded, info = [], {}
    for i, res in enumerate(results):
        if res is None:
            continue
        box, lm = res
        face = align_and_crop_face(frames[i], box, lm)
        if face.size == 0:
            continue
        encoded.append(cv2.imencode(".jpg", face[:, :, ::-1])[1])
        info[str(i)] = {
            "face_coords": [int(v) for v in box],
            "landmarks": lm.astype(int).tolist(),
        }
    if not encoded:
        return False

    with open(stem + "_face.npz", "wb") as f:
        f.write(bz2.compress(pickle.dumps(encoded)))
    with open(stem + ".json", "w") as f:
        json.dump(info, f)
    open(done, "w").close()
    return True


def main(argv=None):
    p = argparse.ArgumentParser("WILD preprocess")
    p.add_argument("--root", required=True, help="dir of segment videos")
    p.add_argument("--split_from", default=None, help="long video to segment first")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    if args.split_from:
        split_video(args.split_from, args.root)

    segments = [
        os.path.join(dp, f)
        for dp, _, fs in os.walk(args.root)
        for f in fs
        if f.endswith((".mp4", ".mov", ".mpg"))
    ]
    from lip2speech_torch.detect import FaceDetector

    det = FaceDetector(device=args.device)
    with ThreadPoolExecutor(args.workers) as pool:
        ok = list(pool.map(lambda v: write_segment(v, det), segments))
    print(f"{sum(ok)}/{len(segments)} segments processed")


if __name__ == "__main__":
    main()
