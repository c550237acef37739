"""Headless face-detector demo over a video: annotated frames out.

Counterpart of ``lip2speech_tpu/prep/detector_demo.py``: each frame goes
through the port's ``FaceDetector`` and is written to the output
directory with its box and landmarks drawn.

Usage: python -m lip2speech_torch.prep.detector_demo --video x.mp4 --out dir [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import cv2


def main(argv=None) -> int:
    p = argparse.ArgumentParser("detector demo")
    p.add_argument("--video", required=True)
    p.add_argument("--out", default="detector_demo_out")
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from lip2speech_torch.detect import FaceDetector

    det = FaceDetector(device=args.device)
    os.makedirs(args.out, exist_ok=True)
    cap = cv2.VideoCapture(args.video)
    idx = 0
    while idx < args.max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        res = det(frame[None, :, :, ::-1])[0]
        if res is not None:
            box, lm = res
            cv2.rectangle(frame, (int(box[0]), int(box[1])), (int(box[2]), int(box[3])),
                          (0, 255, 0), 2)
            for x, y in lm:
                cv2.circle(frame, (int(x), int(y)), 1, (0, 0, 255), -1)
        cv2.imwrite(os.path.join(args.out, f"{idx:05d}.jpg"), frame)
        idx += 1
    cap.release()
    print(f"wrote {idx} annotated frames to {args.out}")
    return idx


if __name__ == "__main__":
    main()
