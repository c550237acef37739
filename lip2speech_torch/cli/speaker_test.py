"""Qualitative speaker-encoder check: one sample's face image and its face
and speech embeddings, written for inspection.

Counterpart of ``lip2speech_tpu/cli/speaker_test.py:21-50``, which it
follows: the weights are a fresh random initialisation (seed 0), and the
face net (eval mode) and the voice encoder embed test sample ``--index``.
Writes ``face.jpg``, ``face_embedding.npy`` (1, 256) and
``speech_embedding.npy`` (1, 256) into ``--out``.

Usage: python -m lip2speech_torch.cli.speaker_test --root <AVSpeech root> [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np
import torch

from lip2speech_torch.config import Config
from lip2speech_torch.models.layers import resolve_device
from lip2speech_torch.ops.image import normalize_face
from lip2speech_torch.speaker import AVSpeechFace, init_speaker_training


def main(argv=None) -> dict[str, np.ndarray]:
    p = argparse.ArgumentParser("speaker encoder qualitative test")
    p.add_argument("--root", required=True)
    p.add_argument("--out", default="speaker_test_out")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    cfg = Config()
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sample = AVSpeechFace(args.root, mode="test", cfg=cfg.data)[args.index]
    model = init_speaker_training(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    with torch.no_grad():
        faces = normalize_face(torch.from_numpy(sample["face"][None].copy()).to(device))
        face_emb = model.face(faces.permute(0, 3, 1, 2)).cpu().numpy()
        speech_emb = model.speaker(torch.from_numpy(sample["speech"][None]).to(device)).cpu().numpy()

    cv2.imwrite(os.path.join(args.out, "face.jpg"), sample["face"][:, :, ::-1])
    np.save(os.path.join(args.out, "face_embedding.npy"), face_emb)
    np.save(os.path.join(args.out, "speech_embedding.npy"), speech_emb)
    print(f"wrote face.jpg + embeddings to {args.out}")
    return {"face_embedding": face_emb, "speech_embedding": speech_emb}


if __name__ == "__main__":
    main()
