"""Static-shape batch assembly (PyTorch).

Counterpart of ``lip2speech_tpu/data/collate.py:31-110``. ``collate`` pads
the samples into compact uint8 / raw-audio buffers on the host (numpy);
``prepare_batch`` turns them into model-ready tensors on the batch's
device: normalised video and faces, the log-mel target, the gate target
and the mel mask.

Collate output (numpy, host):
  mouth_u8  (B, Tv, 96, 96, 3) uint8   video_lengths (B,) int32
  audio     (B, S) float32             audio_lengths (B,) int32
  faces_u8  (B, n_crops, 160, 160, 3)  mel_lengths   (B,) int32
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lip2speech_torch.config import AudioConfig, DataConfig
from lip2speech_torch.models.layers import resolve_device
from lip2speech_torch.ops import image as image_ops
from lip2speech_torch.ops import mel as mel_ops
from lip2speech_torch.utils import trace


def collate(samples: Sequence[dict], cfg: DataConfig) -> dict[str, np.ndarray]:
    """Samples with ``mouth (T, H, W, 3)`` uint8, ``faces (n, Hf, Wf, 3)``
    uint8 and ``audio (S,)`` -> zero-padded buffers at the config's sizes."""
    b = len(samples)
    tv = cfg.max_video_frames
    s_max = cfg.max_audio_samples
    mouth = np.zeros((b, tv, *cfg.mouth_size, 3), np.uint8)
    faces = np.zeros((b, cfg.n_face_crops, *cfg.face_size, 3), np.uint8)
    audio = np.zeros((b, s_max), np.float32)
    v_len = np.zeros((b,), np.int32)
    a_len = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        t = min(s["mouth"].shape[0], tv)
        mouth[i, :t] = s["mouth"][:t]
        v_len[i] = t
        n = min(s["audio"].shape[-1], s_max)
        audio[i, :n] = s["audio"][..., :n]
        a_len[i] = n
        faces[i] = s["faces"][: cfg.n_face_crops]
    # at the default hop; prepare_batch recomputes it from the audio config
    mel_len = 1 + a_len // 256
    return {
        "mouth_u8": mouth,
        "faces_u8": faces,
        "audio": audio,
        "video_lengths": v_len,
        "audio_lengths": a_len,
        "mel_lengths": mel_len.astype(np.int32),
    }


def to_device(raw: dict, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors) as tensors on ``device``
    (CUDA unless the caller names another). For the card, host memory that
    is not page-locked is pinned first, so each copy is asynchronous."""
    dev = resolve_device(device)

    def put(v):
        v = torch.as_tensor(v)
        if dev.type == "cuda" and v.device.type == "cpu" and not v.is_pinned():
            v = v.pin_memory()
        return v.to(dev, non_blocking=True)

    return {k: put(v) for k, v in raw.items()}


def prepare_batch(raw: dict[str, torch.Tensor], audio_cfg: AudioConfig = AudioConfig(),
                  data_cfg: DataConfig = DataConfig()) -> dict[str, torch.Tensor]:
    """uint8 / raw-audio tensors -> model-ready tensors, on their device.

    Produces video (B, T, 96, 96, 3) ImageNet-normalised with padded frames
    zeroed, faces (B, 2, 160, 160, 3) facenet-normalised, mel (B, 80, M)
    log-mel padded with ``mel_pad_value``, gate (B, M) with 1s from the
    last valid frame on, mel_mask (B, M) on the valid frames; mel lengths
    come from ``audio_lengths // hop + 1``."""
    with trace.span("data.prepare_batch"):
        video = image_ops.normalize_mouth(raw["mouth_u8"])
        frames = torch.arange(video.shape[1], device=video.device)
        video = video * (frames[None, :] < raw["video_lengths"][:, None])[:, :, None, None, None]
        faces = image_ops.normalize_face(raw["faces_u8"])

        mel = mel_ops.melspectrogram(raw["audio"], audio_cfg)  # (B, 80, M)
        mel_lengths = (1 + raw["audio_lengths"] // audio_cfg.hop_length).to(torch.int32)
        steps = torch.arange(mel.shape[-1], device=mel.device)[None, :]
        valid = steps < mel_lengths[:, None]
        mel = torch.where(valid[:, None, :], mel, data_cfg.mel_pad_value)
        gate = (steps >= (mel_lengths - 1)[:, None]).float()
        return {
            "video": video,
            "faces": faces,
            "mel": mel,
            "gate": gate,
            "mel_mask": valid,
            "video_lengths": raw["video_lengths"],
            "mel_lengths": mel_lengths,
            "audio": raw["audio"],
            "audio_lengths": raw["audio_lengths"],
        }
