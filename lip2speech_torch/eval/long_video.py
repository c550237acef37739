"""Long-video synthesis by chunking (PyTorch).

Counterpart of ``lip2speech_tpu/eval/long_video.py``: split the silent
video into fixed windows, decode every window in one batch, keep each
window's pro-rata mel frames, concatenate, and run Griffin-Lim once over
the whole so chunk boundaries share one phase.
"""

from __future__ import annotations

import numpy as np
import torch

from lip2speech_torch.config import Config
from lip2speech_torch.ops import griffin_lim as gl_ops


def chunk_video(video: np.ndarray, chunk_frames: int) -> tuple[np.ndarray, int]:
    """(T, H, W, 3) -> (n_chunks, chunk_frames, H, W, 3); the tail chunk is
    edge-padded. Returns (chunks, n_valid_tail_frames)."""
    t = video.shape[0]
    n_chunks = max(1, -(-t // chunk_frames))
    pad = n_chunks * chunk_frames - t
    if pad:
        video = np.concatenate([video, np.repeat(video[-1:], pad, axis=0)])
    return video.reshape(n_chunks, chunk_frames, *video.shape[1:]), chunk_frames - pad


def chunk_mel_counts(n_chunks: int, chunk_frames: int, tail_valid: int, sample_rate: int,
                     hop_length: int, fps: float = 25.0) -> list[int]:
    """Per-chunk mel frame counts from rounded cumulative boundaries, so the
    running total stays within half a frame of exact at every boundary."""
    rate = chunk_frames * sample_rate / fps / hop_length
    frame_rate = sample_rate / fps / hop_length
    total_exact = ((n_chunks - 1) * chunk_frames + tail_valid) * frame_rate
    counts = []
    for i in range(n_chunks):
        end = (i + 1) * rate if i < n_chunks - 1 else total_exact
        counts.append(max(1, int(round(end)) - int(round(i * rate))))
    return counts


def synthesize_long_video(model, video: np.ndarray, faces: np.ndarray, cfg: Config,
                          device: torch.device, generator: torch.Generator | None = None,
                          n_gl_iters: int = 32,
                          speaker_embedding: np.ndarray | None = None,
                          compute_dtype=torch.bfloat16) -> tuple[np.ndarray, np.ndarray]:
    """Waveform for a video of any length from normalised mouth frames
    (T, H, W, 3) and identity crops (n_crops, Hf, Wf, 3). Returns
    (waveform, log-mel (n_mels, M_total))."""
    chunk_frames = cfg.data.max_video_frames
    chunks, tail_valid = chunk_video(np.asarray(video), chunk_frames)
    n = chunks.shape[0]
    dtype = next(model.parameters()).dtype
    video_b = torch.as_tensor(chunks, device=device).to(dtype)
    faces_b = torch.as_tensor(np.asarray(faces), device=device).to(dtype)[None].expand(n, -1, -1, -1, -1)
    spk = None
    if speaker_embedding is not None:
        spk = torch.as_tensor(speaker_embedding, device=device).to(dtype)[None].expand(n, -1)
    out = model(video_b, faces_b, speaker_embedding=spk, generator=generator)
    mels = out["mel_postnet"].float()

    counts = chunk_mel_counts(n, chunk_frames, tail_valid, cfg.audio.sample_rate, cfg.audio.hop_length)
    mel_cat = torch.cat([mels[i, :, :m] for i, m in enumerate(counts)], dim=1)
    wav = gl_ops.mel_to_audio(mel_cat[None], cfg.audio, n_iter=n_gl_iters,
                              compute_dtype=compute_dtype, generator=generator)
    return wav[0].cpu().numpy(), mel_cat.cpu().numpy()
