"""GE2E-style voice speaker encoder (PyTorch).

Counterpart of ``lip2speech_tpu/models/speaker.py:21-51``: the power mel
(n_fft 400, hop 160, 40 mels, fmin 0, fmax 8000 at 16 kHz, no log) ->
3-layer LSTM (40 -> 256, cuDNN on the card) -> the last layer's final
hidden state -> Linear(256 -> 256). ``inference`` applies ReLU and an L2
normalisation with a floor of 1e-12. Parameter names are the reference's
(``lstm.*``, ``linear.*``), so the ``speaker_encoder.*`` part of a combined
reference checkpoint (``cli.common.load_model``) loads with
``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import AudioConfig, ModelConfig
from lip2speech_torch.ops.mel import melspectrogram

SPEAKER_AUDIO_CFG = AudioConfig(sample_rate=16000, n_fft=400, win_length=400, hop_length=160,
                                n_mels=40, fmin=0.0, fmax=8000.0)


class SpeakerEncoder(nn.Module):
    """(B, n_samples) waveform -> (B, 256) voice embedding."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dim = cfg.speaker_lstm_dim
        self.lstm = nn.LSTM(SPEAKER_AUDIO_CFG.n_mels, dim, num_layers=cfg.speaker_lstm_layers,
                            batch_first=True)
        self.linear = nn.Linear(dim, dim)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        # the mel is computed in f32 (ops/stft.py); the LSTM runs in its own type
        mels = melspectrogram(waveform, SPEAKER_AUDIO_CFG, log=False).transpose(1, 2)
        mels = mels.to(self.linear.weight.dtype)
        _, (hidden, _) = self.lstm(mels)
        return self.linear(hidden[-1])

    def inference(self, waveform: torch.Tensor) -> torch.Tensor:
        emb = F.relu(self(waveform))
        return emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-12)
