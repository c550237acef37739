"""Auxiliary audio encoders (PyTorch), which no entry point uses.

Counterpart of ``lip2speech_tpu/models/audio_extras.py:28-62``:

- ``Wav2VecFeatureExtractor``: the wav2vec feature encoder's conv stack,
  five VALID Conv1d layers (kernel, stride, 512 channels) each followed by
  GELU, the first with GroupNorm(1 group, eps 1e-6) before it;
- ``AudioExtractor``: those features and a Linear projection to 512;
- ``SpecEncoder``: a linear spectrogram (B, n_freqs, T) through four
  stride-2 Conv1d + BatchNorm + ReLU layers, a mean over time and a Linear
  to 512.

GELU is flax's default, the tanh approximation (the face net's projection
uses the exact one). Module names are the flax ones (``conv_i``, ``gn_0``,
``bn_i``, ``projection``, ``fc``), so ``weights.named_from_flax`` carries a
flax tree across; the BatchNorms train by flax's rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.models.layers import BatchNorm1d

# wav2vec-large feature encoder: (kernel, stride, channels) of each conv
WAV2VEC_CONV_LAYERS = [(10, 5, 512), (8, 4, 512), (4, 2, 512), (4, 2, 512), (4, 2, 512)]
SPEC_CHANNELS = (64, 128, 256, 512)


class Wav2VecFeatureExtractor(nn.Module):
    """(B, n_samples) -> (B, T', 512) conv features."""

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (k, s, d) in enumerate(WAV2VEC_CONV_LAYERS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, d, k, stride=s))
            cin = d
        self.gn_0 = nn.GroupNorm(1, WAV2VEC_CONV_LAYERS[0][2], eps=1e-6)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for i in range(len(WAV2VEC_CONV_LAYERS)):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.gn_0(x)
            x = F.gelu(x, approximate="tanh")
        return x.transpose(1, 2)


class AudioExtractor(nn.Module):
    """wav2vec features and a projection: (B, n_samples) -> (B, T', 512)."""

    def __init__(self):
        super().__init__()
        self.wav2vec = Wav2VecFeatureExtractor()
        self.projection = nn.Linear(WAV2VEC_CONV_LAYERS[-1][2], 512)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.projection(self.wav2vec(wav))


class SpecEncoder(nn.Module):
    """(B, n_freqs, T) linear spectrogram -> (B, 512) embedding."""

    def __init__(self, n_freqs: int):
        super().__init__()
        cin = n_freqs
        for i, ch in enumerate(SPEC_CHANNELS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, 3, stride=2, padding=1))
            self.add_module(f"bn_{i}", BatchNorm1d(ch))
            cin = ch
        self.fc = nn.Linear(cin, 512)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = spec
        for i in range(len(SPEC_CHANNELS)):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x)))
        return self.fc(x.mean(dim=2))
