"""Mel-patch WGAN critic (PyTorch).

Counterpart of ``lip2speech_tpu/models/discriminator.py:25-130``: a patch of
the mel, fused with the speaker embedding, classified by a Conv1d residual
pyramid. The patch has the fixed size ``cfg.discriminator_patch`` (P=32):
frames ``[start, start + length)`` of the mel sit at ``[0, length)`` and
zeros follow, with ``length`` in 7..31 (``sample_patch``).

Module names are the flax ones (``mel_encoder``, ``speaker_encoder``,
``enc_0``, ``enc_1``, ``res_{i}.{shortcut,conv1,bn1,conv2,bn2}``, ``fc``);
``weights.critic_from_flax`` carries a flax critic across. Every
BatchNorm trains by flax's rule (``layers.BatchNorm1d``): the new running
statistics are left in ``new_stats`` for the caller. The JAX module works
on (B, T, C); the residual pyramid here works on (B, C, T), and its
features come out in that layout.

Every random draw is an input: the patch ``(start, length)``, and the two
dropout keep masks, which the JAX critic applies only when it is given a
dropout key (neither of its training steps gives one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.layers import BatchNorm1d, dropout

# (features, down-sample) of the five residual blocks
BLOCKS = ((256, True), (384, True), (512, True), (768, True), (1024, False))
FEATURE_KEEP, POOLED_KEEP = 0.9, 0.8


class ResidualBlock(nn.Module):
    """(Conv1d + BN + LeakyReLU(0.2)) x 2 with a 1-wide conv shortcut, on
    (B, C, T). flax's 'SAME' padding of the 1-wide, stride-2 shortcut pads
    nothing at any length, so it is ``padding=0`` here."""

    def __init__(self, in_ch: int, features: int, down_sample: bool = True):
        super().__init__()
        stride = 2 if down_sample else 1
        self.shortcut = nn.Conv1d(in_ch, features, 1, stride=stride)
        self.conv1 = nn.Conv1d(in_ch, features, 3, padding=1)
        self.bn1 = BatchNorm1d(features)
        self.conv2 = nn.Conv1d(features, features, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm1d(features)

    def forward(self, x):
        h = F.leaky_relu(self.bn1(self.conv1(x)), 0.2)
        h = F.leaky_relu(self.bn2(self.conv2(h)), 0.2)
        return h + self.shortcut(x)


def sample_patch(t: int, max_patch: int, generator: torch.Generator | None = None,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, length) as 0-d int64 tensors on ``device``, drawn as the
    reference draws them: ``length ~ U{7..min(32, max_patch) - 1}``, ``u ~
    U{0..t-1}``, ``start = max(0, 1 + u - length)``; so ``start + length <=
    t`` whenever ``length <= t``, and the last frame is reachable."""
    length = torch.randint(7, min(32, max_patch), (), generator=generator, device=device)
    u = torch.randint(0, t, (), generator=generator, device=device)
    return torch.clamp(1 + u - length, min=0), length


def extract_patch(mel: torch.Tensor, start, length, P: int) -> torch.Tensor:
    """mel (B, n_mels, T) -> (B, P, n_mels): frames ``[start, start +
    length)`` at positions ``[0, length)``, zeros after, for ``start +
    length <= T`` (``sample_patch``'s draws). ``start`` and ``length`` are
    ints or 0-d tensors, read on the device, never on the host."""
    T = mel.shape[-1]
    pos = torch.arange(P, device=mel.device)
    start = torch.as_tensor(start, device=mel.device)
    x = mel.transpose(1, 2).index_select(1, torch.clamp(start + pos, max=T - 1))
    keep = pos < torch.as_tensor(length, device=mel.device)
    return torch.where(keep[None, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class Discriminator(nn.Module):
    """(B, n_mels, T) mel + (B, E) speaker embedding -> (B,) WGAN logit."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.mel_encoder = nn.Linear(cfg.n_mels, 256)
        self.speaker_encoder = nn.Linear(cfg.face_embedding_dim, 256)
        self.enc_0 = nn.Linear(512, 384)
        self.enc_1 = nn.Linear(384, 256)
        in_ch = 256
        for i, (f, down) in enumerate(BLOCKS):
            self.add_module(f"res_{i}", ResidualBlock(in_ch, f, down))
            in_ch = f
        self.fc = nn.Linear(in_ch, 1)

    def blocks(self) -> list[ResidualBlock]:
        return [getattr(self, f"res_{i}") for i in range(len(BLOCKS))]

    def forward(self, mel: torch.Tensor, speaker_embedding: torch.Tensor, patch,
                return_features: bool = False, keep: tuple | None = None):
        """``patch`` = (start, length); pass the same one for the real and
        the fake mel. ``keep`` = keep masks of the encoded patch (B, P, 256)
        and of the pooled features (B, 1024), applied in train mode only.
        With ``return_features`` also returns the five blocks' outputs,
        (B, C, T') each."""
        P = self.cfg.discriminator_patch
        x = extract_patch(mel, patch[0], patch[1], P)
        h_mel = F.leaky_relu(self.mel_encoder(x), 0.2)
        spk = F.softsign(self.speaker_encoder(speaker_embedding))
        h = torch.cat([h_mel, spk[:, None, :].expand(-1, P, -1)], dim=-1)
        h = F.leaky_relu(self.enc_0(h), 0.2)
        h = F.leaky_relu(self.enc_1(h), 0.2)
        if self.training and keep is not None:
            h = dropout(h, keep[0], 1.0 - FEATURE_KEEP)
        h = h.transpose(1, 2)
        features = []
        for block in self.blocks():
            h = block(h)
            features.append(h)
        pooled = h.mean(dim=-1)  # adaptive average pool over time
        if self.training and keep is not None:
            pooled = dropout(pooled, keep[1], 1.0 - POOLED_KEEP)
        out = self.fc(pooled)[:, 0]
        return (out, features) if return_features else out
