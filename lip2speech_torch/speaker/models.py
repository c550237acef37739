"""Speaker-encoder pretraining models (PyTorch).

Counterpart of ``lip2speech_tpu/speaker/models.py:23-93``. The trainable
face net (``models/face.py``, ``FaceRecognizer``) and the frozen voice
encoder (``models/speaker.py``, ``SpeakerEncoder``) are the main model's
classes. ``SpeakerDecoder`` maps an embedding to a 40-mel sequence and
``FaceDecoder`` to a 160x160 face. The convolutions run NCHW inside;
``FaceDecoder`` takes and returns the JAX layouts: (B, 256) in, (B, 160,
160, 3) out.

Parameter names follow the flax modules (``lstm``, ``linear``, ``pw``,
``pw_bn``, ``dw``, ...); flax's unnamed ``ConvBlock_i`` and ``Conv_i`` are
``blocks.i`` and ``up.i`` here (``weights.speaker_training_from_flax``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.face import FaceRecognizer
from lip2speech_torch.models.layers import BatchNorm2d, dropout
from lip2speech_torch.models.speaker import SpeakerEncoder

SEED_RES, SEED_CHANNELS = 5, 512
DECODER_DROPOUT = 0.3  # the keep probability is 0.7
FACE_SIZE = 160


class SpeakerDecoder(nn.Module):
    """(B, 256) -> (B, 201, 40): a 3-layer LSTM over the embedding repeated
    201 times, then a Linear to 40 mel bins."""

    SEQ_LEN = 201

    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(256, 256, num_layers=3, batch_first=True)
        self.linear = nn.Linear(256, 40)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(x[:, None, :].expand(-1, self.SEQ_LEN, -1).contiguous())
        return self.linear(out)


class ConvBlock(nn.Module):
    """Inverted-bottleneck residual block: a 1x1 conv to ``in_c * exp_r``
    channels, BatchNorm, ReLU; a 3x3 conv to ``out_chns`` in ``out_chns``
    groups when they divide the widened channels (else one group),
    BatchNorm, ReLU; plus a 1x1 shortcut of the input."""

    def __init__(self, in_c: int, out_chns: int, exp_r: int = 6):
        super().__init__()
        mid = in_c * exp_r
        self.pw = nn.Conv2d(in_c, mid, 1)
        self.pw_bn = BatchNorm2d(mid)
        self.dw = nn.Conv2d(mid, out_chns, 3, padding=1,
                            groups=out_chns if mid % out_chns == 0 else 1)
        self.dw_bn = BatchNorm2d(out_chns)
        self.shortcut = nn.Conv2d(in_c, out_chns, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.pw_bn(self.pw(x)))
        h = F.relu(self.dw_bn(self.dw(h)))
        return h + self.shortcut(x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling with half-pixel centres, the edges clamped:
    ``jax.image.resize(..., "bilinear")`` at twice the size."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False,
                         antialias=False)


class FaceDecoder(nn.Module):
    """(B, 256) identity embedding -> (B, 160, 160, 3) face: a Dense to a
    5x5x512 seed, four ConvBlock + 2x bilinear upsampling + 3x3 conv stages,
    a 1x1 conv to RGB and a bilinear resize to 160. In train mode the seed
    takes dropout with ``keep`` (B, 12800) when it is given."""

    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(256, SEED_RES * SEED_RES * SEED_CHANNELS)
        chans = [(SEED_CHANNELS, 256), (256, 128), (128, 64), (64, 64)]
        self.blocks = nn.ModuleList([ConvBlock(i, o) for i, o in chans])
        self.up = nn.ModuleList([nn.Conv2d(o, o, 3, padding=1) for _, o in chans])
        self.to_rgb = nn.Conv2d(64, 3, 1)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        h = self.linear(x)
        if self.training and keep is not None:
            h = dropout(h, keep, DECODER_DROPOUT)
        h = h.view(-1, SEED_RES, SEED_RES, SEED_CHANNELS).permute(0, 3, 1, 2)
        for block, conv in zip(self.blocks, self.up):
            h = conv(upsample2x(block(h)))
        h = self.to_rgb(h)
        h = F.interpolate(h, size=(FACE_SIZE, FACE_SIZE), mode="bilinear", align_corners=False,
                          antialias=False)
        return h.permute(0, 2, 3, 1)


def get_network(cfg: ModelConfig) -> tuple[FaceRecognizer, SpeakerEncoder]:
    """The trainable face net and the frozen voice encoder."""
    return FaceRecognizer(), SpeakerEncoder(cfg)
