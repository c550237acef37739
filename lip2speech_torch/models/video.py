"""Lip (mouth-ROI) video encoder: 3D conv front end + ShuffleNetV2 trunk.

Counterpart of ``lip2speech_tpu/models/video.py``. The front end is the
reference's ``nn.Conv3d(3, 24, (5, 7, 7), stride (1, 2, 2), padding
(2, 3, 3))`` on cuDNN, then BN, PReLU and a (1, 3, 3) max-pool that never
pools over time; the trunk runs per frame on ``(B*T, C, H, W)``. Output is
``(B, T, C_video)``, L2-normalised per frame (reference video.py:85). In
train mode its BatchNorms train by flax's rule (``layers.BatchNorm3d``,
``layers.BatchNorm2d``); the Conv3d on cuDNN computes the same function as
the JAX package's time-tap fold, gradients included. Under tensor
parallelism the trunk's ``conv_last`` is column-parallel
(``parallel.tensor``).
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_torch.models.layers import BatchNorm3d
from lip2speech_torch.models.shufflenet import WIDTH_CHANNELS, ShuffleNetV2Trunk


class VideoExtractor(nn.Module):
    """(B, T, H, W, 3) channels-last video -> (B, T, C_video)."""

    def __init__(self, frontend_channels: int = 24, width_mult: float = 1.0):
        super().__init__()
        c = frontend_channels
        self.frontend3D = nn.Sequential(
            nn.Conv3d(3, c, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3), bias=False),
            BatchNorm3d(c),
            nn.PReLU(c),
            nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)),
        )
        self.trunk = ShuffleNetV2Trunk(width_mult)
        self.output_dim = WIDTH_CHANNELS[width_mult][-1]

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        B, T = video.shape[:2]
        x = self.frontend3D(video.permute(0, 4, 1, 2, 3))  # (B, C, T, H', W')
        C, Hp, Wp = x.shape[1], x.shape[3], x.shape[4]
        x = x.transpose(1, 2).reshape(B * T, C, Hp, Wp)
        feats = self.trunk(x).reshape(B, T, -1)
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats / torch.clamp(norm, min=1e-12)
