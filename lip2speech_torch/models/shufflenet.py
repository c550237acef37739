"""ShuffleNetV2 feature trunk (PyTorch, NCHW, reference names).

Counterpart of ``lip2speech_tpu/models/shufflenet.py``: the ``features``
stages + ``conv_last`` + global average pool. Module layout follows the
reference ``shufflenetv2.py`` (``banch1`` / ``banch2`` sequences), so
``trunk.0.{i}.banch2.0.weight`` names the same tensor in both. The channel
shuffle is the reference's reshape/transpose.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_torch.models.layers import BatchNorm2d
from lip2speech_torch.parallel import tensor

STAGE_REPEATS = (4, 8, 4)

# width multiplier -> per-stage output channels; the last entry is conv_last
WIDTH_CHANNELS = {
    0.5: (24, 48, 96, 192, 768),
    1.0: (24, 116, 232, 464, 768),
    1.5: (24, 176, 352, 704, 768),
    2.0: (24, 244, 488, 976, 2048),
}


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Reference-layout shuffle of (B, C, H, W): out[:, i*g + j] = in[:, j*C/g + i]."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _conv_bn(cin, cout, k, stride=1, groups=1, conv=nn.Conv2d):
    return [conv(cin, cout, k, stride, k // 2, groups=groups, bias=False), BatchNorm2d(cout)]


class InvertedResidual(nn.Module):
    """ShuffleNetV2 unit; ``downsample`` is the stride-2 variant with the
    extra depthwise branch."""

    def __init__(self, in_c: int, out_c: int, downsample: bool):
        super().__init__()
        half = out_c // 2
        stride = 2 if downsample else 1
        self.downsample = downsample
        b2_in = in_c if downsample else half
        if downsample:
            self.banch1 = nn.Sequential(
                *_conv_bn(in_c, in_c, 3, stride, groups=in_c),
                *_conv_bn(in_c, half, 1), nn.ReLU(inplace=True),
            )
        self.banch2 = nn.Sequential(
            *_conv_bn(b2_in, half, 1), nn.ReLU(inplace=True),
            *_conv_bn(half, half, 3, stride, groups=half),
            *_conv_bn(half, half, 1), nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.downsample:
            out = torch.cat([self.banch1(x), self.banch2(x)], dim=1)
        else:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.banch2(x[:, half:])], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2Trunk(nn.Sequential):
    """(N, 24, H, W) -> (N, C_out): ``0`` = stages, ``1`` = conv_last, which
    is column-parallel under tensor parallelism (``parallel.tensor``)."""

    def __init__(self, width_mult: float = 1.0):
        chans = WIDTH_CHANNELS[width_mult]
        units = []
        in_c = chans[0]
        for stage_idx, repeats in enumerate(STAGE_REPEATS):
            out_c = chans[stage_idx + 1]
            for i in range(repeats):
                units.append(InvertedResidual(in_c, out_c, downsample=(i == 0)))
                in_c = out_c
        super().__init__(
            nn.Sequential(*units),
            nn.Sequential(*_conv_bn(in_c, chans[-1], 1, conv=tensor.Conv2d),
                          nn.ReLU(inplace=True)),
        )

    def forward(self, x):
        return super().forward(x).mean(dim=(2, 3))
