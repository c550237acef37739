"""Face-identity encoder: InceptionResnetV1 + projection head (PyTorch).

Counterpart of ``lip2speech_tpu/models/face.py``, with facenet-pytorch's
module names (conv2d_1a ... last_bn), so reference checkpoints map 1:1.
BatchNorm eps is 1e-3 as in facenet. Padding is VALID unless noted, the
Mixed6a/Mixed7a max-pools included. Input is NCHW here; ``Lip2Speech``
transposes the channels-last crops.

In ``Lip2Speech`` the face net is frozen and runs in eval mode. Speaker
pretraining (``speaker/train_loop.py``) trains it, as the JAX module does
with ``train=True``: its BatchNorms train by flax's rule
(``layers.BatchNorm2d/1d``, the new statistics left in ``new_stats``), and
the pooled 1792-d features get dropout at rate 0.6 from a keep mask the
caller hands in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.models.layers import BatchNorm1d, BatchNorm2d, dropout

DROPOUT_RATE = 0.6


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Block35(nn.Module):
    """Inception-A residual block at 256 channels, scale 0.17."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, padding=1),
                                     BasicConv2d(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], dim=1)
        return F.relu(x + self.scale * self.conv2d(up))


class Block17(nn.Module):
    """Inception-B residual block at 896 channels, scale 0.10."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(BasicConv2d(896, 128, 1),
                                     BasicConv2d(128, 128, (1, 7), padding=(0, 3)),
                                     BasicConv2d(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        return F.relu(x + self.scale * self.conv2d(up))


class Block8(nn.Module):
    """Inception-C residual block at 1792 channels, scale 0.20."""

    def __init__(self, scale: float = 0.20, no_relu: bool = False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(1792, 192, 1),
                                     BasicConv2d(192, 192, (1, 3), padding=(0, 1)),
                                     BasicConv2d(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        out = x + self.scale * self.conv2d(up)
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1), BasicConv2d(192, 192, 3, padding=1),
                                     BasicConv2d(192, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), F.max_pool2d(x, 3, 2)], dim=1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 256, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(nn.Module):
    """(B, 3, H, W) -> (B, 512) raw embedding. In train mode the pooled
    features take dropout with ``keep`` (B, 1792), which must be given."""

    def __init__(self):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35() for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block17() for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block8() for _ in range(5)])
        self.block8 = Block8(no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = BatchNorm1d(512, eps=1e-3)

    def forward(self, x, keep: torch.Tensor | None = None):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x))))
        x = self.block8(self.repeat_3(x)).mean(dim=(2, 3))
        if self.training:
            if keep is None:
                raise ValueError("the face net in train mode needs its dropout keep mask")
            x = dropout(x, keep, DROPOUT_RATE)
        return self.last_bn(self.last_linear(x))


class FaceRecognizer(nn.Module):
    """Backbone + 512 -> GELU(exact) -> 256 projection (vgg_face.py:22-50)."""

    def __init__(self):
        super().__init__()
        self.resnet = InceptionResnetV1()
        self.projection_layer = nn.Sequential(nn.Linear(512, 512), nn.GELU(), nn.Linear(512, 256))

    def forward(self, x, keep: torch.Tensor | None = None):
        """(B, 3, H, W) -> (B, 256); ``keep`` is the train-mode dropout mask
        of ``InceptionResnetV1``."""
        return self.projection_layer(self.resnet(x, keep))

    def inference(self, x):
        """ReLU, then L2 normalisation (vgg_face.py:52-60)."""
        emb = F.relu(self(x))
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
