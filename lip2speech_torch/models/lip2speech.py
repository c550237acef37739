"""Top-level Lip2Speech model (PyTorch).

Counterpart of ``lip2speech_tpu/models/lip2speech.py``: mouth-ROI video ->
``encoder`` features; the first face crop -> ``vgg_face`` identity embedding
(ReLU, then L2 norm); features + tiled embedding -> ``decoder``. Layouts at
the API edge match the JAX package: video ``(B, T, H, W, 3)``, faces
``(B, n_crops, Hf, Wf, 3)``, mels ``(B, n_mels, M)``. An external
``speaker_embedding`` replaces the face net; a model built with
``face_net=False`` has none, and loads a state dict without ``vgg_face.*``.

Without ``mels`` the forward is free-running inference under
``torch.no_grad()``. With ``mels`` it is the teacher-forced forward with
autograd; in train mode the encoder's BatchNorms train, encoder features
get dropout (``lip2speech.py:59-62``), and the decoder trains. The face
net always runs in eval mode under ``torch.no_grad()``: it gets no
gradient and no BatchNorm update (``lip2speech.py:64-72``).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.decoder import Decoder
from lip2speech_torch.models.face import FaceRecognizer
from lip2speech_torch.models.layers import dropout, keep_mask
from lip2speech_torch.models.video import VideoExtractor
from lip2speech_torch.utils import trace


class Lip2Speech(nn.Module):
    def __init__(self, cfg: ModelConfig, face_net: bool = True):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoExtractor(cfg.frontend_channels, cfg.shufflenet_width)
        self.vgg_face = FaceRecognizer() if face_net else None
        self.decoder = Decoder(cfg)
        self.eval()

    def train(self, mode: bool = True):
        """Sets the encoder and decoder's mode; the face net stays in eval
        mode, since it never trains."""
        super().train(mode)
        if self.vgg_face is not None:
            self.vgg_face.eval()
        return self

    def forward(self, video: torch.Tensor, faces: torch.Tensor | None = None,
                speaker_embedding: torch.Tensor | None = None,
                gumbel: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                mels: torch.Tensor | None = None, tf_ratio=1.0,
                draws: dict | None = None) -> dict:
        """Free-running inference without ``mels``, the teacher-forced
        forward with them. ``draws`` holds random draws by name: the
        decoder's (``Decoder.forward``) and ``encoder``, the keep mask of
        the encoder features (B, T, C_video); ``gumbel`` is the content
        codebook's noise (B*S, vocab). A draw that is absent comes from
        ``generator``."""
        with trace.span("model.forward"), torch.no_grad() if mels is None else contextlib.nullcontext():
            feats = self.encoder(video)
            rate = self.cfg.encoder_feature_dropout
            if mels is not None and self.training and rate > 0.0:
                keep = (draws or {}).get("encoder")
                keep = keep_mask(feats.shape, rate, generator, feats.device) if keep is None else keep
                feats = dropout(feats, keep.to(feats.device), rate)
            if speaker_embedding is None:
                if self.vgg_face is None:
                    raise ValueError("a model without the face net needs a speaker_embedding")
                with trace.span("model.face_net"), torch.no_grad():
                    speaker_embedding = self.vgg_face.inference(faces[:, 0].permute(0, 3, 1, 2))
            T = feats.shape[1]
            visual = torch.cat([feats, speaker_embedding[:, None, :].expand(-1, T, -1)], dim=-1)
            out = self.decoder(visual, speaker_embedding, gumbel, generator, mels=mels,
                               tf_ratio=tf_ratio, draws=draws)
        out["speaker_embedding"] = speaker_embedding
        return out


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every weight from ``generator``: matrices and conv kernels
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases 0, BatchNorm statistics
    (0, 1), the codebook U(0, 1), BOS N(0, 1); per-channel scales and the
    temperatures keep their constructor values."""
    for name, t in model.state_dict(keep_vars=True).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean" or leaf.startswith("bias"):
            t.zero_()
        elif leaf == "running_var":
            t.fill_(1.0)
        elif leaf == "word_embeddings":
            t.copy_(torch.rand(t.shape, generator=generator))
        elif leaf == "BOS":
            t.copy_(torch.randn(t.shape, generator=generator))
        elif t.ndim >= 2:
            bound = 1.0 / math.sqrt(t[0].numel())
            t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)
    return model


def get_network(cfg: ModelConfig) -> Lip2Speech:
    """The lip-to-speech network for ``cfg`` (``model.get_network`` of the
    reference, ``lip2speech_tpu/models/lip2speech.py:93-96``): a
    ``Lip2Speech`` with the face net, in eval mode."""
    return Lip2Speech(cfg)
