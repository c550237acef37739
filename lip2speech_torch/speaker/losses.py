"""Speaker-encoder pretraining losses (PyTorch).

Counterpart of ``lip2speech_tpu/speaker/losses.py:22-60``:

- ``contrastive_loss``: the symmetric cross-entropy over ``face @
  speech.T * t`` with the temperature ``t`` clamped at 100, and the mean
  square between the ReLU'd, L2-normalised embeddings (norm floor 1e-12);
- ``reconstruction_loss``: 10x the mean square error;
- ``gram_matrix`` and ``style_loss``: the VGG-style gram criterion, which
  the training step does not use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def contrastive_loss(speech_embeddings: torch.Tensor, face_embeddings: torch.Tensor,
                     temperature: torch.Tensor) -> dict[str, torch.Tensor]:
    """``l2_loss`` and ``c_loss`` of a batch of paired embeddings (B, D)."""
    t = torch.clamp(temperature, max=100.0)
    l2 = torch.mean(torch.square(_norm(F.relu(face_embeddings)) - _norm(F.relu(speech_embeddings))))
    logits = face_embeddings @ speech_embeddings.T * t
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0
    return {"l2_loss": l2, "c_loss": ce}


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor) -> dict[str, torch.Tensor]:
    return {"rec_loss": 10.0 * torch.mean(torch.square(pred - target))}


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B, N, N) outer products of the flattened features over N."""
    f = feats.reshape(feats.shape[0], -1)
    return (f[:, :, None] @ f[:, None, :]) / f.shape[-1]


def style_loss(pred_feats: torch.Tensor, target_feats: torch.Tensor) -> torch.Tensor:
    """Mean square between the gram matrices; the target's carries no gradient."""
    return torch.mean(torch.square(gram_matrix(pred_feats) - gram_matrix(target_feats).detach()))
