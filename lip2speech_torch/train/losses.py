"""Training losses (PyTorch).

Counterpart of ``lip2speech_loss`` in ``lip2speech_tpu/train/losses.py:25-67``:
mel MSE + weighted postnet MSE + mean gate BCE-with-logits + the KLD of the
content codebook's distribution against uniform; and the WGAN pair of
``losses.py:70-112``: the generator's loss with L1 feature matching, the
critic's loss, the critic's weight clamp and the gradient penalty.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def lip2speech_loss(outputs: dict, mel_target: torch.Tensor, gate_target: torch.Tensor,
                    postnet_weight: float = 10.0, mel_mask: torch.Tensor | None = None,
                    kld_weight: float = 1.0) -> dict[str, torch.Tensor]:
    """``outputs`` of the teacher-forced forward (f32), ``mel_target
    (B, n_mels, M)``, ``gate_target (B, M)`` and, for the masked loss,
    ``mel_mask (B, M)`` (True on valid frames) -> the loss dict. The
    logged KLD is unweighted; ``kld_weight`` scales it in the total only."""
    mel_target = mel_target.detach()
    gate_target = gate_target.detach()

    def mse(pred, tgt):
        err = torch.square(pred - tgt)
        if mel_mask is not None:
            m = mel_mask[:, None, :].to(err.dtype)
            return torch.sum(err * m) / torch.clamp(torch.sum(m) * pred.shape[1], min=1)
        return torch.mean(err)

    losses = {"mel_loss": mse(outputs["mel"], mel_target)}
    losses["postnet_mel_loss"] = postnet_weight * mse(outputs["mel_postnet"], mel_target)
    logits = outputs["gate"][..., 0]
    # optax.sigmoid_binary_cross_entropy
    bce = -gate_target * F.logsigmoid(logits) - (1.0 - gate_target) * F.logsigmoid(-logits)
    losses["gate_loss"] = torch.mean(bce)
    qy = outputs["content_dist"]
    k = qy.shape[-1]
    losses["KLD"] = torch.mean(torch.sum(qy * torch.log(qy * k + 1e-20), dim=-1))
    losses["total"] = (losses["mel_loss"] + losses["postnet_mel_loss"] + losses["gate_loss"]
                       + kld_weight * losses["KLD"])
    return losses


def generator_loss(fake_pred: torch.Tensor, fake_features: list[torch.Tensor],
                   real_features: list[torch.Tensor], fm_weight: float = 10.0) -> dict:
    """WGAN generator loss ``-mean(D(fake))`` and ``fm_weight`` times the sum
    over the critic's features of the mean |fake - real| (the real features
    take no gradient)."""
    fm = sum(torch.mean(torch.abs(f - r.detach())) for f, r in zip(fake_features, real_features))
    return {"g_loss": -torch.mean(fake_pred), "g_d_fm_loss": fm_weight * fm}


def discriminator_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """WGAN critic loss ``-mean(D(real)) + mean(D(fake))``."""
    return -torch.mean(real_pred) + torch.mean(fake_pred)


@torch.no_grad()
def clamp_discriminator_params(critic: torch.nn.Module, clip: float = 0.01) -> torch.nn.Module:
    """Every parameter of ``critic`` (BatchNorm scales and biases too; not the
    running statistics) clamped to [-clip, clip], in place."""
    for p in critic.parameters():
        p.clamp_(-clip, clip)
    return critic


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: ``mean((|grad D(x)| - 1)^2)`` at ``x = alpha * real + (1 -
    alpha) * fake``; ``alpha (B, 1, 1)`` is the uniform draw, ``critic_fn``
    maps mels to the critic's (B,) logits (eval mode). The penalty keeps its
    graph, so it can be differentiated again."""
    interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads.reshape(real.shape[0], -1)), -1) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))
