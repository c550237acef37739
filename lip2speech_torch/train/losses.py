"""Training losses (PyTorch).

Counterpart of ``lip2speech_loss`` in ``lip2speech_tpu/train/losses.py:25-67``:
mel MSE + weighted postnet MSE + mean gate BCE-with-logits + the KLD of the
content codebook's distribution against uniform; and the WGAN pair of
``losses.py:70-112``: the generator's loss with L1 feature matching, the
critic's loss, the critic's weight clamp and the gradient penalty.

Under data parallelism (``dp``) every loss is this rank's share of the
global batch's loss, so that the shares sum over the data group to it and
the gradients are summed: a mean over the global batch's rows is the local
rows' sum over the global count. ``global_losses`` sums the shares over the
data group for the logged values, the same on every rank (the ranks of a
model group hold the same rows, so they are not summed).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from lip2speech_torch.parallel.dist import DataParallel, all_reduce_


def share(loss: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from the mean
    over its rows (every data index holds as many rows)."""
    return loss if dp is None else loss / dp.n_data


def global_losses(losses: dict, dp: DataParallel | None) -> dict[str, torch.Tensor]:
    """The losses detached and, under data parallelism, summed over the
    data group in one collective: the global batch's values on every
    rank."""
    out = {k: v.detach() for k, v in losses.items()}
    if dp is None:
        return out
    summed = all_reduce_(torch.stack([v.to(torch.float64) for v in out.values()]), dp)
    return {k: s.to(v.dtype) for (k, v), s in zip(out.items(), summed)}


def lip2speech_loss(outputs: dict, mel_target: torch.Tensor, gate_target: torch.Tensor,
                    postnet_weight: float = 10.0, mel_mask: torch.Tensor | None = None,
                    kld_weight: float = 1.0, dp: DataParallel | None = None
                    ) -> dict[str, torch.Tensor]:
    """``outputs`` of the teacher-forced forward (f32), ``mel_target
    (B, n_mels, M)``, ``gate_target (B, M)`` and, for the masked loss,
    ``mel_mask (B, M)`` (True on valid frames) -> the loss dict. The
    logged KLD is unweighted; ``kld_weight`` scales it in the total only.
    Under data parallelism (``dp``) each value is this rank's share: the
    masked losses divide by the global batch's count of valid frames."""
    mel_target = mel_target.detach()
    gate_target = gate_target.detach()
    if mel_mask is not None:
        mask = mel_mask[:, None, :].to(outputs["mel"].dtype)
        count = all_reduce_(torch.sum(mask).reshape(1), dp)[0]
        count = torch.clamp(count * outputs["mel"].shape[1], min=1)

    def mse(pred, tgt):
        err = torch.square(pred - tgt)
        if mel_mask is not None:
            return torch.sum(err * mask) / count
        return share(torch.mean(err), dp)

    losses = {"mel_loss": mse(outputs["mel"], mel_target)}
    losses["postnet_mel_loss"] = postnet_weight * mse(outputs["mel_postnet"], mel_target)
    logits = outputs["gate"][..., 0]
    # optax.sigmoid_binary_cross_entropy
    bce = -gate_target * F.logsigmoid(logits) - (1.0 - gate_target) * F.logsigmoid(-logits)
    losses["gate_loss"] = share(torch.mean(bce), dp)
    qy = outputs["content_dist"]
    k = qy.shape[-1]
    losses["KLD"] = share(torch.mean(torch.sum(qy * torch.log(qy * k + 1e-20), dim=-1)), dp)
    losses["total"] = (losses["mel_loss"] + losses["postnet_mel_loss"] + losses["gate_loss"]
                       + kld_weight * losses["KLD"])
    return losses


def generator_loss(fake_pred: torch.Tensor, fake_features: list[torch.Tensor],
                   real_features: list[torch.Tensor], fm_weight: float = 10.0,
                   dp: DataParallel | None = None) -> dict:
    """WGAN generator loss ``-mean(D(fake))`` and ``fm_weight`` times the sum
    over the critic's features of the mean |fake - real| (the real features
    take no gradient); this rank's shares under ``dp``."""
    fm = sum(torch.mean(torch.abs(f - r.detach())) for f, r in zip(fake_features, real_features))
    return {"g_loss": share(-torch.mean(fake_pred), dp), "g_d_fm_loss": share(fm_weight * fm, dp)}


def discriminator_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor,
                       dp: DataParallel | None = None) -> torch.Tensor:
    """WGAN critic loss ``-mean(D(real)) + mean(D(fake))``; this rank's
    share under ``dp``."""
    return share(-torch.mean(real_pred) + torch.mean(fake_pred), dp)


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
