"""Training losses (PyTorch).

Counterpart of ``lip2speech_loss`` in ``lip2speech_tpu/train/losses.py:25-67``:
mel MSE + weighted postnet MSE + mean gate BCE-with-logits + the KLD of the
content codebook's distribution against uniform. The adversarial pair of
that module is not ported yet.
"""

from __future__ import annotations

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
