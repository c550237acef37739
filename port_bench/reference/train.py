"""The plain reference of one training step, in plain PyTorch.

From a host batch as a loader hands it over (uint8 mouth frames and face
crops, raw audio, their lengths): the model-ready batch (ImageNet and
facenet normalisation, padded frames zeroed, the log-mel target padded
with ``mel_pad_value``, the gate target), the train-mode teacher-forced
forward, the loss (mel MSE + weighted postnet MSE + gate BCE + KLD of the
codebook against uniform), the gradients of the trainable parameters
(``encoder.*`` and ``decoder.*``; the face net is frozen; an LSTM trains one
bias, ``bias_ih``), and the guarded AMSGrad update (a step with a
non-finite gradient is skipped; clip by the global norm; optax's AMSGrad
with bias-corrected moments; weight decay; times -learning_rate), which
keeps the new BatchNorm statistics when the step is taken.

This file imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from port_bench.reference import dsp
from port_bench.reference.model import Ctx, Lip2SpeechReference

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
B1, B2, EPS = 0.9, 0.999, 1e-8


def normalize_mouth(u8):
    mean = torch.tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.tensor(IMAGENET_STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def normalize_face(u8):
    return (u8.float() - 127.5) / 128.0


def prepare(raw: dict, conf: dict) -> dict:
    """Host tensors (mouth_u8, faces_u8, audio, video_lengths,
    audio_lengths) on their device -> video, faces, mel, gate."""
    a, d = conf["audio"], conf["data"]
    video = normalize_mouth(raw["mouth_u8"])
    frames = torch.arange(video.shape[1], device=video.device)
    video = video * (frames[None] < raw["video_lengths"][:, None])[:, :, None, None, None]
    mel = dsp.melspectrogram(raw["audio"], a)
    mel_len = 1 + raw["audio_lengths"].long() // a["hop_length"]
    steps = torch.arange(mel.shape[-1], device=mel.device)[None]
    mel = torch.where((steps < mel_len[:, None])[:, None], mel, d["mel_pad_value"])
    gate = (steps >= (mel_len - 1)[:, None]).float()
    return {"video": video, "faces": normalize_face(raw["faces_u8"]), "mel": mel, "gate": gate}


def loss_terms(out: dict, mel, gate, t: dict) -> dict:
    losses = {"mel_loss": torch.mean(torch.square(out["mel"] - mel))}
    losses["postnet_mel_loss"] = t["postnet_loss_weight"] * torch.mean(torch.square(out["mel_postnet"] - mel))
    logits = out["gate"][..., 0]
    losses["gate_loss"] = torch.mean(-gate * F.logsigmoid(logits) - (1 - gate) * F.logsigmoid(-logits))
    qy = out["content_dist"]
    losses["KLD"] = torch.mean(torch.sum(qy * torch.log(qy * qy.shape[-1] + 1e-20), -1))
    losses["total"] = (losses["mel_loss"] + losses["postnet_mel_loss"] + losses["gate_loss"]
                       + t["kld_weight"] * losses["KLD"])
    return losses


def optimised(model: Lip2SpeechReference) -> list[tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters()
            if n.split(".", 1)[0] in ("encoder", "decoder") and ".bias_hh_" not in n]


class AMSGrad:
    def __init__(self, params: list, t: dict):
        self.t = t
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.nu_max = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Returns whether the step was taken."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            return False
        if norm >= self.t["grad_clip"]:
            grads = [g / norm * self.t["grad_clip"] for g in grads]
        self.count += 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - B1) * g + B1 * self.mu[i]
            self.nu[i] = (1 - B2) * g * g + B2 * self.nu[i]
            self.nu_max[i] = torch.maximum(self.nu_max[i], self.nu[i] / (1 - B2 ** self.count))
            mu_hat = self.mu[i] / (1 - B1 ** self.count)
            p.add_((mu_hat / (torch.sqrt(self.nu_max[i]) + EPS) + self.t["weight_decay"] * p)
                   * -self.t["learning_rate"])
        return True


def gradients(model: Lip2SpeechReference, batch: dict, draws: dict, conf: dict, tf_ratio: float,
              ctx: Ctx, mode=None) -> tuple[dict, list]:
    """The train-mode forward under ``mode`` (a function mode, or none; the
    loss is taken outside it, in f32 against the f32 targets, as the
    program's bf16 policy takes it) and the raw gradients of the trainable
    parameters, in ``optimised`` order: (the losses, the gradients)."""
    with mode or contextlib.nullcontext():
        out = model.teacher_forced(ctx, batch["video"], batch["faces"], batch["mel"], tf_ratio, draws)
    losses = loss_terms(out, batch["mel"], batch["gate"], conf["train"])
    params = [p for _, p in optimised(model)]
    return losses, list(torch.autograd.grad(losses["total"], params, allow_unused=True))


def train_step(model: Lip2SpeechReference, opt: AMSGrad, batch: dict, draws: dict, conf: dict,
               tf_ratio: float, q=None, mode=None) -> dict:
    """One step in place (``gradients``, the update, the new statistics
    kept when it is taken). Returns the losses (floats), whether the step
    was taken, and the raw gradients by name."""
    ctx = Ctx(train=True) if q is None else Ctx(train=True, q=q)
    losses, grads = gradients(model, batch, draws, conf, tf_ratio, ctx, mode)
    names = [n for n, _ in optimised(model)]
    taken = opt.step(grads)
    buffers = dict(model.named_buffers())
    if taken and all(bool(torch.isfinite(v).all()) for v in ctx.stats.values()):
        with torch.no_grad():
            for k, v in ctx.stats.items():
                buffers[k].copy_(v)
    return {"losses": {k: float(v.detach()) for k, v in losses.items()}, "taken": taken,
            "grads": dict(zip(names, grads))}
