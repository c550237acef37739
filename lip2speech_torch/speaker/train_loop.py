"""Speaker-encoder pretraining: one step over three parameter groups (PyTorch).

Counterpart of ``lip2speech_tpu/speaker/train_loop.py:28-144``. The frozen
voice encoder (``models/speaker.py``) embeds the speech; the face net
(``models/face.py``) trains in train mode and is pulled toward the voice
embedding by the contrastive loss, whose temperature ``t`` is learned; a
``FaceDecoder`` reconstructs the face from the face embedding (detached) or
the voice embedding, one or the other by a fair coin each step, under a 10x
mean square. The loss is ``c_loss + l2_loss + rec_loss``.

The optimizers are optax's, written out over flat f32 vectors as in
``train/optim.py``:

- the face net: ``clip_by_global_norm(10)`` over its gradients,
  ``add_decayed_weights(1e-5)`` on every face parameter, then SGD with
  momentum 0.9 (optax ``trace``: the first momentum is the gradient) at
  ``cosine_decay_schedule(1e-3, steps_per_epoch * 100)``, counted in
  updates;
- the face decoder: Adam(1e-3);
- ``t``: an Adam(1e-3) of its own, then ``t`` clamped at 100.

The BatchNorm statistics of the face net and the decoder are replaced by
the step's, as JAX replaces its ``batch_stats``. Every random draw is an
input (``draws``): ``use_face`` (0-d bool), ``face`` the face net's keep
mask (B, 1792) and ``decoder`` the decoder's (B, 12800); the ones not
given come from a generator seeded by (seed, step).

Under data parallelism (``dp``, ``parallel/dist.py``) each rank runs the
step on its rows of the global batch: the keep masks are drawn at the
global shape and cut to its rows (``use_face`` is one draw for all); the
BatchNorm moments cover the global batch; the contrastive loss is formed on
the embeddings of every rank (``all_gather_rows``), as JAX forms it over
the global batch; each loss is the rank's share; and the three groups'
gradients are summed over the ranks in one vector, in their own type.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from lip2speech_torch.config import Config
from lip2speech_torch.models.face import DROPOUT_RATE, FaceRecognizer
from lip2speech_torch.models.layers import data_parallel, keep_mask
from lip2speech_torch.models.lip2speech import init_random_
from lip2speech_torch.models.speaker import SpeakerEncoder
from lip2speech_torch.ops.image import normalize_face
from lip2speech_torch.parallel.dist import DataParallel, all_gather_rows, all_reduce_, uniform
from lip2speech_torch.speaker.losses import contrastive_loss, reconstruction_loss
from lip2speech_torch.speaker.models import (DECODER_DROPOUT, SEED_CHANNELS, SEED_RES,
                                             FaceDecoder)
from lip2speech_torch.train.losses import global_losses, share
from lip2speech_torch.train.train_step import batch_norms, step_draws

FACE_CLIP, FACE_DECAY, FACE_MOMENTUM, FACE_LR = 10.0, 1e-5, 0.9, 1e-3
ADAM_LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
T_MAX = 100.0
GROUPS = ("face", "decoder", "t")


class SpeakerTraining(nn.Module):
    """What speaker pretraining holds: the trained ``face`` net, ``decoder``
    and temperature ``t``, and the frozen voice ``speaker`` encoder. The
    face net is ``FaceRecognizer`` unless another module with its call
    signature, ``(faces NCHW, keep) -> (B, 256)``, is given (the JAX step
    takes its models as an argument too)."""

    def __init__(self, cfg: Config, face_net: nn.Module | None = None):
        super().__init__()
        self.face = FaceRecognizer() if face_net is None else face_net
        self.decoder = FaceDecoder()
        self.t = nn.Parameter(torch.tensor(1.0))
        self.speaker = SpeakerEncoder(cfg.model).requires_grad_(False)

    def group(self, name: str) -> list[nn.Parameter]:
        """The parameters of ``face``, ``decoder`` or ``t``."""
        return [self.t] if name == "t" else list(getattr(self, name).parameters())


def init_speaker_training(cfg: Config, generator: torch.Generator) -> SpeakerTraining:
    """Random weights from ``generator`` (``lip2speech.init_random_``), ``t``
    at 1."""
    return init_random_(SpeakerTraining(cfg), generator)


def _flat(tensors) -> torch.Tensor:
    """A list of tensors as one f32 vector (a vector as it is)."""
    if torch.is_tensor(tensors):
        return tensors
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _add_(params, flat: torch.Tensor):
    """Each parameter += its slice of ``flat``, in place."""
    torch._foreach_add_(params, [x.view_as(p) for x, p in
                                 zip(flat.split([p.numel() for p in params]), params)])


class Adam:
    """optax ``adam(lr)`` (``scale_by_adam`` then ``-lr``) over ``params``."""

    def __init__(self, params, lr: float = ADAM_LR):
        self.params, self.lr = list(params), lr
        dev = self.params[0].device
        size = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(size, device=dev)
        self.nu = torch.zeros(size, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def update(self, g: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * (g * g) + B2 * self.nu
        self.count = self.count + 1
        c = self.count.float()
        mu_hat = self.mu / (1 - torch.pow(torch.tensor(B1, device=g.device), c))
        nu_hat = self.nu / (1 - torch.pow(torch.tensor(B2, device=g.device), c))
        return -self.lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict):
        for k in ("mu", "nu", "count"):
            setattr(self, k, state[k].to(getattr(self, k).device).clone())


class FaceSGD:
    """The face net's chain: clip by global norm, decoupled weight decay,
    momentum 0.9 at the cosine-decayed learning rate."""

    def __init__(self, params, decay_steps: int):
        self.params, self.decay_steps = list(params), float(decay_steps)
        dev = self.params[0].device
        self.trace = torch.zeros(sum(p.numel() for p in self.params), device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def learning_rate(self) -> torch.Tensor:
        """``cosine_decay_schedule(1e-3, decay_steps)`` at this update."""
        c = torch.clamp(self.count.float(), max=self.decay_steps)
        return FACE_LR * (0.5 * (1 + torch.cos(math.pi * c / self.decay_steps)))

    def update(self, g: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
        g = torch.where(norm < FACE_CLIP, g, g / norm * FACE_CLIP)
        g = g + FACE_DECAY * _flat(self.params)
        self.trace = g + FACE_MOMENTUM * self.trace
        u = -self.learning_rate() * self.trace
        self.count = self.count + 1
        return u

    def state_dict(self) -> dict:
        return {"trace": self.trace, "count": self.count}

    def load_state_dict(self, state: dict):
        for k in ("trace", "count"):
            setattr(self, k, state[k].to(getattr(self, k).device).clone())


class SpeakerOptimizer:
    """``make_speaker_optimizer``'s three transforms over ``model``'s groups."""

    def __init__(self, model: SpeakerTraining, steps_per_epoch: int, max_epochs: int = 100):
        self.face = FaceSGD(model.group("face"), steps_per_epoch * max_epochs)
        self.decoder = Adam(model.group("decoder"))
        self.t = Adam(model.group("t"))

    @torch.no_grad()
    def step(self, grads: dict) -> torch.Tensor:
        """One update from the gradients of each group (lists in the
        groups' order, or flat vectors), in place; ``t`` is clamped at 100
        after it. Returns the face gradients' global norm before the
        clip."""
        g_face = _flat(grads["face"])
        norm = torch.sqrt(torch.sum(g_face * g_face))
        _add_(self.face.params, self.face.update(g_face, norm))
        for name in ("decoder", "t"):
            opt = getattr(self, name)
            _add_(opt.params, opt.update(_flat(grads[name])))
        self.t.params[0].clamp_(max=T_MAX)
        return norm

    def state_dict(self) -> dict:
        return {name: getattr(self, name).state_dict() for name in GROUPS}

    def load_state_dict(self, state: dict):
        for name in GROUPS:
            getattr(self, name).load_state_dict(state[name])


@dataclasses.dataclass
class SpeakerTrainState:
    """The counterpart of the JAX ``SpeakerTrainState``: the model (trained
    groups, their BatchNorm statistics and the frozen voice encoder), the
    optimizer and the step; ``train/checkpoint.py`` saves and restores it."""

    model: SpeakerTraining
    opt: SpeakerOptimizer
    step: int = 0


def create_speaker_state(model: SpeakerTraining, steps_per_epoch: int) -> SpeakerTrainState:
    return SpeakerTrainState(model=model, opt=SpeakerOptimizer(model, steps_per_epoch))


def speaker_draws(batch_size: int, generator, device) -> dict:
    """The step's random draws from ``generator`` (a ``torch.Generator`` or
    a rank's ``RowDraws``): ``use_face`` (p=0.5) and the keep masks of the
    face net and the decoder."""
    return {
        "use_face": uniform((), generator, device, batch_dim=None) < 0.5,
        "face": keep_mask((batch_size, 1792), DROPOUT_RATE, generator, device),
        "decoder": keep_mask((batch_size, SEED_RES * SEED_RES * SEED_CHANNELS), DECODER_DROPOUT,
                             generator, device),
    }


def speaker_loss_and_grad(model: SpeakerTraining, batch: dict, draws: dict,
                          dp: DataParallel | None = None):
    """The train-mode forward, the losses and their gradients. ``batch``
    holds ``speech`` (B, S) and ``faces_u8`` (B, H, W, 3). Returns (losses
    by name, the new BatchNorm statistics by buffer name, the gradients of
    each group as lists). Runs in the model's dtype. Under ``dp`` the batch
    is this rank's rows, the losses and statistics are the global batch's
    and the gradients this rank's share."""
    faces = normalize_face(batch["faces_u8"]).to(model.t.dtype)
    with torch.no_grad():
        speech_emb = model.speaker(batch["speech"].to(model.t.dtype))
    norms = batch_norms(model)
    was_training = model.training
    model.train()
    try:
        with data_parallel(model, dp):
            face_emb = model.face(faces.permute(0, 3, 1, 2), draws["face"])
            dec_in = torch.where(draws["use_face"], face_emb.detach(), speech_emb)
            recon = model.decoder(dec_in, draws["decoder"])
    finally:
        model.train(was_training)
    new_stats = {}
    for name, m in norms.items():
        new_stats[f"{name}.running_mean"], new_stats[f"{name}.running_var"] = m.new_stats
        m.new_stats = None
    # the global batch's contrastive loss, taken on every rank: its share
    losses = contrastive_loss(all_gather_rows(speech_emb, dp), all_gather_rows(face_emb, dp),
                              model.t)
    losses = {k: share(v, dp) for k, v in losses.items()}
    losses["rec_loss"] = share(reconstruction_loss(recon, faces)["rec_loss"], dp)
    losses["loss"] = losses["c_loss"] + losses["l2_loss"] + losses["rec_loss"]
    params = [p for name in GROUPS for p in model.group(name)]
    flat = torch.autograd.grad(losses["loss"], params, allow_unused=True)
    flat = [torch.zeros_like(p) if g is None else g for p, g in zip(params, flat)]
    grads, i = {}, 0
    for name in GROUPS:
        n = len(model.group(name))
        grads[name], i = flat[i: i + n], i + n
    return global_losses(losses, dp), new_stats, grads


def reduce_group_grads(grads: dict, dp: DataParallel | None) -> dict[str, torch.Tensor]:
    """Each group's gradients as one f32 vector; under ``dp`` summed over
    the ranks in their own type, the three groups in one collective."""
    sizes = [sum(g.numel() for g in grads[name]) for name in GROUPS]
    summed = all_reduce_(torch.cat([g.reshape(-1) for name in GROUPS for g in grads[name]]), dp)
    return dict(zip(GROUPS, summed.float().split(sizes)))


def speaker_train_step(state: SpeakerTrainState, batch: dict, draws: dict | None = None,
                       seed: int = 0, dp: DataParallel | None = None) -> dict[str, torch.Tensor]:
    """One step in place on ``state``; under ``dp`` ``batch`` (and each
    given draw) is this rank's rows of the global batch. Returns the
    metrics as 0-d tensors on the device: the losses, ``grad_norm`` (the
    face gradients' norm before the clip) and the new ``t``."""
    model = state.model
    dev = model.t.device
    draws = dict(draws or {})
    B = batch["speech"].shape[0]
    for k, v in speaker_draws(B, step_draws(seed, state.step, dev, dp, B), dev).items():
        draws.setdefault(k, v)
    losses, new_stats, grads = speaker_loss_and_grad(model, batch, draws, dp)
    grad_norm = state.opt.step(reduce_group_grads(grads, dp))
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in new_stats.items():
            buffers[name].copy_(value)
    state.step += 1
    return {**losses, "grad_norm": grad_norm, "t": model.t.detach().clone()}
