"""The WGAN adversarial training mode (PyTorch).

Counterpart of ``lip2speech_tpu/train/adversarial.py:34-265``, switched on by
``--override train.adversarial=true``. One combined step per iteration:

1. the generator's train-mode forward and loss dict, as the plain step
   computes them (``train_step.forward_losses``; bf16 policy, outputs cast
   back to f32, so the critic always runs in f32);
2. ``generator_terms``: the critic in eval mode on one patch of the real
   and the fake mel gives ``g_loss`` (``-mean D(fake)``) and ``g_d_fm_loss``
   (10 x L1 feature matching against the real features, which take no
   gradient); both join ``total`` before the backward, and the gradient
   reaches the generator through the fake mel. The critic's parameters get
   no gradient from them (the backward is taken over the generator's
   trainable parameters only);
3. the guarded AMSGrad update and the BatchNorm guard of the plain step
   (``train_step.apply_update``);
4. ``critic_step`` on the pre-update fake mel and speaker embedding, both
   detached: the critic's train-mode loss ``-mean D(real) + mean D(fake)``
   on another patch, optax's RMSprop, the +-0.01 weight clamp, and its
   BatchNorm statistics from the real pass.

``RMSprop`` is optax 0.2.6's ``rmsprop(lr)``, not ``torch.optim.RMSprop``:
decay 0.9 (torch's alpha is 0.99), eps 1e-8 inside the square root (torch
adds it outside), nu from 0. It keeps nu as one flat f32 vector.

A critic step whose loss or gradient norm is not finite leaves the
critic's parameters, statistics and optimizer state as they were (device
selects, no host sync): a transient non-finite fake mel must not poison
the critic for good (clamping NaN keeps it NaN).

Random draws: the step's two patches are inputs (``draws["patch_g"]``,
``draws["patch_d"]``) or come from the step's generator, seeded by
(seed, step) as in the plain step.

Under data parallelism (``dp``) the critic is replicated as the generator
is: its train-mode BatchNorm moments cover the global batch, its losses are
the rank's shares, and its flat gradient vector is summed over the data
group before RMSprop reads it; the patches have no batch axis and are the
same on every rank. Under tensor parallelism the critic stays replicated,
as JAX's (``lip2speech_tpu/cli/train.py:188``): the ranks of a model group
hold the same rows and compute the same critic step, taking the group's
first rank's gradient and new statistics.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from lip2speech_torch.config import Config
from lip2speech_torch.models.discriminator import Discriminator, sample_patch
from lip2speech_torch.models.layers import FlaxRuleBatchNorm, data_parallel
from lip2speech_torch.models.lip2speech import init_random_
from lip2speech_torch.parallel.dist import (DataParallel, agree_over_model_group_, all_reduce_,
                                            base_generator)
from lip2speech_torch.train.losses import discriminator_loss, generator_loss, global_losses
from lip2speech_torch.train.train_step import (TrainState, apply_update, backward,
                                               forward_losses, step_draws)
from lip2speech_torch.utils import trace

RMS_DECAY, RMS_EPS = 0.9, 1e-8
CRITIC_CLIP = 0.01


class RMSprop:
    """``optax.rmsprop(lr)`` over ``params``: ``nu = 0.9 nu + 0.1 g^2``,
    ``update = -lr * g / sqrt(nu + 1e-8)``."""

    def __init__(self, lr: float, params):
        self.lr = lr
        self.params = list(params)
        self.nu = torch.zeros(sum(p.numel() for p in self.params), device=self.params[0].device)

    def flatten(self, tensors, dtype=torch.float32) -> torch.Tensor:
        """``tensors`` as one vector of ``dtype`` (None: their own)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return flat if dtype is None else flat.to(dtype)

    def update(self, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(the update, the new nu) from the flat gradient ``g``; writes
        nothing."""
        nu = (1 - RMS_DECAY) * torch.square(g) + RMS_DECAY * self.nu
        return -self.lr * (torch.rsqrt(nu + RMS_EPS) * g), nu


@dataclasses.dataclass
class CriticState:
    """The critic (f32 parameters and BatchNorm statistics) and its optimizer."""

    disc: Discriminator
    opt: RMSprop


def init_critic(cfg: Config, generator: torch.Generator, device=None) -> CriticState:
    """A critic with random weights from ``generator`` (``init_random_``'s
    rule), on ``device``, and a fresh RMSprop at ``adversarial_critic_lr``."""
    disc = init_random_(Discriminator(cfg.model), generator).to(device)
    return CriticState(disc, RMSprop(cfg.train.adversarial_critic_lr, disc.parameters()))


@contextlib.contextmanager
def _mode(module: torch.nn.Module, train: bool):
    was = module.training
    module.train(train)
    try:
        yield module
    finally:
        module.train(was)


def critic_step(critic: CriticState, real_mel: torch.Tensor, fake_mel: torch.Tensor,
                speaker: torch.Tensor, patch, dp: DataParallel | None = None) -> torch.Tensor:
    """One WGAN critic update and clamp, in place on ``critic``, on one
    ``patch`` (start, length) of the real and the fake mel. Both passes run
    in train mode from the same running statistics; the new statistics are
    the real pass's. Under ``dp`` the mels are this rank's rows. Returns
    ``d_loss`` (0-d, on the device; the global batch's)."""
    disc = critic.disc
    fake_mel, speaker = fake_mel.detach(), speaker.detach()
    params = critic.opt.params
    norms = [m for m in disc.modules() if isinstance(m, FlaxRuleBatchNorm)]
    with trace.span("adversarial.critic"), _mode(disc, True), data_parallel(disc, dp):
        real_pred = disc(real_mel.detach(), speaker, patch)
        new_stats = [m.new_stats for m in norms]  # the real pass's
        fake_pred = disc(fake_mel, speaker, patch)
        d_loss = discriminator_loss(real_pred, fake_pred, dp)
        grads = torch.autograd.grad(d_loss, params)
        with torch.no_grad():
            # summed over the data group in the gradients' own type
            g = all_reduce_(critic.opt.flatten(grads, dtype=None), dp).float()
            agree_over_model_group_([g, *(t for st in new_stats for t in st)], dp)
            d_loss = global_losses({"d": d_loss}, dp)["d"]
            ok = torch.isfinite(d_loss) & torch.isfinite(torch.sqrt(torch.sum(g * g)))
            u, nu = critic.opt.update(g)
            p = critic.opt.flatten(params)
            p = torch.where(ok, torch.clamp(p + u, -CRITIC_CLIP, CRITIC_CLIP), p)
            critic.opt.nu = torch.where(ok, nu, critic.opt.nu)
            torch._foreach_copy_(params, [x.view_as(q) for x, q in
                                          zip(p.split([q.numel() for q in params]), params)])
            for m, (mean, var) in zip(norms, new_stats):
                m.running_mean.copy_(torch.where(ok, mean, m.running_mean))
                m.running_var.copy_(torch.where(ok, var, m.running_var))
                m.new_stats = None
    return d_loss


def generator_terms(critic: CriticState, real_mel: torch.Tensor, fake_mel: torch.Tensor,
                    speaker: torch.Tensor, patch, dp: DataParallel | None = None
                    ) -> dict[str, torch.Tensor]:
    """``g_loss`` and ``g_d_fm_loss`` of the critic in eval mode on one
    ``patch`` of the real mel (no gradient) and the fake one (gradient
    through ``fake_mel``); this rank's shares under ``dp``."""
    disc = critic.disc
    with trace.span("adversarial.generator_terms"), _mode(disc, False):
        with torch.no_grad():
            _, real_feats = disc(real_mel, speaker, patch, return_features=True)
        fake_pred, fake_feats = disc(fake_mel, speaker, patch, return_features=True)
    return generator_loss(fake_pred, fake_feats, real_feats, dp=dp)


def adversarial_train_step(state: TrainState, critic: CriticState, batch: dict, tf_ratio,
                           cfg: Config, draws: dict | None = None,
                           seed: int | None = None,
                           dp: DataParallel | None = None) -> dict[str, torch.Tensor]:
    """One combined generator + critic step, in place on ``state`` and
    ``critic`` (see the module docstring). Draws absent from ``draws``
    (the model's, ``patch_g`` and ``patch_d``) come from
    ``step_generator(seed, state.step)``; under ``dp`` ``batch`` is this
    rank's rows. Returns the plain step's metrics and ``g_loss``,
    ``g_d_fm_loss`` and ``d_loss``, 0-d tensors on the device (the global
    batch's); nothing waits for the device."""
    draws = dict(draws or {})
    seed = cfg.train.seed if seed is None else seed
    mel = batch["mel"]
    gen = step_draws(seed, state.step, mel.device, dp, mel.shape[0])
    P = cfg.model.discriminator_patch
    for name in ("patch_g", "patch_d"):
        if name not in draws:
            draws[name] = sample_patch(mel.shape[-1], P, base_generator(gen), mel.device)
    outputs, losses, new_stats = forward_losses(state, batch, tf_ratio, cfg, draws, gen, dp)
    fake, spk = outputs["mel_postnet"], outputs["speaker_embedding"]
    adv = generator_terms(critic, mel, fake, spk, draws["patch_g"], dp)
    losses.update(adv)
    losses["total"] = losses["total"] + adv["g_loss"] + adv["g_d_fm_loss"]
    losses, grads = backward(state, losses, dp)
    metrics = apply_update(state, cfg, losses, new_stats, grads, dp)
    metrics["d_loss"] = critic_step(critic, mel, fake, spk, draws["patch_d"], dp)
    return metrics
