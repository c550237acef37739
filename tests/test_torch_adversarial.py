"""The port's adversarial training step against the JAX package.

- ``RMSprop`` against ``optax.rmsprop`` over three updates;
- ``critic_step`` against the JAX ``critic_step`` at the critic's widths
  (P=32, T=80, B=4) on the patch JAX draws from its key, two steps; and the
  skip of a non-finite step;
- ``generator_terms`` and its gradient with respect to the fake mel
  against ``jax.grad``.

The combined step is in tests/test_torch_adversarial_step.py. The critics
start from the seeded values of ``fill_tree``: the first step clamps most
weights of the first layers to 0.01, while many of the deeper blocks' lie
inside it, where the RMSprop update shows. Tolerances, with reasons:

- RMSprop: parameters (values of 1e-2) within 1e-7, nu within rtol 1e-6:
  the same f32 operations, ``rsqrt`` may differ in the last place;
- the critic's loss rtol 1e-4 plus 1e-6 (a difference of two means of its
  logits); its new statistics within 1e-4 of the tensor's max (the
  critic's f32 products in another order; 8.4e-7 measured); its
  parameters by their change (see ``test_critic_step_matches_jax``): each
  RMSprop step moves an entry by up to lr * sqrt(10) = 1.6e-4 either way,
  so an entry whose gradient is near 0 could go one way here and the other
  in JAX (none did: 8.1e-7 apart at most, measured);
- ``generator_terms``: values rtol 1e-4, the gradient within 1e-4 of its
  max.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lip2speech_tpu import config as jconfig
from lip2speech_tpu.models.discriminator import Discriminator as JDiscriminator
from lip2speech_tpu.models.discriminator import sample_patch as j_sample_patch
from lip2speech_tpu.train import adversarial as jadv
from lip2speech_torch import config as tconfig
from lip2speech_torch import weights
from lip2speech_torch.models.discriminator import Discriminator
from lip2speech_torch.train.adversarial import CriticState, RMSprop, critic_step, generator_terms
from torch_port_common import FAST_COMPILE, fill_tree, rel_err, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 5e-5  # adversarial_critic_lr
CB, CT = 4, 80  # the critic tests' batch and mel length
RMS_ATOL, RMS_NU_RTOL = 1e-7, 1e-6
D_RTOL, D_ATOL, STATS_TOL, DELTA_TOL = 1e-4, 1e-6, 1e-4, 1e-3
G_RTOL, G_GRAD_TOL = 1e-4, 1e-4


def _critic_variables(disc, mel, spk, seed: int) -> dict:
    shapes = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(0), mel, spk,
                                              (jnp.int32(0), jnp.int32(8)), train=False))
    return to_plain(fill_tree(shapes, seed))


def _port_critic(cfg, variables) -> CriticState:
    disc = Discriminator(cfg)
    disc.load_state_dict(weights.critic_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return CriticState(disc, RMSprop(LR, disc.parameters()))


def _patch(start, length):
    return torch.tensor(int(start)), torch.tensor(int(length))


@pytest.fixture(scope="module")
def critic_setup():
    rng = np.random.RandomState(0)
    real = (rng.randn(CB, 80, CT) - 5.0).astype(np.float32)
    fake = (rng.randn(CB, 80, CT) - 4.0).astype(np.float32)
    spk = (rng.randn(CB, 256) * 0.1).astype(np.float32)
    disc = JDiscriminator(jconfig.ModelConfig())
    return disc, _critic_variables(disc, real, spk, 1), real, fake, spk


def test_rmsprop_matches_optax():
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [(rng.randn(*s) * 1e-2).astype(np.float32) for s in shapes]
    tx = optax.rmsprop(LR)
    state = tx.init(params)
    port = [t(p) for p in params]
    opt = RMSprop(LR, port)
    for step in range(3):
        grads = [(rng.randn(*s) * 10.0 ** (step - 2)).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, params)
        params = [np.asarray(x) for x in optax.apply_updates(params, updates)]
        u, opt.nu = opt.update(opt.flatten([t(g) for g in grads]))
        for p, x in zip(port, u.split([p.numel() for p in port])):
            p.add_(x.view_as(p))
        for p, w in zip(port, params):
            np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=RMS_ATOL)
        nu = np.concatenate([np.ravel(n) for n in state[0].nu])
        np.testing.assert_allclose(opt.nu.numpy(), nu, rtol=RMS_NU_RTOL)


def test_critic_step_matches_jax(critic_setup):
    """Two steps: loss, statistics and parameters against JAX's, every
    parameter (BatchNorm scales and biases too) clamped to 0.01, and the
    change of each tensor against JAX's: the same sign on 99% of the
    entries JAX moved by more than lr / 2, and within 1e-3 in L2 norm
    relative to JAX's change (measured: every sign, 2.9e-7)."""
    disc, variables, real, fake, spk = critic_setup
    tx = optax.rmsprop(LR)
    jcritic = jadv.CriticState(variables["params"], variables["batch_stats"],
                               tx.init(variables["params"]))
    step = jax.jit(functools.partial(jadv.critic_step, disc=disc, tx=tx),
                   compiler_options=FAST_COMPILE)
    port = _port_critic(tconfig.ModelConfig(), variables)
    start_sd = {k: v.clone() for k, v in port.disc.state_dict().items()}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        patch = j_sample_patch(key, CT, disc.cfg.discriminator_patch)
        jcritic, jd = step(jcritic, real, fake, spk, key)
        d = critic_step(port, t(real), t(fake), t(spk), _patch(*patch))
        np.testing.assert_allclose(float(d), float(jd), rtol=D_RTOL, atol=D_ATOL)
        want = weights.critic_from_flax(jax.tree.map(np.asarray, jcritic.params),
                                        jax.tree.map(np.asarray, jcritic.batch_stats))
        got = port.disc.state_dict()
        for k, w in want.items():
            if "running_" in k:
                assert rel_err(got[k], w) <= STATS_TOL, k
            else:
                assert float(got[k].abs().max()) <= 0.01, k
    checked = 0
    for k, w in want.items():
        if "running_" in k:
            continue
        dj, dp = (w - start_sd[k]).double(), (got[k] - start_sd[k]).double()
        moved = dj.abs() > LR / 2  # not the biases in front of a BatchNorm (0 up to rounding)
        if not moved.any():
            continue
        checked += 1
        assert float((torch.sign(dp[moved]) == torch.sign(dj[moved])).double().mean()) >= 0.99, k
        assert float((dp - dj).norm() / dj.norm()) <= DELTA_TOL, k
    assert checked >= len([k for k in want if k.endswith(".weight")])


def test_critic_step_skips_a_nonfinite_step(critic_setup):
    """A NaN fake mel: the loss says so, and the parameters, statistics and
    RMSprop state stay bit-equal; the next finite step moves them."""
    _, variables, real, fake, spk = critic_setup
    port = _port_critic(tconfig.ModelConfig(), variables)
    critic_step(port, t(real), t(fake), t(spk), _patch(3, 20))
    before = {k: v.clone() for k, v in port.disc.state_dict().items()}
    nu = port.opt.nu.clone()
    d = critic_step(port, t(real), torch.full((CB, 80, CT), float("nan")), t(spk), _patch(40, 30))
    assert not torch.isfinite(d)
    for k, v in port.disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(port.opt.nu, nu)
    assert torch.isfinite(critic_step(port, t(real), t(fake), t(spk), _patch(40, 30)))
    assert not torch.equal(port.opt.nu, nu)


def test_generator_terms_and_their_gradient_match_jax(critic_setup):
    disc, variables, real, fake, spk = critic_setup
    critic = jadv.CriticState(variables["params"], variables["batch_stats"], None)
    key = jax.random.PRNGKey(3)

    def total(f):
        terms = jadv.generator_terms(critic, real, f, spk, key, disc)
        return terms["g_loss"] + terms["g_d_fm_loss"], terms

    (_, want), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True),
                                   compiler_options=FAST_COMPILE)(jnp.asarray(fake))
    port = _port_critic(tconfig.ModelConfig(), variables)
    port.disc.train()  # generator_terms runs the critic in eval mode whatever its mode
    f = t(fake).requires_grad_(True)
    got = generator_terms(port, t(real), f, t(spk),
                          _patch(*j_sample_patch(key, CT, disc.cfg.discriminator_patch)))
    (grad,) = torch.autograd.grad(got["g_loss"] + got["g_d_fm_loss"], f)
    assert port.disc.training
    assert all(p.grad is None for p in port.disc.parameters())
    for k in ("g_loss", "g_d_fm_loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=G_RTOL, atol=1e-7)
    assert rel_err(grad, t(want_grad)) <= G_GRAD_TOL
