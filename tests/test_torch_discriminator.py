"""The port's WGAN critic and adversarial losses against the JAX package.

The critic at its only widths (the five residual blocks of 256-1024
channels; P=32, T=80, B=4), with seeded weights carried across through
``weights.critic_from_flax``. Tolerances, with reasons:

- ``extract_patch`` is a copy of frames and zeros: bit-equal;
- the critic's logit, its five features and the new BatchNorm statistics,
  f32: within 1e-4 of the tensor's max (the same products summed in
  another order through five blocks, three dense layers and a mean; 5.7e-6
  measured at the worst, in train mode);
- the losses: rtol 1e-5 (f32 means of the same values); the clamp:
  bit-equal; the gradient penalty: rtol 1e-4 (a gradient through the
  critic, then a norm; 1.4e-7 measured).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.config import ModelConfig as JModelConfig
from lip2speech_tpu.models.discriminator import Discriminator as JDiscriminator
from lip2speech_tpu.models.discriminator import extract_patch as j_extract_patch
from lip2speech_tpu.train import losses as jlosses
from lip2speech_torch import weights
from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.discriminator import Discriminator, extract_patch, sample_patch
from lip2speech_torch.train import losses
from torch_port_common import FAST_COMPILE, fill_tree, rel_err, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, P = 4, 80, 32
TOL = 1e-4
LOSS_RTOL, GP_RTOL = 1e-5, 1e-4


def _inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    mel = (rng.randn(B, 80, T) - 4.0).astype(np.float32)
    spk = (rng.randn(B, 256) * 0.1).astype(np.float32)
    return mel, spk


@pytest.fixture(scope="module")
def critics():
    """(JAX module, its variables, the port's critic with the same weights)."""
    disc = JDiscriminator(JModelConfig())
    mel, spk = _inputs()
    patch = (jnp.int32(3), jnp.int32(20))
    shapes = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(0), mel, spk, patch, train=False))
    variables = to_plain(fill_tree(shapes, 1))
    port = Discriminator(ModelConfig())
    port.load_state_dict(weights.critic_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return disc, variables, port


def test_extract_patch_is_bit_equal_to_jax():
    """50 reachable (start, length) pairs at T=80, a third of them with
    start > T - P (where JAX slices from T - P and rolls)."""
    rng = np.random.RandomState(1)
    mel = rng.randn(B, 80, T).astype(np.float32)
    f = jax.jit(lambda m, s, n: j_extract_patch(m, s, n, P), compiler_options=FAST_COMPILE)
    pairs = []
    for i in range(50):
        length = rng.randint(7, 32)
        lo = T - P + 1 if i % 3 == 0 else 0
        pairs.append((rng.randint(lo, T - length + 1), length))
    assert sum(s > T - P for s, _ in pairs) >= 15
    for start, length in pairs:
        want = np.asarray(f(mel, jnp.int32(start), jnp.int32(length)))
        got = extract_patch(t(mel), torch.tensor(start), torch.tensor(length), P).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((start, length)))
        np.testing.assert_array_equal(got[:, :length], mel.transpose(0, 2, 1)[:, start:start + length])


@pytest.mark.parametrize("t_len,max_patch", [(80, 32), (12, 8)])
def test_sample_patch_invariants(t_len, max_patch):
    gen = torch.Generator().manual_seed(0)
    draws = [tuple(int(x) for x in sample_patch(t_len, max_patch, gen)) for _ in range(3000)]
    starts = np.array([s for s, _ in draws])
    lengths = np.array([n for _, n in draws])
    assert lengths.min() == 7 and lengths.max() == min(32, max_patch) - 1
    assert (starts >= 0).all() and (starts + lengths <= t_len).all()
    assert (starts + lengths == t_len).any()  # the tail is reachable
    assert (starts == 0).mean() > 0.05  # starts pile at 0, as the reference's do


@pytest.mark.parametrize("mode", ["eval", "train", "train_dropout"])
def test_discriminator_matches_jax(critics, mode):
    """Logit, the five blocks' features and (train mode) the new BatchNorm
    statistics; ``train_dropout`` hands the port the keep masks that JAX
    draws from its dropout key."""
    disc, variables, port = critics
    mel, spk = _inputs(2)
    start, length = 51, 25  # start > T - P
    train = mode != "eval"
    key = jax.random.PRNGKey(9) if mode == "train_dropout" else None

    def apply(v, m, s):
        out, upd = disc.apply(v, m, s, (jnp.int32(start), jnp.int32(length)), train=train,
                              return_features=True, dropout_key=key, mutable=["batch_stats"])
        return out, upd.get("batch_stats", {})

    (logit, feats), stats = jax.jit(apply, compiler_options=FAST_COMPILE)(variables, mel, spk)
    keep = None
    if key is not None:
        keep = (jax.random.bernoulli(jax.random.fold_in(key, 0), 0.9, (B, P, 256)),
                jax.random.bernoulli(jax.random.fold_in(key, 1), 0.8, (B, 1024)))
        keep = tuple(torch.from_numpy(np.asarray(k)) for k in keep)
    port.train(train)
    with torch.no_grad():
        got, got_feats = port(t(mel), t(spk), (start, length), return_features=True, keep=keep)
    assert rel_err(got, t(logit)) <= TOL
    assert len(got_feats) == len(feats) == 5
    for g, w in zip(got_feats, feats):
        w = t(w).transpose(1, 2)  # JAX (B, T', C); the port (B, C, T')
        assert g.shape == w.shape and rel_err(g, w) <= TOL
    if train:
        want = weights.critic_from_flax(variables["params"], to_plain(stats))
        for i, block in enumerate(port.blocks()):
            for name in ("bn1", "bn2"):
                mean, var = getattr(block, name).new_stats
                assert rel_err(mean, want[f"res_{i}.{name}.running_mean"]) <= TOL
                assert rel_err(var, want[f"res_{i}.{name}.running_var"]) <= TOL
    port.eval()


@pytest.mark.parametrize("name", ["generator_loss", "discriminator_loss", "clamp",
                                  "gradient_penalty"])
def test_loss_matches_jax(critics, name):
    rng = np.random.RandomState(3)
    if name == "generator_loss":
        fake = [rng.randn(B, c, 16).astype(np.float32) for c in (256, 384)]
        real = [rng.randn(B, c, 16).astype(np.float32) for c in (256, 384)]
        pred = rng.randn(B).astype(np.float32)
        want = jlosses.generator_loss(jnp.asarray(pred), [jnp.asarray(x) for x in fake],
                                      [jnp.asarray(x) for x in real])
        got = losses.generator_loss(t(pred), [t(x) for x in fake], [t(x) for x in real])
        assert set(got) == set(want) == {"g_loss", "g_d_fm_loss"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL)
    elif name == "discriminator_loss":
        real, fake = rng.randn(B).astype(np.float32), rng.randn(B).astype(np.float32)
        np.testing.assert_allclose(float(losses.discriminator_loss(t(real), t(fake))),
                                   float(jlosses.discriminator_loss(real, fake)), rtol=LOSS_RTOL)
    elif name == "clamp":
        _, variables, port = critics
        clamped = losses.clamp_discriminator_params(copy.deepcopy(port))
        want = weights.critic_from_flax(
            jax.tree.map(np.asarray, jlosses.clamp_discriminator_params(variables["params"])),
            variables["batch_stats"])
        got = clamped.state_dict()
        assert any(float(port.state_dict()[k].abs().max()) > 0.01 for k in got
                   if k.endswith(".bn1.weight"))  # BatchNorm scales are clamped too
        for k, w in want.items():  # the running statistics stay as they were
            torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
    else:
        disc, variables, port = critics
        real, spk = _inputs(4)
        fake = real + rng.randn(*real.shape).astype(np.float32)
        alpha_key = jax.random.PRNGKey(5)
        patch = (jnp.int32(10), jnp.int32(30))
        want = jax.jit(lambda v: jlosses.gradient_penalty(disc.apply, v, real, fake, spk, patch,
                                                          alpha_key),
                       compiler_options=FAST_COMPILE)(variables)
        alpha = t(jax.random.uniform(alpha_key, (B, 1, 1)))
        port.eval()
        got = losses.gradient_penalty(lambda x: port(x, t(spk), (10, 30)), t(real), t(fake), alpha)
        assert got.requires_grad  # the penalty can be differentiated again
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=GP_RTOL)
