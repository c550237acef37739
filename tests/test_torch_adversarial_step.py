"""Two of the port's combined adversarial steps against the JAX package's
``adversarial_train_step``, as it is, with its seven-way key split.

The critic is the real one at its widths and patch (32 frames of a
40-frame mel; B=4, f32, seeded weights). The generator is a small stand-in with the train step's
interface and names, the same in both packages: an ``encoder`` dense layer
over the frames' mean colour and a ``decoder`` that maps the encoding, the
speaker embedding and the teacher mels to mel, mel_postnet (through a
flax-rule BatchNorm), gate and a content distribution. The real generator's
forward, loss, backward, update and BatchNorm guard are the plain step's,
held against JAX in tests/test_torch_train_step.py; a JAX step with the real
model and the critic compiles for minutes on a CPU, this one in seconds.
What this file holds is what the adversarial step adds and its order: the
generator terms joining ``total`` before the backward, the update, the
critic's step on the pre-update fake mel, the patches drawn from the
``patch_g`` and ``patch_d`` keys, and the metrics.

Tolerances, with reasons:

- the first step's metrics rtol 1e-5 (atol 1e-6): the same f32 values,
  summed in another order; its adversarial terms rtol 1e-4: the critic's
  loss is a difference of two means of its logits (5.1e-5 measured); the
  second step's metrics rtol 1e-4 (measured within 1e-5), after an AMSGrad
  update, which moves an entry with a near-zero gradient by up to lr on
  one side and not the other;
- the generator's parameters after two steps within 2 * lr * steps, its
  BatchNorm statistics within 1e-5 of the tensor's max;
- the critic: its statistics within 1e-4 of the tensor's max (5.9e-6
  measured). An RMSprop step moves an entry by up to lr * sqrt(10) either
  way, and an entry whose gradient is near 0 can go one way here and the
  other in JAX (3.1e-4 apart measured, after either step: the fake mels
  differ by the generators' rounding), so the change of each tensor from
  the start is held to JAX's: the same sign on at least 99.9% of the
  entries that JAX moved by more than lr / 2 (99.97% measured) and within
  1e-3 in L2 norm relative to JAX's change (1.1e-4 measured).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from lip2speech_tpu import config as jconfig
from lip2speech_tpu.models.discriminator import Discriminator as JDiscriminator
from lip2speech_tpu.models.discriminator import sample_patch as j_sample_patch
from lip2speech_tpu.models.layers import batch_norm as j_batch_norm
from lip2speech_tpu.train import adversarial as jadv
from lip2speech_tpu.train.train_step import TrainState as JTrainState
from lip2speech_tpu.train.train_step import make_optimizer as j_make_optimizer
from lip2speech_torch import config as tconfig
from lip2speech_torch import weights
from lip2speech_torch.models.discriminator import Discriminator
from lip2speech_torch.models.layers import BatchNorm1d
from lip2speech_torch.train.adversarial import CriticState, RMSprop, adversarial_train_step
from lip2speech_torch.train.train_step import create_train_state
from torch_port_common import (ADV_STEP_KEY_NAMES, FAST_COMPILE, fill_tree, jax_step_keys,
                               rel_err, small_configs, to_plain)
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, M, HW, E, K = 4, 8, 40, 16, 16, 5
STEPS, TF = 2, 0.5
LR, CRITIC_LR = 1e-4, 5e-5
ADV_TERMS = ("g_loss", "g_d_fm_loss", "d_loss")
GEN_STATS_TOL = 1e-5
STATS_TOL, SIGN_AGREE, DELTA_TOL = 1e-4, 0.999, 1e-3


class JGenerator(fnn.Module):
    @fnn.compact
    def __call__(self, video, faces, mels, tf_ratio, speaker_embedding, rngs, train=True):
        h = fnn.relu(fnn.Dense(E, name="encoder")(video.mean(axis=(2, 3)))).mean(axis=1)
        return JDecoder(name="decoder")(jnp.concatenate([h, speaker_embedding], -1), mels, train)


class JDecoder(fnn.Module):
    @fnn.compact
    def __call__(self, x, mels, train):
        frames = jnp.swapaxes(mels, 1, 2)  # (B, M, 80)
        mel = fnn.Dense(80, name="proj")(x)[:, None, :] + fnn.Dense(80, name="frame")(frames)
        post = mel + j_batch_norm(train, name="bn")(mel)
        return {"mel": jnp.swapaxes(mel, 1, 2), "mel_postnet": jnp.swapaxes(post, 1, 2),
                "gate": fnn.Dense(1, name="gate")(mel),
                "content_dist": jax.nn.softmax(fnn.Dense(K, name="content")(x), -1),
                "speaker_embedding": x[:, E:]}


class Generator(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = nn.Linear(3, E)
        self.decoder = Decoder()

    def forward(self, video, faces=None, speaker_embedding=None, generator=None, mels=None,
                tf_ratio=1.0, draws=None):
        h = torch.relu(self.encoder(video.mean(dim=(2, 3)))).mean(dim=1)
        return self.decoder(torch.cat([h, speaker_embedding], -1), mels)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj, self.frame = nn.Linear(E + 256, 80), nn.Linear(80, 80)
        self.bn = BatchNorm1d(80)
        self.gate, self.content = nn.Linear(80, 1), nn.Linear(E + 256, K)

    def forward(self, x, mels):
        mel = self.proj(x)[:, None, :] + self.frame(mels.transpose(1, 2))
        post = mel + self.bn(mel.transpose(1, 2)).transpose(1, 2)
        return {"mel": mel.transpose(1, 2), "mel_postnet": post.transpose(1, 2),
                "gate": self.gate(mel), "content_dist": torch.softmax(self.content(x), -1),
                "speaker_embedding": x[:, E:]}


def _generator_state_dict(v) -> dict:
    p, s = v["params"], v["batch_stats"]
    sd = {"encoder.weight": p["encoder"]["kernel"].T, "encoder.bias": p["encoder"]["bias"]}
    for name in ("proj", "frame", "gate", "content"):
        sd[f"decoder.{name}.weight"] = p["decoder"][name]["kernel"].T
        sd[f"decoder.{name}.bias"] = p["decoder"][name]["bias"]
    bn, st = p["decoder"]["bn"], s["decoder"]["bn"]
    sd.update({"decoder.bn.weight": bn["scale"], "decoder.bn.bias": bn["bias"],
               "decoder.bn.running_mean": st["mean"], "decoder.bn.running_var": st["var"]})
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def _batch():
    rng = np.random.RandomState(4)
    gate = np.zeros((B, M), np.float32)
    gate[:, -1] = 1.0
    return {
        "video": (rng.randn(B, T, HW, HW, 3) * 0.1).astype(np.float32),
        "speaker_embedding": (rng.randn(B, 256) * 0.1).astype(np.float32),
        "mel": (rng.randn(B, 80, M) - 5.0).astype(np.float32),
        "gate": gate,
        "mel_mask": np.ones((B, M), bool),
    }


@pytest.fixture(scope="module")
def steps():
    """Per step: (JAX metrics, the port's metrics); then the JAX state and
    critic after the steps, the port's state and critic."""
    jc, tc = small_configs()
    jcfg = jconfig.Config(model=jc, train=jconfig.TrainConfig(bf16=False, adversarial=True))
    tcfg = tconfig.Config(model=tc, train=tconfig.TrainConfig(bf16=False, adversarial=True))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model, disc = JGenerator(), JDiscriminator(jc)
    rng = jax.random.PRNGKey(42)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jbatch["video"], None,
                                               jbatch["mel"], TF, jbatch["speaker_embedding"], {}))
    variables = to_plain(fill_tree(shapes, 2))
    cshapes = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(0), jbatch["mel"],
                                               jbatch["speaker_embedding"],
                                               (jnp.int32(0), jnp.int32(20)), train=False))
    cvars = to_plain(fill_tree(cshapes, 3))
    tx = j_make_optimizer(jcfg, variables["params"])
    critic_tx = optax.rmsprop(jcfg.train.adversarial_critic_lr)
    state = JTrainState(jnp.int32(0), variables["params"], variables["batch_stats"],
                        tx.init(variables["params"]))
    critic = jadv.CriticState(cvars["params"], cvars["batch_stats"], critic_tx.init(cvars["params"]))
    jstep = jax.jit(functools.partial(jadv.adversarial_train_step, cfg=jcfg, model=model, tx=tx,
                                      disc=disc, critic_tx=critic_tx),
                    compiler_options=FAST_COMPILE)

    port = Generator()
    port.load_state_dict(_generator_state_dict(variables), strict=True)
    pstate = create_train_state(tcfg, port)
    pdisc = Discriminator(tc)
    pdisc.load_state_dict(weights.critic_from_flax(cvars["params"], cvars["batch_stats"]),
                          strict=True)
    pcritic = CriticState(pdisc, RMSprop(tcfg.train.adversarial_critic_lr, pdisc.parameters()))
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for i in range(STEPS):
        state, critic, jm = jstep(state, critic, jbatch, jnp.float32(TF), rng)
        keys = jax_step_keys(rng, i, ADV_STEP_KEY_NAMES)
        draws = {name: tuple(torch.tensor(int(x)) for x in j_sample_patch(keys[name], M, jc.discriminator_patch))
                 for name in ("patch_g", "patch_d")}
        pm = adversarial_train_step(pstate, pcritic, pbatch, TF, tcfg, draws)
        out.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in pm.items()},
                    weights.critic_from_flax(jax.tree.map(np.asarray, critic.params),
                                             jax.tree.map(np.asarray, critic.batch_stats)),
                    {k: v.clone() for k, v in pcritic.disc.state_dict().items()}))
    start = weights.critic_from_flax(cvars["params"], cvars["batch_stats"])
    return out, state, pstate, start


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(steps, step):
    want, got, _, _ = steps[0][step]
    assert set(got) == set(want)
    assert {"g_loss", "g_d_fm_loss", "d_loss", "grad_norm", "notfinite_count"} <= set(got)
    assert got["notfinite_count"] == 0
    for k, w in want.items():
        rtol = 1e-5 if step == 0 and k not in ADV_TERMS else 1e-4
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_critic_matches_jax(steps, step):
    """The critic after each step: statistics, the clamp, and each tensor's
    change from the start against JAX's (sign on the entries JAX moved by
    more than lr / 2, L2)."""
    _, _, want, got = steps[0][step]
    start = steps[-1]
    for k, w in want.items():
        if "running_" in k:
            assert rel_err(got[k], w) <= STATS_TOL, k
            continue
        assert float(got[k].abs().max()) <= 0.01, k
        dj, dp = (w - start[k]).double(), (got[k] - start[k]).double()
        moved = dj.abs() > CRITIC_LR / 2
        if moved.any():
            agree = float((torch.sign(dp[moved]) == torch.sign(dj[moved])).double().mean())
            assert agree >= SIGN_AGREE, (k, agree)
            assert float((dp - dj).norm() / dj.norm()) <= DELTA_TOL, k


def test_generator_matches_jax_after_two_steps(steps):
    _, state, pstate, _ = steps
    assert pstate.step == int(state.step) == STEPS
    want = _generator_state_dict(to_plain(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})))
    got = pstate.model.state_dict()
    for k, w in want.items():
        if "running_" in k:
            assert rel_err(got[k], w) <= GEN_STATS_TOL, k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * LR * STEPS,
                                       err_msg=k)
