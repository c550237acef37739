"""Speaker pretraining's step and CLIs in the port against the JAX
package, on the CPU.

- the whole ``speaker_train_step`` over 3 steps against JAX's own, with a
  stand-in face net defined here for both (JAX's step with the real face
  net compiles for minutes on one core) and the real face decoder and voice
  encoder, at B=2 (XLA's CPU gradient of the decoder's grouped convs takes
  ~4 s a sample): each step's losses, ``grad_norm`` and ``t`` within 1e-5
  (``LOSS_REL``), each group's parameter change by sign and L2, the
  statistics after the first step within 1e-5 (``REL``);
- ``cli.speaker_train`` (2 steps, checkpoints that restore) and
  ``cli.speaker_test`` on a 4-clip fixture, with the JAX step's metric
  names.
"""

import functools
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lip2speech_tpu.config import Config as JConfig
from lip2speech_tpu.speaker import train_loop as jloop
from lip2speech_tpu.speaker.models import FaceDecoder as JFaceDecoder
from lip2speech_tpu.speaker.models import SpeakerEncoder as JSpeakerEncoder
from lip2speech_torch import weights
from lip2speech_torch.config import Config
from lip2speech_torch.models.layers import BatchNorm2d
from lip2speech_torch.speaker import train_loop
from torch_port_common import FAST_COMPILE, change_agreement, fill_tree, rel_l2, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
SIGN, DELTA = 0.999, 1e-3
ADAM_SIGN, ADAM_DELTA = 0.998, 5e-2
LOSS_REL = 1e-5



class JStandIn(fnn.Module):
    """A small face net for JAX's step: conv, train-mode BatchNorm, ReLU,
    mean, dropout 0.6, Dense to 256."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(8, (3, 3), strides=(4, 4), padding="VALID", use_bias=False, name="conv")(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-3, name="bn")(x)
        x = jnp.mean(fnn.relu(x), axis=(1, 2))
        x = fnn.Dropout(0.6, deterministic=not train)(x)
        return fnn.Dense(256, name="fc")(x)


class StandIn(torch.nn.Module):
    """``JStandIn`` in the port, under the same names."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=4, bias=False)
        self.bn = BatchNorm2d(8, eps=1e-3)
        self.fc = torch.nn.Linear(8, 256)

    def forward(self, x, keep=None):
        x = F.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
        if self.training:
            x = torch.where(keep, x / (1.0 - 0.6), 0.0)
        return self.fc(x)


STEP_B, STEP_SAMPLES, STEPS = 2, 8000, 3


@pytest.fixture(scope="module")
def stand_in_steps():
    return run_stand_in_steps()


def run_stand_in_steps():
    """Three steps of JAX's ``speaker_train_step`` and of the port's, with
    the stand-in face net, from the same weights, batch and draws. The
    decoder's ``to_rgb`` kernel is scaled by 0.1, so the reconstruction
    starts near the faces' scale (``rec_loss`` ~4, not ~550): at the plain
    seeded weights Adam's first update (+-lr on every decoder entry, those
    whose gradient is rounding noise too) left the third step's
    ``rec_loss`` 2.2e-4 apart between the two packages, and JAX alone moved
    it by 3.4e-5 between two of its XLA optimisation levels."""
    cfg = JConfig()
    face, dec, spk = JStandIn(), JFaceDecoder(), JSpeakerEncoder(cfg.model)
    rgb_scale = 0.1
    rng = np.random.RandomState(12)
    batch = {"speech": (rng.randn(STEP_B, STEP_SAMPLES) * 0.1).astype(np.float32),
             "faces_u8": rng.randint(0, 256, (STEP_B, 160, 160, 3)).astype(np.uint8)}
    faces = (batch["faces_u8"].astype(np.float32) - 127.5) / 128.0
    shapes = jax.eval_shape(lambda: (
        face.init(jax.random.PRNGKey(0), faces, train=False),
        dec.init(jax.random.PRNGKey(0), jnp.zeros((STEP_B, 256)), train=False),
        spk.init(jax.random.PRNGKey(0), batch["speech"])))
    fv, dv, sv = to_plain(fill_tree(shapes, 13))
    dv["params"]["to_rgb"]["kernel"] = dv["params"]["to_rgb"]["kernel"] * np.float32(rgb_scale)
    params = {"face": fv["params"], "decoder": dv["params"], "t": np.float32(1.0)}
    stats = {"face": fv["batch_stats"], "decoder": dv["batch_stats"]}
    tx = jloop.make_speaker_optimizer(steps_per_epoch=1)
    state = jloop.SpeakerTrainState(jnp.zeros((), jnp.int32), params, stats, sv, tx.init(params))
    step_fn = jax.jit(functools.partial(jloop.speaker_train_step, models=(face, dec, spk), tx=tx),
                      compiler_options=FAST_COMPILE)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def jax_draws(fparams, fstats, step):
        step_rng = jax.random.fold_in(key, step)
        k_choice, k_drop = jax.random.split(step_rng)
        _, upd = face.apply({"params": fparams, "batch_stats": fstats}, faces, train=True,
                            rngs={"dropout": jax.random.fold_in(step_rng, 1)},
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        return (jax.random.bernoulli(k_choice), jax.tree.leaves(upd["intermediates"])[0] != 0,
                jax.random.bernoulli(k_drop, 0.7, (STEP_B, 12800)))

    key = jax.random.PRNGKey(3)
    model = train_loop.SpeakerTraining(Config(), face_net=StandIn())
    sd = {f"face.{k}": v for k, v in weights.named_from_flax(fv["params"], fv["batch_stats"]).items()}
    sd.update({f"decoder.{k}": v for k, v in weights.named_from_flax(
        dv["params"], dv["batch_stats"], weights.FACE_DECODER_RENAME).items()})
    sd.update({f"speaker.{k}": v for k, v in weights.speaker_from_flax(sv["params"]).items()})
    sd["t"] = torch.tensor(1.0)
    model.load_state_dict(sd, strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    pstate = train_loop.create_speaker_state(model, steps_per_epoch=1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jax_metrics, port_metrics, uses, first_stats = [], [], [], None
    for step in range(STEPS):
        use_face, face_keep, dec_keep = jax_draws(state.params["face"], state.batch_stats["face"],
                                                  step)
        uses.append(bool(use_face))
        draws = {"use_face": torch.tensor(bool(use_face)),
                 "face": torch.from_numpy(np.array(face_keep)),
                 "decoder": torch.from_numpy(np.array(dec_keep))}
        state, m = step_fn(state, batch, key)
        jax_metrics.append({k: float(v) for k, v in m.items()})
        port_metrics.append({k: float(v) for k, v in
                             train_loop.speaker_train_step(pstate, tbatch, draws).items()})
        if step == 0:
            first_stats = (state.batch_stats, {k: v.clone() for k, v in model.state_dict().items()
                                               if "running_" in k})
    return dict(state=state, pstate=pstate, start=start, jax=jax_metrics, port=port_metrics,
                uses=uses, first_stats=first_stats)


def test_speaker_step_metrics_match_jax(stand_in_steps):
    r = stand_in_steps
    assert r["pstate"].step == STEPS
    for step, (got, want) in enumerate(zip(r["port"], r["jax"])):
        assert set(got) == set(want) == {"c_loss", "l2_loss", "rec_loss", "loss", "grad_norm", "t"}
        for k, w in want.items():
            assert abs(got[k] - w) <= LOSS_REL * abs(w) + 1e-7, (step, k, got[k], w)


def _by_port_name(params, stats) -> dict:
    face = weights.named_from_flax(params["face"], stats["face"])
    dec = weights.named_from_flax(params["decoder"], stats["decoder"],
                                  weights.FACE_DECODER_RENAME)
    return {**{f"face.{k}": v for k, v in face.items()},
            **{f"decoder.{k}": v for k, v in dec.items()}}


def test_speaker_step_parameters_match_jax(stand_in_steps):
    """Each group's change over the 3 steps, by sign and L2. The face net
    (SGD, linear in its gradient) at ``SIGN``/``DELTA``. The decoder under
    Adam at ``ADAM_SIGN``/``ADAM_DELTA``: Adam scales each entry by its own
    gradient's size, so an entry with a gradient near rounding level moves
    by up to lr either way (sign 0.99904 and L2 1.6e-2 measured). Left out:
    the biases of the decoder's convs that feed a train-mode BatchNorm,
    whose gradient is 0 but for rounding (their changes agree in sign on
    about half the entries). The statistics after the first step within
    ``REL``."""
    r = stand_in_steps
    state, model, start = r["state"], r["pstate"].model, r["start"]
    now = model.state_dict()
    want = _by_port_name(state.params, state.batch_stats)
    for group, sign_tol, delta_tol in (("face", SIGN, DELTA), ("decoder", ADAM_SIGN, ADAM_DELTA)):
        keys = [k for k in want if k.startswith(group) and "running_" not in k
                and not k.endswith(("pw.bias", "dw.bias"))]
        sign, delta = change_agreement(
            torch.cat([(now[k] - start[k]).reshape(-1) for k in keys]),
            torch.cat([(want[k] - start[k]).reshape(-1) for k in keys]))
        assert sign >= sign_tol and delta <= delta_tol, (group, sign, delta)
    jstats, pstats = r["first_stats"]
    want_stats = _by_port_name({"face": {}, "decoder": {}}, jstats)
    assert set(want_stats) == set(pstats)
    for k, w in want_stats.items():
        assert rel_l2(pstats[k], w) <= REL, k
    assert abs(float(now["t"]) - float(state.params["t"])) <= 1e-6
    assert float(now["t"]) != 1.0


@pytest.fixture
def no_tensorboard(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_speaker_cli_train_and_test(tmp_path, stand_in_steps, no_tensorboard):
    from lip2speech_torch.cli import speaker_test, speaker_train
    from lip2speech_torch.data import make_sample_avspeech_face
    from lip2speech_torch.train import checkpoint as ckpt

    root = str(tmp_path / "avspeech")
    make_sample_avspeech_face(root, "train", n_clips=4, n_frames=60, seed=1)
    make_sample_avspeech_face(root, "test", n_clips=1, n_frames=60, seed=2)
    run, ck = str(tmp_path / "run"), str(tmp_path / "ck")
    state = speaker_train.main(["--root", root, "--batch_size", "2", "--max_iters", "2",
                                "--log_interval", "1", "--save_interval", "1", "--device", "cpu",
                                "--run_dir", run, "--ckpt_dir", ck])
    assert state.step == 2 and ckpt.available_steps(ck) == [1, 2]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    names = set(stand_in_steps["jax"][0])  # the JAX step's metric names
    for r in rows:
        assert set(r) == names | {"step", "time", "step_time"}
        assert all(np.isfinite(v) for v in r.values())
    fresh = train_loop.create_speaker_state(train_loop.SpeakerTraining(Config()), 2)
    _, extra = ckpt.restore_checkpoint(ck, fresh)
    assert fresh.step == 2 and extra["t"] == float(state.model.t.detach())
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert torch.equal(fresh.opt.face.trace, state.opt.face.trace)

    out = str(tmp_path / "test_out")
    emb = speaker_test.main(["--root", root, "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["face.jpg", "face_embedding.npy", "speech_embedding.npy"]
    for k in ("face_embedding", "speech_embedding"):
        saved = np.load(os.path.join(out, f"{k}.npy"))
        assert saved.shape == (1, 256) and np.isfinite(saved).all()
        assert np.array_equal(saved, emb[k])
