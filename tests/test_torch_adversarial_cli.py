"""The port's training CLI in the adversarial mode
(``--override train.adversarial=true``) on the CPU: a tiny model on the
synthetic LRW fixture (the set-up of tests/test_torch_train_cli.py).

- two steps on a staged batch with an eval tick: the metrics of the JAX
  CLI's adversarial records (the JAX step's metrics, traced, not
  compiled), finite, the critic clamped to 0.01, and no critic in the
  checkpoint;
- a resumed run starts its critic afresh from ``train.seed + 17``, as the
  JAX CLI does;
- ``--rewind_on_stall`` with the adversarial mode raises the JAX CLI's
  ``RuntimeError``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lip2speech_torch.cli import train as train_cli
from lip2speech_torch.data import make_sample_lrw
from lip2speech_torch.train.adversarial import init_critic
from test_torch_train_cli import FRAMES, SAMPLES, TINY, tiny_config
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """No TensorBoard: importing it costs seconds here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lrw_adv_cli"))
    make_sample_lrw(root, split="test", n_clips=2, n_frames=FRAMES, n_samples=SAMPLES)
    return root


def _args(root, tmp, *extra):
    return train_cli.parse_args(["--root", root, "--device", "cpu", "--batch_size", "2",
                                 "--log_interval", "1", "--run_dir", str(tmp / "run"),
                                 "--ckpt_dir", str(tmp / "ckpt"), "--train_split", "test",
                                 "--reuse_first_batch", *extra])


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    """Two adversarial steps with an eval tick at step 2, then a resumed run
    to step 3."""
    tmp = tmp_path_factory.mktemp("adv_cli")
    cfg = tiny_config(adversarial=True)
    seeds = []  # the seed of each critic the CLI starts

    def recorded(cfg, generator, device=None):
        seeds.append(generator.initial_seed())
        return init_critic(cfg, generator, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli, "init_critic", recorded)
        first = train_cli.train(_args(root, tmp, "--max_iters", "2", "--eval_interval", "2",
                                      "--eval_batches", "1"), cfg)
        critic = {k: v.clone() for k, v in first["critic"].disc.state_dict().items()}
        second = train_cli.train(_args(root, tmp, "--max_iters", "3", "--eval_interval", "100"),
                                 cfg)
    with open(tmp / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return tmp, cfg, first, critic, second, rows, seeds


def _jax_adversarial_keys() -> set:
    """The JAX adversarial step's metric names (traced, not compiled)."""
    import jax
    import jax.numpy as jnp

    from lip2speech_tpu.config import Config as JConfig
    from lip2speech_tpu.config import ModelConfig as JModelConfig
    from lip2speech_tpu.config import TrainConfig as JTrainConfig
    from lip2speech_tpu.models import Lip2Speech as JLip2Speech
    from lip2speech_tpu.train import create_train_state, make_optimizer
    from lip2speech_tpu.train.adversarial import init_critic as j_init_critic
    from lip2speech_tpu.train.adversarial import make_adversarial_train_step

    cfg = JConfig(model=JModelConfig(**TINY), train=JTrainConfig(adversarial=True))
    model = JLip2Speech(cfg.model)
    B, M = 2, 33
    batch = {"video": jnp.zeros((B, FRAMES, 48, 48, 3)), "speaker_embedding": jnp.zeros((B, 256)),
             "mel": jnp.zeros((B, 80, M)), "gate": jnp.zeros((B, M)),
             "mel_mask": jnp.ones((B, M), bool)}

    def step():
        keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("gumbel", "teacher", "dropout"))}
        v = model.init({"params": jax.random.PRNGKey(0)}, batch["video"], None, batch["mel"], 0.5,
                       batch["speaker_embedding"], keys, train=False)
        tx = make_optimizer(cfg, v["params"])
        state = create_train_state(cfg, v, init_opt=False)
        state = state._replace(opt_state=tx.init(state.params))
        disc, critic_tx, critic = j_init_critic(cfg, jax.random.PRNGKey(17), B)
        return make_adversarial_train_step(cfg, model, tx, disc, critic_tx)(
            state, critic, batch, jnp.float32(0.5), jax.random.PRNGKey(0))[2]

    return set(jax.eval_shape(step))


def test_adversarial_steps_log_the_jax_metrics(trained):
    _, _, first, _, _, rows, _ = trained
    steps = [r for r in rows if "total" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    want = _jax_adversarial_keys() | {"tf_ratio", "epoch", "step", "time", "step_time"}
    assert {"g_loss", "g_d_fm_loss", "d_loss"} <= want
    for r in steps:
        assert set(r) == want
        assert all(np.isfinite(r[k]) for k in want), r
    assert steps[0]["d_loss"] != steps[1]["d_loss"]
    assert [r["step"] for r in rows if "eval/estoi" in r] == [2]
    assert -1.0 <= first["best_score"] <= 1.0


def test_critic_is_clamped_and_not_checkpointed(trained):
    tmp, _, first, critic, _, _, _ = trained
    params = dict(first["critic"].disc.named_parameters())
    assert params and all(float(critic[k].abs().max()) <= 0.01 for k in params)
    assert sorted(os.listdir(tmp / "ckpt")) == ["step_2.pt", "step_3.pt"]
    payload = torch.load(tmp / "ckpt" / "step_2.pt", weights_only=False)
    assert not any(k.startswith(("res_", "mel_encoder", "critic")) for k in payload["model"])
    assert set(payload) == {"model", "optimizer", "step", "extra"}


def test_resume_starts_a_fresh_critic(trained):
    """Each run, the resumed one too, starts its critic from seed + 17."""
    _, cfg, _, _, second, rows, seeds = trained
    assert second["start_step"] == 2 and second["final_step"] == 3
    assert seeds == [cfg.train.seed + 17] * 2
    a, b = (init_critic(cfg, torch.Generator().manual_seed(s)).disc.state_dict() for s in seeds)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(float(p.abs().max()) <= 0.01 for p in second["critic"].disc.parameters())
    assert np.isfinite([r for r in rows if "total" in r][-1]["d_loss"])


def test_rewind_on_stall_is_refused(root, tmp_path):
    cfg = tiny_config(adversarial=True)
    with pytest.raises(RuntimeError, match="--rewind_on_stall is unsupported with "
                                           "train.adversarial=true"):
        train_cli.train(_args(root, tmp_path, "--max_iters", "1", "--rewind_on_stall", "3"), cfg)
