"""Batch preparation, training targets, losses and train-mode BatchNorm
against the JAX package.

- ``collate`` (numpy on both sides): bitwise equal.
- ``prepare_batch`` on short and full-length audio: normalised video and
  faces within 1e-6, the gate, the mel mask and the lengths exactly, the
  log-mel within 1e-4 (f32 DFT products whose summation order differs;
  the log turns relative error of the power into absolute error).
- ``melspectrogram`` and the complex ``stft``: the same tolerances
  (``stft`` within 1e-4 of the spectrum's max).
- ``lip2speech_loss``, masked and unmasked, on the same outputs: rtol 1e-6.
- ``BatchNorm1d/2d/3d`` in train mode against flax ``nn.BatchNorm`` as
  ``layers.batch_norm`` builds it: outputs within 1e-5, new running
  statistics within 1e-6; torch's stock BatchNorm, whose running variance
  uses the unbiased batch variance, is off by far more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu import config as jconfig
from lip2speech_tpu.data.collate import collate as j_collate
from lip2speech_tpu.data.collate import prepare_batch as j_prepare_batch
from lip2speech_tpu.models.layers import batch_norm as j_batch_norm
from lip2speech_tpu.ops import mel as j_mel
from lip2speech_tpu.ops import stft as j_stft
from lip2speech_tpu.train.losses import lip2speech_loss as j_loss
from lip2speech_torch import config as tconfig
from lip2speech_torch.data.collate import collate, prepare_batch, to_device
from lip2speech_torch.models.layers import BatchNorm1d, BatchNorm2d, BatchNorm3d
from lip2speech_torch.ops import mel, stft
from lip2speech_torch.train.losses import lip2speech_loss
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = dict(max_video_frames=6, max_audio_samples=4000, mouth_size=(16, 16), face_size=(20, 20))


def _samples(rng):
    """Four clips: full length, short audio (a few frames), short video,
    and audio longer than the bucket."""
    out = []
    for t, n in ((6, 4000), (6, 700), (3, 2500), (6, 5000)):
        out.append({
            "mouth": rng.randint(0, 256, (t, 16, 16, 3)).astype(np.uint8),
            "faces": rng.randint(0, 256, (2, 20, 20, 3)).astype(np.uint8),
            "audio": (rng.randn(n) * 0.1).astype(np.float32),
        })
    return out


@pytest.fixture(scope="module")
def batches():
    samples = _samples(np.random.RandomState(0))
    jd, td = jconfig.DataConfig(**DATA), tconfig.DataConfig(**DATA)
    j_raw, t_raw = j_collate(samples, jd), collate(samples, td)
    want = j_prepare_batch({k: jnp.asarray(v) for k, v in j_raw.items()}, jconfig.AudioConfig(), jd)
    got = prepare_batch(to_device(t_raw, "cpu"), tconfig.AudioConfig(), td)
    return j_raw, t_raw, want, got


def test_collate_matches_jax(batches):
    j_raw, t_raw, _, _ = batches
    assert set(j_raw) == set(t_raw)
    for k, v in j_raw.items():
        assert t_raw[k].dtype == v.dtype and np.array_equal(t_raw[k], v), k


def test_prepare_batch_matches_jax(batches):
    _, _, want, got = batches
    assert set(got) == set(want)
    for k in ("video", "faces"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    for k in ("gate", "mel_mask", "mel_lengths", "video_lengths", "audio_lengths"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-4, rtol=0)
    # the short clip: 700 samples -> 3 valid frames, gate on from the last
    assert got["mel_lengths"].tolist() == [16, 3, 10, 16]
    assert got["gate"][1].tolist() == [0.0, 0.0] + [1.0] * 14
    assert bool((got["mel"][1, :, 3:] == tconfig.DataConfig().mel_pad_value).all())
    assert bool((got["video"][2, 3:] == 0).all())


def test_melspectrogram_and_stft_match_jax():
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, 3000) * 0.2).astype(np.float32)
    want = j_mel.melspectrogram(jnp.asarray(wav), jconfig.AudioConfig())
    got = mel.melspectrogram(torch.from_numpy(wav), tconfig.AudioConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    ws = np.asarray(j_stft.stft(jnp.asarray(wav), 512, 128))
    gs = stft.stft(torch.from_numpy(wav), 512, 128).numpy()
    assert gs.shape == ws.shape
    np.testing.assert_allclose(gs, ws, atol=1e-4 * np.abs(ws).max(), rtol=0)
    np.testing.assert_allclose(mel.log_compress(torch.tensor([0.0, 1e-6, 2.0])).numpy(),
                               np.asarray(j_mel.log_compress(jnp.array([0.0, 1e-6, 2.0]))))


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_jax(masked):
    rng = np.random.RandomState(2)
    B, M, S, V = 3, 10, 4, 17
    q = rng.uniform(0.0, 1.0, (B * S, V)).astype(np.float32)
    outputs = {"mel": rng.randn(B, 80, M), "mel_postnet": rng.randn(B, 80, M),
               "gate": rng.randn(B, M, 1) * 3, "content_dist": q / q.sum(-1, keepdims=True)}
    outputs = {k: np.asarray(v, np.float32) for k, v in outputs.items()}
    target = rng.randn(B, 80, M).astype(np.float32)
    gate = (np.arange(M)[None] >= np.array([[4], [9], [2]])).astype(np.float32)
    mask = np.arange(M)[None] < np.array([[5], [10], [3]])
    want = j_loss({k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(target),
                  jnp.asarray(gate), mel_mask=jnp.asarray(mask) if masked else None, kld_weight=0.3)
    got = lip2speech_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                          torch.from_numpy(target), torch.from_numpy(gate),
                          mel_mask=torch.from_numpy(mask) if masked else None, kld_weight=0.3)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("cls,stock,shape", [
    (BatchNorm1d, torch.nn.BatchNorm1d, (4, 6, 9)),
    (BatchNorm2d, torch.nn.BatchNorm2d, (3, 6, 5, 4)),
    (BatchNorm3d, torch.nn.BatchNorm3d, (2, 6, 3, 4, 5)),
])
def test_train_mode_batch_norm_follows_flax(cls, stock, shape):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    C = shape[1]
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.randn(C).astype(np.float32)
    mean0, var0 = rng.randn(C).astype(np.float32), rng.uniform(0.5, 2, C).astype(np.float32)
    x_last = np.moveaxis(x, 1, -1)
    flax_bn = j_batch_norm(True)
    y, upd = flax_bn.apply({"params": {"scale": scale, "bias": bias},
                            "batch_stats": {"mean": mean0, "var": var0}},
                           jnp.asarray(x_last), mutable=["batch_stats"])
    want_mean, want_var = (np.asarray(upd["batch_stats"][k]) for k in ("mean", "var"))

    def load(bn):
        bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                            "running_mean": torch.from_numpy(mean0),
                            "running_var": torch.from_numpy(var0),
                            "num_batches_tracked": torch.tensor(0)})
        return bn.train()

    ours = load(cls(C))
    out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), np.asarray(y), atol=1e-5)
    new_mean, new_var = ours.new_stats
    np.testing.assert_allclose(new_mean.numpy(), want_mean, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), want_var, atol=1e-6)
    # the buffers are left for the caller (flax returns them as state)
    assert torch.equal(ours.running_var, torch.from_numpy(var0))

    ref = load(stock(C))
    ref(torch.from_numpy(x))
    assert float(np.abs(ref.running_var.numpy() - want_var).max()) > 1e-3
    # eval mode: F.batch_norm on the running statistics, as the stock module
    ours.eval(), ref.eval()
    ref.load_state_dict(ours.state_dict())
    assert torch.equal(ours(torch.from_numpy(x)), ref(torch.from_numpy(x)))
