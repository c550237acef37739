"""The port's (E)STOI and metric registry against the JAX package's, on the
CPU.

The host metrics are numpy float64 copies: within 1e-12 of the JAX
package's. The batched torch metrics compute in float64 and are held to
the host metrics within 1e-5, the bound of the JAX package's own
device-vs-host test (``tests/test_estoi_oracle.py``).
"""

import numpy as np
import pytest
import torch

import lip2speech_tpu.ops.estoi as jax_estoi
from lip2speech_torch.data import make_sample_lrw
from lip2speech_torch.eval import metrics
from lip2speech_torch.ops import estoi
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HOST_TOL = 1e-12
BATCH_TOL = 1e-5  # tests/test_estoi_oracle.py's device-vs-host bound
N = 19456


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(clean, degraded) (4, N) f64: fixture speech at SNRs 10, 5, 0, -5 dB,
    silence cut into the last two clips, as the JAX oracle test builds them."""
    root = str(tmp_path_factory.mktemp("lrw_estoi"))
    make_sample_lrw(root, n_clips=4)
    rng = np.random.RandomState(0)
    clean, deg = [], []
    for i in range(4):
        x = np.load(f"{root}/lipread_audio/ABOUT/test/ABOUT_{i + 1:05d}.npz")["data"].astype(np.float64)
        if i >= 2:
            x[4000:8000] = 0.0
        noise = rng.randn(N)
        noise *= np.sqrt((x ** 2).mean() / 10 ** ((10 - 5 * i) / 10) / (noise ** 2).mean())
        clean.append(x)
        deg.append(x + noise)
    return np.stack(clean), np.stack(deg)


@pytest.mark.parametrize("name", ["estoi", "stoi"])
def test_host_metric_matches_jax(pairs, name):
    clean, deg = pairs
    for c, d in zip(clean, deg):
        for other in (d, c, d[: N - 3000]):
            got = getattr(estoi, name)(c, other)
            want = getattr(jax_estoi, name)(c, other)
            assert abs(got - want) <= HOST_TOL, (got, want)
    assert getattr(estoi, name)(clean[0], clean[0]) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("name", ["estoi", "stoi"])
def test_batch_metric_matches_host(pairs, name):
    clean, deg = pairs
    lengths = np.array([N, N - 2500, N - 777, N])
    host = np.array([getattr(estoi, name)(c[:n], d[:n]) for c, d, n in zip(clean, deg, lengths)])
    got = getattr(estoi, f"{name}_batch")(torch.tensor(clean), torch.tensor(deg),
                                          torch.tensor(lengths))
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert np.abs(got.numpy() - host).max() < BATCH_TOL
    # float32 input (a waveform from the model) is scored in float64 as well
    got32 = getattr(estoi, f"{name}_batch")(torch.tensor(clean, dtype=torch.float32),
                                            torch.tensor(deg, dtype=torch.float32))
    host32 = np.array([getattr(estoi, name)(c, d) for c, d in
                       zip(clean.astype(np.float32), deg.astype(np.float32))])
    assert got32.dtype == torch.float64 and np.abs(got32.numpy() - host32).max() < BATCH_TOL


def test_batch_metric_too_short_returns_the_sentinel():
    rng = np.random.RandomState(0)
    x = np.zeros((2, 16000))
    x[:, :400] = rng.randn(2, 400)  # one burst, then silence
    y = x + 0.01 * rng.randn(2, 16000)
    assert estoi.estoi(x[0], y[0]) == pytest.approx(1e-5)
    for fn in (estoi.estoi_batch, estoi.stoi_batch):
        np.testing.assert_allclose(fn(torch.tensor(x), torch.tensor(y)).numpy(), 1e-5)
    short = torch.tensor(rng.randn(1, 3000))
    assert float(estoi.estoi_batch(short, short)[0]) == pytest.approx(1e-5)


def test_registry_and_waveform_metrics():
    rows = metrics.registry()
    assert set(rows) == {"estoi", "stoi", "pesq", "wer"}
    assert rows["estoi"]["available"] and rows["stoi"]["available"]
    assert metrics.get_waveform_metric("estoi") is estoi.estoi
    assert metrics.get_waveform_metric("stoi") is estoi.stoi
    with pytest.raises(KeyError):
        metrics.get_waveform_metric("mos")
    if not rows["pesq"]["available"]:
        with pytest.raises(metrics.MetricUnavailable, match="pip install pesq"):
            metrics.get_waveform_metric("pesq")
    if not rows["wer"]["available"]:
        with pytest.raises(metrics.MetricUnavailable):
            metrics.make_transcriber()


@pytest.mark.parametrize("ref, hyp, want", [
    ("a b c", "a b c", 0.0),
    ("a b c", "a x c", 1 / 3),
    ("a b c d", "a c d", 1 / 4),
    ("a c d", "a b c d", 1 / 3),
    ("a b", "a x b y", 1.0),
    ("a b", "x y", 1.0),
    ("", "", 0.0),
    ("", "a b", 2.0),
    (["token", "list"], ["token", "list"], 0.0),
    ("the quick brown fox jumps", "the brown ox jumped over", 4 / 5),
])
def test_word_error_rate(ref, hyp, want):
    from lip2speech_tpu.eval.metrics import word_error_rate as jax_wer

    assert metrics.word_error_rate(ref, hyp) == pytest.approx(want, abs=1e-12)
    assert metrics.word_error_rate(ref, hyp) == jax_wer(ref, hyp)
