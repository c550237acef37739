"""The port's DSP (STFT/ISTFT, mel inversion, Griffin-Lim) against JAX.

Both sides run the same DFT-as-matmul algorithm in f32; they differ only
in summation order, so the STFT family matches to ~1e-5 of its scale.
Griffin-Lim gets the JAX draw of the initial phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.config import AudioConfig as JAudioConfig
from lip2speech_tpu.ops import griffin_lim as jgl
from lip2speech_tpu.ops import mel as jmel
from lip2speech_tpu.ops import stft as jstft
from lip2speech_torch.config import AudioConfig
from lip2speech_torch.ops import griffin_lim as gl
from lip2speech_torch.ops import mel
from lip2speech_torch.ops import stft
from torch_port_common import t
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ACFG, JACFG = AudioConfig(), JAudioConfig()


def _wave(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    return (0.3 * rng.randn(2, n)).astype(np.float32)


def _log_mel(frames=12, seed=1):
    rng = np.random.RandomState(seed)
    return rng.uniform(-8.0, 1.0, (2, ACFG.n_mels, frames)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (400, 160)])
def test_frame_signal_and_overlap_add(n_fft, hop):
    x = _wave()
    got = stft.frame_signal(t(x), n_fft, hop).numpy()
    want = np.asarray(jstft.frame_signal(jnp.asarray(x), n_fft, hop))
    np.testing.assert_array_equal(got, want)  # a gather: exact
    # overlap-add is a sum of up to n_fft/hop terms: f32 rounding only
    np.testing.assert_allclose(
        stft._overlap_add(t(want), hop, n_fft).numpy(),
        np.asarray(jstft._overlap_add(jnp.asarray(want), hop, n_fft)), atol=1e-5, rtol=1e-6)


def test_stft_istft_matmul():
    x = _wave()
    re, im = stft.stft_matmul(t(x))
    jre, jim = jstft.stft_matmul(jnp.asarray(x))
    # 1024-term f32 dot products over O(1) spectra
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-4, rtol=1e-4)
    y = stft.istft_matmul(re, im, length=x.shape[-1]).numpy()
    jy = np.asarray(jstft.istft_matmul(jre, jim, length=x.shape[-1]))
    np.testing.assert_allclose(y, jy, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(y, x, atol=1e-4)  # a round trip


def test_mel_filterbank_and_nnls():
    fb = mel.mel_filterbank(ACFG.n_freqs, ACFG.n_mels, ACFG.sample_rate, ACFG.fmin, ACFG.fmax)
    np.testing.assert_array_equal(
        fb, jmel.mel_filterbank(JACFG.n_freqs, JACFG.n_mels, JACFG.sample_rate, JACFG.fmin, JACFG.fmax))
    power = np.exp(_log_mel())
    got = mel.mel_to_linear(t(power), ACFG).numpy()
    want = np.asarray(jmel.mel_to_linear(jnp.asarray(power), JACFG))
    # 16 multiplicative updates of (n_freqs x n_freqs) products: relative f32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6 * np.abs(want).max())


def test_griffin_lim_with_injected_phase():
    log_mel = _log_mel()
    key = jax.random.PRNGKey(3)
    n_iter = 3
    want = np.asarray(jgl.mel_to_audio(jnp.asarray(log_mel), key, JACFG, n_iter=n_iter))
    # the JAX draw of the initial phase, exactly as griffin_lim makes it
    theta = jax.random.uniform(key, (2, JACFG.n_freqs, log_mel.shape[-1]),
                               minval=-jnp.pi, maxval=jnp.pi)
    got = gl.mel_to_audio(t(log_mel), ACFG, n_iter=n_iter, theta=t(theta)).numpy()
    assert got.shape == want.shape == (2, (log_mel.shape[-1] - 1) * ACFG.hop_length)
    # three STFT/ISTFT round trips with unit-phase renormalisation
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=1e-3)


def test_griffin_lim_generator_is_seeded():
    lin = torch.rand(1, ACFG.n_freqs, 6, generator=torch.Generator().manual_seed(0))
    a = gl.griffin_lim(lin, ACFG, n_iter=2, generator=torch.Generator().manual_seed(5))
    b = gl.griffin_lim(lin, ACFG, n_iter=2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
