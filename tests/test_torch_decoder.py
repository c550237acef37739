"""The port's decoder (plain AR loop on the CPU) against the JAX ``Decoder``.

Both sides get the same seeded weights (through ``weights.from_flax``), the
same encoder features and the same gumbel draw of the content codebook,
and run in f32. The AR loop is compared at the tolerance of
tests/test_pallas_decoder.py (atol 2e-4, rtol 1e-3): 16 recurrent steps of
f32 products whose only difference is the summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.models import layers as jlayers
from lip2speech_tpu.models.decoder import Decoder as JDecoder
from lip2speech_tpu.models.decoder import adaptive_avg_pool_matrix as j_pool_matrix
from lip2speech_torch import weights
from lip2speech_torch.models import layers
from lip2speech_torch.models.decoder import Decoder, adaptive_avg_pool_matrix
from torch_port_common import fill_tree, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

AR_TOL = dict(atol=2e-4, rtol=1e-3)


def _run_both(T: int, B: int = 2, seed: int = 0):
    """JAX and port decoder outputs on the same weights, inputs and noise."""
    jc, tc = small_configs()
    rng = np.random.RandomState(seed)
    enc_in = (rng.randn(B, T, jc.encoder_embedding_dim) * 0.3).astype(np.float32)
    face = (rng.randn(B, jc.face_embedding_dim) * 0.3).astype(np.float32)
    model = JDecoder(jc)
    key = jax.random.PRNGKey(seed + 2)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, enc_in, face, None, 1.0, {"gumbel": key}, train=False))
    v = to_plain(fill_tree(shapes, seed))
    want = model.apply(v, jnp.asarray(enc_in), jnp.asarray(face), None, 1.0, {"gumbel": key},
                       train=False)
    S = want["content_dist"].shape[0] // B
    # the draw ContentEncoder makes from the same key (decoder.py:218)
    gumbel = jax.random.gumbel(key, (B * S, jc.content_vocab_size), jnp.float32)

    sd = weights.from_flax({"params": {"decoder": v["params"]},
                            "batch_stats": {"decoder": v["batch_stats"]}}, tc)
    dec = Decoder(tc).eval()
    dec.load_state_dict({k[len("decoder."):]: x for k, x in sd.items()}, strict=True)
    with torch.no_grad():
        got = dec(t(enc_in), t(face), gumbel=t(gumbel))
    return want, got


@pytest.fixture(scope="module")
def outputs():
    return _run_both(T=14)


@pytest.mark.parametrize("name", ["mel", "gate", "attention"])
def test_ar_loop_matches_jax_scan(outputs, name):
    want, got = outputs
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **AR_TOL)


def test_postnet_content_and_lengths_match_jax(outputs):
    want, got = outputs
    # the postnet adds five 5-tap convs over the AR output: same f32 budget,
    # scaled by the mel magnitude
    np.testing.assert_allclose(got["mel_postnet"].numpy(), np.asarray(want["mel_postnet"]),
                               atol=1e-3, rtol=1e-3)
    # the codebook distribution is computed before the loop: plain f32
    np.testing.assert_allclose(got["content_dist"].numpy(), np.asarray(want["content_dist"]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


def test_short_clip_pads_the_content_scales():
    """T=5 < 7: the k=7 aggregation scale is padded up to one frame."""
    want, got = _run_both(T=5, B=1, seed=3)
    assert got["content_dist"].shape == want["content_dist"].shape
    for name in ("mel", "gate", "attention"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **AR_TOL)


@pytest.mark.parametrize("in_len,out_len", [(29, 4), (14, 2), (5, 1), (7, 3)])
def test_adaptive_avg_pool_matrix(in_len, out_len):
    np.testing.assert_array_equal(adaptive_avg_pool_matrix(in_len, out_len),
                                  j_pool_matrix(in_len, out_len))


def test_sinusoid_table_and_lstm_cell_match_jax():
    np.testing.assert_array_equal(layers.sinusoid_table(300, 512), jlayers.sinusoid_table(300, 512))
    rng = np.random.RandomState(0)
    x, h, c = (rng.randn(3, 16).astype(np.float32) for _ in range(3))
    wx, wh = (rng.randn(16, 64).astype(np.float32) * 0.25 for _ in range(2))
    b = rng.randn(64).astype(np.float32) * 0.1
    jh, jc = jlayers.lstm_cell_step({"wx": wx, "wh": wh, "b": b}, x, h, c)
    ph, pc = layers.lstm_cell_step(t(wx), t(wh), t(b), t(x), t(h), t(c))
    # one 32-term f32 product per gate
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
