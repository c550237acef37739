"""The port's bf16 eval forward against the JAX package's.

The eval forward (eval mode, ground-truth mels, ``tf_ratio=1``) of the
small decoder, M=24 steps, with bf16 weights and bf16 inputs on both sides:
the port decodes through ``ar_decode`` (its plain version on the CPU),
which keeps the recurrent state in f32 as the AR kernel does, while the
JAX decoder's ``lax.scan`` carries it in bf16
(``lip2speech_tpu/models/decoder.py:476-485``). So the two differ by bf16
rounding, not by the f32 summation order of tests/test_torch_eval.py.

Tolerance, with its reason: for each of mel, mel_postnet, gate and
attention, the relative L2 gap between the port and JAX in bf16 is at most
``FACTOR`` = 2 times JAX's own gap between its bf16 and its f32 forward on
the same inputs, the measure of bf16 rounding on this path (measured: the
port's gap is 0.41, 0.81, 0.80 and 0.96 of JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.models.decoder import Decoder as JDecoder
from lip2speech_torch import weights
from lip2speech_torch.models.decoder import Decoder
from torch_port_common import FAST_COMPILE, fill_tree, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FACTOR = 2.0
NAMES = ("mel", "mel_postnet", "gate", "attention")


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def outputs():
    """(JAX f32, JAX bf16, the port's bf16) eval forwards on the same
    weights, inputs and gumbel draw."""
    jc, tc = small_configs()
    B, T, M = 2, 14, 24
    rng = np.random.RandomState(0)
    enc_in = (rng.randn(B, T, jc.encoder_embedding_dim) * 0.3).astype(np.float32)
    face = (rng.randn(B, jc.face_embedding_dim) * 0.3).astype(np.float32)
    mels = rng.randn(B, jc.n_mels, M).astype(np.float32)
    model = JDecoder(jc)
    rngs = {"gumbel": jax.random.PRNGKey(2), "teacher": jax.random.PRNGKey(3)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, enc_in, face, mels, 1.0, rngs, train=False))
    v = to_plain(fill_tree(shapes, 0))
    apply = jax.jit(lambda v, e, f, m: model.apply(v, e, f, m, 1.0, rngs, train=False),
                    compiler_options=FAST_COMPILE)
    bf16 = lambda x: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), x)  # noqa: E731
    want32 = apply(v, enc_in, face, mels)
    want16 = apply(bf16(v), *bf16((enc_in, face, mels)))
    S = want32["content_dist"].shape[0] // B
    gumbel = jax.random.gumbel(rngs["gumbel"], (B * S, jc.content_vocab_size), jnp.float32)

    sd = weights.from_flax({"params": {"decoder": v["params"]},
                            "batch_stats": {"decoder": v["batch_stats"]}}, tc)
    dec = Decoder(tc).eval()
    dec.load_state_dict({k[len("decoder."):]: x for k, x in sd.items()}, strict=True)
    dec = dec.to(torch.bfloat16)
    h = torch.bfloat16
    with torch.no_grad():
        got = dec(t(enc_in).to(h), t(face).to(h), gumbel=t(gumbel), mels=t(mels).to(h),
                  tf_ratio=1.0)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return ({k: f32(want32[k]) for k in NAMES}, {k: f32(want16[k]) for k in NAMES},
            {k: got[k].float().numpy() for k in NAMES})


@pytest.mark.parametrize("name", NAMES)
def test_bf16_eval_forward_within_jax_bf16_gap(outputs, name):
    want32, want16, got = outputs
    assert got[name].shape == want16[name].shape
    assert np.isfinite(got[name]).all()
    jax_gap = _rel_l2(want16[name], want32[name])
    assert 0.0 < jax_gap < 0.1  # bf16 rounding, not a broken run
    assert _rel_l2(got[name], want16[name]) <= FACTOR * jax_gap, (
        _rel_l2(got[name], want16[name]), jax_gap)
