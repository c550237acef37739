"""The port's auxiliary audio encoders (``models/audio_extras.py``) against
the JAX package's, on the CPU, on the same seeded weights carried across by
``weights.named_from_flax``: ``Wav2VecFeatureExtractor``, ``AudioExtractor``
and ``SpecEncoder`` (eval mode on the running statistics, and train mode
with its new statistics) within 1e-5 relative L2 in f32 (``REL``). The
GELU is flax's default tanh approximation; the exact one is shown to
differ by more than that.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lip2speech_tpu.models import audio_extras as jextras
from lip2speech_torch import weights
from lip2speech_torch.models import audio_extras
from torch_port_common import FAST_COMPILE, fill_tree, rel_l2, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
B, SAMPLES, FREQS, FRAMES = 2, 4000, 65, 24


def _pair(name):
    rng = np.random.RandomState(0)
    if name == "spec":
        jm, port = jextras.SpecEncoder(), audio_extras.SpecEncoder(FREQS)
        x = np.abs(rng.randn(B, FREQS, FRAMES)).astype(np.float32)
    else:
        jm, port = ((jextras.AudioExtractor(), audio_extras.AudioExtractor()) if name == "audio"
                    else (jextras.Wav2VecFeatureExtractor(), audio_extras.Wav2VecFeatureExtractor()))
        x = (0.3 * rng.randn(B, SAMPLES)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    v = to_plain(fill_tree(shapes, 1))
    port.load_state_dict(weights.named_from_flax(v["params"], v.get("batch_stats")), strict=True)
    return jm, v, port, x


@pytest.mark.parametrize("name", ["wav2vec", "audio", "spec"])
def test_audio_extras_match_jax(name):
    jm, v, port, x = _pair(name)
    want = jax.jit(functools.partial(jm.apply, train=False), compiler_options=FAST_COMPILE)(v, x)
    with torch.no_grad():
        got = port.eval()(t(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= REL


def test_spec_encoder_train_mode_matches_jax():
    jm, v, port, x = _pair("spec")
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
                        compiler_options=FAST_COMPILE)(v, x)
    got = port.train()(t(x))
    assert rel_l2(got.detach(), want) <= REL
    new = weights.named_from_flax({}, to_plain(upd["batch_stats"]))
    for i in range(4):
        mean, var = getattr(port, f"bn_{i}").new_stats
        assert rel_l2(mean, new[f"bn_{i}.running_mean"]) <= REL
        assert rel_l2(var, new[f"bn_{i}.running_var"]) <= REL


def test_gelu_is_the_tanh_approximation():
    x = jnp.linspace(-4.0, 4.0, 101)
    want = np.asarray(jax.nn.gelu(x))  # flax's nn.gelu default
    got = F.gelu(t(x), approximate="tanh")
    assert rel_l2(got, want) <= REL
    assert rel_l2(F.gelu(t(x)), want) > REL
