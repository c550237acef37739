"""The port's evaluation path against the JAX package, on the CPU.

- The eval forward (eval mode, ground-truth mels, ``tf_ratio=1``) decodes
  through ``ar_decode`` (its plain version on the CPU) for the mels'
  ``M`` steps; it is held against the JAX decoder's
  ``apply(..., mels, 1.0, train=False)`` and against the port's own eager
  teacher-forced loop.
- ``evaluate_net`` on the synthetic LRW fixture, f32, against the JAX
  package's ``evaluate_net``: the JAX Griffin-Lim phases are rebuilt from
  its keys and handed in, and the content codebook is zeroed (then its
  gumbel draw does not matter), so both sides compute the same function.
  The face crops are drawn with a generator that always picks frame 0: the
  JAX evaluation reads with eight loader threads, and with a real draw
  which clip got which crop would depend on thread timing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu import data as jdata
from lip2speech_tpu.config import Config as JConfig
from lip2speech_tpu.config import TrainConfig as JTrainConfig
from lip2speech_tpu.eval import evaluate as jeval
from lip2speech_tpu.models.decoder import Decoder as JDecoder
from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
from lip2speech_torch import data as tdata
from lip2speech_torch import weights
from lip2speech_torch.config import Config, TrainConfig
from lip2speech_torch.data.collate import collate, prepare_batch, to_device
from lip2speech_torch.eval import evaluate
from lip2speech_torch.kernels import ar_decode as ar
from lip2speech_torch.models.decoder import Decoder
from lip2speech_torch.models.lip2speech import Lip2Speech
from torch_port_common import FAST_COMPILE, fill_tree, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the decoder's eval forward, 24 recurrent f32 steps: the tolerance of
# tests/test_torch_decoder.py (summation order only); the postnet adds five
# 5-tap convs, scaled by the mel magnitude
AR_TOL = dict(atol=2e-4, rtol=1e-3)
POSTNET_TOL = dict(atol=1e-3, rtol=1e-3)
# evaluate_net, f32, the whole small model on the fixture (77 decoder
# steps, 32 Griffin-Lim iterations): waveforms within 1e-3 relative L2 of
# the JAX package's (the Griffin-Lim loop carries the model's f32
# differences), and the mean ESTOI within 1e-4
WAV_REL = 1e-3
ESTOI_TOL = 1e-4
GL_ITERS = 32
SEED = 5


class FirstFrame:
    """A generator whose uniform draws are all 0: every face crop is frame 0."""

    def random(self, n):
        return np.zeros(n)


@pytest.fixture(scope="module")
def decoder_outputs():
    """JAX decoder apply with mels (tf 1, eval) and the port's eval forward,
    eager loop and kernel route, on the same weights and gumbel draw."""
    jc, tc = small_configs()
    B, T, M = 2, 14, 24  # M above max_decoder_steps: the positions extend
    rng = np.random.RandomState(0)
    enc_in = (rng.randn(B, T, jc.encoder_embedding_dim) * 0.3).astype(np.float32)
    face = (rng.randn(B, jc.face_embedding_dim) * 0.3).astype(np.float32)
    mels = rng.randn(B, jc.n_mels, M).astype(np.float32)
    model = JDecoder(jc)
    rngs = {"gumbel": jax.random.PRNGKey(2), "teacher": jax.random.PRNGKey(3)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, enc_in, face, mels, 1.0, rngs, train=False))
    v = to_plain(fill_tree(shapes, 0))
    want = jax.jit(lambda v, e, f, m: model.apply(v, e, f, m, 1.0, rngs, train=False),
                   compiler_options=FAST_COMPILE)(v, enc_in, face, mels)
    S = want["content_dist"].shape[0] // B
    gumbel = jax.random.gumbel(rngs["gumbel"], (B * S, jc.content_vocab_size), jnp.float32)

    sd = weights.from_flax({"params": {"decoder": v["params"]},
                            "batch_stats": {"decoder": v["batch_stats"]}}, tc)
    dec = Decoder(tc).eval()
    dec.load_state_dict({k[len("decoder."):]: x for k, x in sd.items()}, strict=True)
    with torch.no_grad():
        before = ar.launches
        got = dec(t(enc_in), t(face), gumbel=t(gumbel), mels=t(mels), tf_ratio=1.0)
        assert ar.launches == before  # the CPU runs the kernel's plain version
        enc = dec.encode(t(enc_in), t(face), t(gumbel))
        eager = dec._teacher_forced(enc, t(mels), 1.0, {}, None)
    return want, got, eager


@pytest.mark.parametrize("name", ["mel", "gate", "attention"])
def test_eval_forward_matches_jax(decoder_outputs, name):
    want, got, _ = decoder_outputs
    assert got[name].shape == want[name].shape
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **AR_TOL)


def test_eval_forward_postnet_and_lengths_match_jax(decoder_outputs):
    want, got, _ = decoder_outputs
    np.testing.assert_allclose(got["mel_postnet"].numpy(), np.asarray(want["mel_postnet"]),
                               **POSTNET_TOL)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


@pytest.mark.parametrize("name", ["mel", "mel_postnet", "gate", "attention"])
def test_kernel_route_matches_the_eager_loop(decoder_outputs, name):
    """The rewiring changes nothing: the eager teacher-forced loop with no
    teacher frame computes what the decode does."""
    _, got, eager = decoder_outputs
    np.testing.assert_allclose(got[name].numpy(), eager[name].numpy(),
                               **(POSTNET_TOL if name == "mel_postnet" else AR_TOL))


def test_train_mode_and_partial_teacher_forcing_keep_the_eager_loop(monkeypatch):
    """Only the eval forward with tf_ratio >= 1 takes the decode."""
    _, tc = small_configs()
    dec = Decoder(tc)
    calls = []
    monkeypatch.setattr(Decoder, "_free_running", lambda self, *a: calls.append(a) or {})
    monkeypatch.setattr(Decoder, "_teacher_forced", lambda self, *a: calls.append("tf") or {
        "gate": torch.zeros(1, 3, 1)})
    x, f, m = torch.zeros(1, 7, tc.encoder_embedding_dim), torch.zeros(1, 256), torch.zeros(1, 80, 3)
    for training, tf in ((True, 1.0), (False, 0.5)):
        dec.train(training)
        dec(x, f, mels=m, tf_ratio=tf)
    assert calls == ["tf", "tf"]


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """The small model in both packages (f32, codebook zeroed) and the
    fixture's test split (3 clips, batches of 2: the second is padded)."""
    jc, tc = small_configs(max_decoder_steps=24)
    root = str(tmp_path_factory.mktemp("lrw_eval"))
    tdata.make_sample_lrw(root, n_clips=3)
    jm = JLip2Speech(jc)
    keys = {"gumbel": jax.random.PRNGKey(1), "teacher": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 96, 96, 3)),
        jnp.zeros((1, 2, 160, 160, 3)), jnp.zeros((1, 80, 8)), 1.0, None, keys, train=False))
    v = to_plain(fill_tree(shapes, 1))
    content = v["params"]["decoder"]["content"]
    content["word_embeddings"] = np.zeros_like(content["word_embeddings"])
    model = Lip2Speech(tc)
    model.load_state_dict(weights.from_flax(v, tc), strict=True)
    jcfg = JConfig(model=jc, train=JTrainConfig(bf16=False))
    cfg = Config(model=tc, train=TrainConfig(bf16=False))
    jds = jdata.get_dataset("LRW", root, mode="test", cfg=jcfg.data, rng=FirstFrame())
    tds = tdata.get_dataset("LRW", root, mode="test", cfg=cfg.data, rng=FirstFrame())
    return jm, v, jcfg, jds, model, cfg, tds


def _jax_thetas(n_batches: int, B: int, n_freqs: int, M: int):
    """The Griffin-Lim phases JAX's evaluate_net draws: batch i's key is the
    i-th split of PRNGKey(seed) (evaluate.py), its phase uniform in
    [-pi, pi) (griffin_lim.py)."""
    key = jax.random.PRNGKey(SEED)
    out = []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, (B, n_freqs, M), minval=-jnp.pi, maxval=jnp.pi))))
    return out


def test_evaluate_net_matches_jax(eval_setup, monkeypatch):
    jm, v, jcfg, jds, model, cfg, tds = eval_setup
    B = 2
    # the JAX evaluation's programs, built (and memoised for its
    # evaluate_net) at XLA's backend level 0: half the compile time
    jit = jax.jit
    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", lambda fn, **kw: jit(fn, compiler_options=FAST_COMPILE, **kw))
        forward_invert, _ = jeval._build_eval_fns(jm, jcfg, GL_ITERS, "estoi", None, SEED)
    samples = [tds[i] for i in range(B)]
    raw = collate(samples, cfg.data)
    batch = prepare_batch(to_device(raw, "cpu"), cfg.audio, cfg.data)
    M = batch["mel"].shape[-1]
    thetas = _jax_thetas(2, B, cfg.audio.n_freqs, M)

    # the first batch's waveforms
    jbatch = jdata.prepare_batch({k: jnp.asarray(x) for k, x in raw.items()}, jcfg.audio,
                                 jcfg.data)
    want_wav = np.asarray(forward_invert(v, jbatch, jax.random.split(jax.random.PRNGKey(SEED))[1]))
    program = evaluate.eval_program(model, cfg, GL_ITERS, "estoi")
    mel = program.forward(batch, program.weights(), SEED)["mel_postnet"]
    got_wav = program.invert(mel, thetas[0], None).numpy()
    assert got_wav.shape == want_wav.shape == (B, (M - 1) * cfg.audio.hop_length)
    rel = np.linalg.norm(got_wav - want_wav) / np.linalg.norm(want_wav)
    assert rel < WAV_REL, rel

    # the mean ESTOI over the split, the ragged batch padded
    want = jeval.evaluate_net(jm, v, jds, jcfg, batch_size=B, n_gl_iters=GL_ITERS, seed=SEED)
    stats = {}
    got = evaluate.evaluate_net(model, tds, cfg, batch_size=B, n_gl_iters=GL_ITERS, seed=SEED,
                                thetas=thetas, stats=stats)
    assert stats["batches"] == 2 and len(stats["scores"]) == 3
    assert abs(got - want) < ESTOI_TOL, (got, want)


def test_eval_program_is_built_once(eval_setup):
    *_, model, cfg, _ = eval_setup
    assert evaluate.eval_program(model, cfg, GL_ITERS, "estoi") is evaluate.eval_program(
        model, cfg, GL_ITERS, "estoi")


def test_evaluate_net_bf16_draws_its_own_phases(eval_setup):
    """The bf16 policy and the seeded phases: finite, in range, the same
    seed gives the same score, and the batched metric (device_estoi)
    scores the same waveforms as the host's within 1e-5."""
    *_, model, cfg, tds = eval_setup
    import dataclasses

    cfg16 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=True))

    def run(**kw):
        return evaluate.evaluate_net(model, tds, cfg16, batch_size=2, n_gl_iters=2, seed=1,
                                     max_batches=1, **kw)

    a, b, dev = run(), run(), run(device_estoi=True)
    assert np.isfinite(a) and -1.0 <= a <= 1.0 and a == b
    assert abs(dev - a) < 1e-5
    assert all(p.dtype == torch.float32 for p in model.parameters())
