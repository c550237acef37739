"""The port's slice end to end against the JAX package: mouth video + face
crops -> ``Lip2Speech`` -> mel_postnet and lengths -> NNLS + Griffin-Lim ->
waveform, with the gumbel draw and the Griffin-Lim phase handed to the port
as JAX drew them. Also the long-video chunking and the synthesis CLI on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.config import AudioConfig as JAudioConfig
from lip2speech_tpu.eval import long_video as jlong
from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
from lip2speech_tpu.ops import griffin_lim as jgl
from lip2speech_torch import weights
from lip2speech_torch.cli import synthesize
from lip2speech_torch.config import AudioConfig, Config
from lip2speech_torch.eval import long_video
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.ops.griffin_lim import mel_to_audio
from torch_port_common import fill_tree, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GL_ITERS = 2
B, T = 2, 10


def _jax_and_port(face_net: bool, seed: int):
    jc, tc = small_configs()
    rng = np.random.RandomState(seed)
    video = rng.randn(B, T, 32, 32, 3).astype(np.float32)
    faces = rng.randn(B, 2, 80, 80, 3).astype(np.float32) if face_net else None
    spk = None
    if not face_net:
        spk = np.abs(rng.randn(B, jc.face_embedding_dim)).astype(np.float32)
        spk /= np.linalg.norm(spk, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(seed + 10)
    jm = JLip2Speech(jc)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, video, faces, None, 1.0, spk, {"gumbel": key},
        train=False))
    v = to_plain(fill_tree(shapes, seed))
    # jitted: XLA runs the small model in a quarter of the eager time
    want = jax.jit(lambda v, video, faces, spk: jm.apply(
        v, video, faces, None, 1.0, spk, {"gumbel": key}, train=False))(v, video, faces, spk)
    S = want["content_dist"].shape[0] // B
    gumbel = jax.random.gumbel(key, (B * S, jc.content_vocab_size), jnp.float32)

    model = Lip2Speech(tc, face_net=face_net)
    model.load_state_dict(weights.from_flax(v, tc), strict=True)
    got = model(t(video), None if faces is None else t(faces),
                speaker_embedding=None if spk is None else t(spk), gumbel=t(gumbel))
    return want, got


@pytest.fixture(scope="module")
def slice_outputs():
    return _jax_and_port(face_net=True, seed=0)


def test_slice_mels_and_lengths_match_jax(slice_outputs):
    want, got = slice_outputs
    # unit-norm encoder outputs feed a 16-step f32 recurrence: the decoder
    # test's AR budget (atol 2e-4, rtol 1e-3), a little wider for the
    # encoders' rounding that enters the loop
    for name in ("mel", "gate", "attention"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got["mel_postnet"].numpy(), np.asarray(want["mel_postnet"]),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["speaker_embedding"].numpy(),
                               np.asarray(want["speaker_embedding"]), atol=1e-5)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


def test_slice_waveform_matches_jax(slice_outputs):
    want, got = slice_outputs
    mel_j = np.asarray(want["mel_postnet"])
    key = jax.random.PRNGKey(11)
    wav_j = np.asarray(jgl.mel_to_audio(jnp.asarray(mel_j), key, JAudioConfig(), n_iter=GL_ITERS))
    # the initial phase exactly as the JAX griffin_lim draws it
    theta = jax.random.uniform(key, (B, JAudioConfig().n_freqs, mel_j.shape[-1]),
                               minval=-jnp.pi, maxval=jnp.pi)
    wav = mel_to_audio(got["mel_postnet"], AudioConfig(), n_iter=GL_ITERS, theta=t(theta)).numpy()
    assert wav.shape == wav_j.shape and np.isfinite(wav).all()
    # the mels differ by <=2e-3 (log scale), exp() turns that into a
    # relative error of the same size; two GL round trips keep it
    scale = np.abs(wav_j).max()
    np.testing.assert_allclose(wav, wav_j, atol=1e-2 * scale)
    assert np.linalg.norm(wav - wav_j) < 5e-3 * np.linalg.norm(wav_j)


def test_speaker_embedding_replaces_the_face_net():
    want, got = _jax_and_port(face_net=False, seed=1)
    for name in ("mel", "gate", "attention"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


@pytest.mark.parametrize("frames", [1, 29, 30, 80, 1500])
def test_chunking_matches_jax(frames):
    video = np.arange(frames * 2 * 2 * 3, dtype=np.float32).reshape(frames, 2, 2, 3)
    chunks, tail = long_video.chunk_video(video, 29)
    jchunks, jtail = jlong.chunk_video(video, 29)
    np.testing.assert_array_equal(chunks, jchunks)
    assert tail == jtail
    assert long_video.chunk_mel_counts(len(chunks), 29, tail, 16000, 256) == \
        jlong.chunk_mel_counts(len(jchunks), 29, jtail, 16000, 256)


def _small_cfg() -> Config:
    _, tc = small_configs(max_decoder_steps=80)
    return Config(model=tc)


def test_synthesize_long_video_on_cpu():
    cfg = _small_cfg()
    model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    video = rng.randn(40, 48, 48, 3).astype(np.float32)  # two chunks
    faces = rng.randn(2, 80, 80, 3).astype(np.float32)
    wav, mel = long_video.synthesize_long_video(
        model, video, faces, cfg, torch.device("cpu"), torch.Generator().manual_seed(1),
        n_gl_iters=GL_ITERS, compute_dtype=None)
    counts = jlong.chunk_mel_counts(2, 29, 11, 16000, 256)
    assert mel.shape == (80, sum(counts))
    assert wav.shape == ((sum(counts) - 1) * 256,) and np.isfinite(wav).all()

    # the mel is each chunk's pro-rata prefix of one batched decode
    chunks, _ = long_video.chunk_video(video, 29)
    gen = torch.Generator().manual_seed(1)
    out = model(torch.as_tensor(chunks), torch.as_tensor(faces)[None].expand(2, -1, -1, -1, -1),
                generator=gen)
    ref = torch.cat([out["mel_postnet"][i, :, :m] for i, m in enumerate(counts)], dim=1)
    np.testing.assert_array_equal(mel, ref.numpy())


def test_synthesize_cli_on_cpu(tmp_path):
    from scipy.io import wavfile

    rng = np.random.RandomState(0)
    npz = tmp_path / "clip.npz"
    np.savez(npz, mouth=rng.randint(0, 256, (12, 48, 48, 3)).astype(np.uint8),
             faces=rng.randint(0, 256, (2, 80, 80, 3)).astype(np.uint8))
    out = tmp_path / "out.wav"
    overrides = [f"model.{k}={v}" for k, v in
                 dict(ffn_hidden_dim=128, content_vocab_size=33, content_latent_dim=64,
                      max_decoder_steps=40, postnet_embedding_dim=64, shufflenet_width=0.5).items()]
    argv = ["--frames_npz", str(npz), "--out", str(out), "--gl_iters", "2", "--device", "cpu"]
    for ov in overrides:
        argv += ["--override", ov]
    synthesize.main(argv)
    rate, wav = wavfile.read(out)
    n_mel = jlong.chunk_mel_counts(1, 29, 12, 16000, 256)[0]
    assert rate == 16000 and wav.shape == ((n_mel - 1) * 256,) and np.isfinite(wav).all()


def test_entry_points_default_to_cuda():
    from lip2speech_torch.models.layers import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
