"""The voice speaker encoder, the demo CLI and ``synthesize --from_lrw`` of
the port against the JAX package, on the CPU.

- ``melspectrogram(log=False)`` with the speaker encoder's 400/160/40
  settings, and ``SpeakerEncoder`` (embedding and ``inference``) on seeded
  weights carried across by ``weights.speaker_from_flax``;
- the ``speaker_encoder.*`` part of a combined reference checkpoint loads
  into ``SpeakerEncoder`` with ``strict=True``;
- the voice-conditioned inference: waveform -> speaker embedding ->
  ``Lip2Speech`` (small config, no face net) -> mels, with the gumbel draw
  handed to the port as JAX drew it;
- ``cli.demo --device cpu`` (face and voice) writes the files the JAX
  package's demo writes (tests/test_eval_cli.py:99-118);
- ``cli.synthesize --from_lrw``: the frames equal the JAX ``load_frames``
  (the JAX reader's cv2 JPEG path forced, face crops from a generator that
  picks frame 0), and the CLI writes a finite waveform.

Tolerances, with reasons: the power mel rtol 1e-4 of the largest value (a
400-point DFT as a product, summed in another order); the speaker
embedding 1e-5 of its largest value (three 40->256 LSTM layers over 51
frames, f32); the voice-conditioned mels the pipeline test's AR budget
(tests/test_torch_pipeline.py: atol 5e-4, rtol 1e-3; the postnet atol
2e-3), as the speaker embedding enters the same 16-step recurrence.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import lip2speech_tpu.data
import lip2speech_tpu.native
from lip2speech_tpu.cli import synthesize as jsynth
from lip2speech_tpu.config import Config as JConfig
from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
from lip2speech_tpu.models.speaker import SPEAKER_AUDIO_CFG as J_SPEAKER_AUDIO_CFG
from lip2speech_tpu.models.speaker import SpeakerEncoder as JSpeakerEncoder
from lip2speech_tpu.ops import mel as jmel
from lip2speech_torch import weights
from lip2speech_torch.cli import demo, synthesize
from lip2speech_torch.config import Config
from lip2speech_torch.data import LRW, make_sample_lrw
from lip2speech_torch.models.lip2speech import Lip2Speech
from lip2speech_torch.models.speaker import SPEAKER_AUDIO_CFG, SpeakerEncoder
from lip2speech_torch.ops.mel import melspectrogram
from torch_port_common import FAST_COMPILE, fill_tree, rel_err, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEL_TOL, EMB_TOL = 1e-4, 1e-5
AR_TOL = dict(atol=5e-4, rtol=1e-3)
POSTNET_TOL = dict(atol=2e-3, rtol=1e-3)
B, T, SAMPLES = 2, 10, 8000
FRAMES, CLIP_SAMPLES = 12, 8192
DATA = dict(mouth_size=(48, 48), face_size=(80, 80), max_video_frames=FRAMES,
            max_audio_samples=CLIP_SAMPLES)


def _waveform(seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = np.arange(SAMPLES) / 16000.0
    tone = np.sin(2 * np.pi * (150 + 100 * rng.rand(B, 1)) * n)
    return (0.3 * tone + 0.05 * rng.randn(B, SAMPLES)).astype(np.float32)


@pytest.fixture(scope="module")
def speakers():
    """(JAX module, its variables, the port's encoder on the same weights)."""
    jc, tc = small_configs()
    enc = JSpeakerEncoder(jc)
    wav = _waveform()
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), wav))
    v = to_plain(fill_tree(shapes, 1))
    port = SpeakerEncoder(tc).eval()
    port.load_state_dict(weights.speaker_from_flax(v["params"]), strict=True)
    return enc, v, port


def test_power_mel_matches_jax():
    assert SPEAKER_AUDIO_CFG == type(SPEAKER_AUDIO_CFG)(**vars(J_SPEAKER_AUDIO_CFG))
    wav = _waveform()
    want = np.asarray(jax.jit(lambda w: jmel.melspectrogram(w, J_SPEAKER_AUDIO_CFG, log=False),
                              compiler_options=FAST_COMPILE)(wav))
    got = melspectrogram(t(wav), SPEAKER_AUDIO_CFG, log=False)
    assert got.shape == want.shape == (B, 40, SAMPLES // 160 + 1)
    assert rel_err(got, t(want)) <= MEL_TOL
    assert float(got.min()) >= 0.0  # a power mel: no log


@pytest.mark.parametrize("method", ["embedding", "inference"])
def test_speaker_encoder_matches_jax(speakers, method):
    enc, v, port = speakers
    wav = _waveform(1)
    fn = JSpeakerEncoder.inference if method == "inference" else JSpeakerEncoder.__call__
    want = jax.jit(lambda v, w: enc.apply(v, w, method=fn), compiler_options=FAST_COMPILE)(v, wav)
    with torch.no_grad():
        got = port.inference(t(wav)) if method == "inference" else port(t(wav))
    assert got.shape == (B, 256)
    assert rel_err(got, t(want)) <= EMB_TOL
    if method == "inference":
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_reference_speaker_state_dict_loads_strictly(speakers, tmp_path):
    """A combined reference checkpoint: ``load_reference_pth`` (what
    ``cli.common.load_model`` reads) hands back the ``speaker_encoder.*``
    part, which loads with ``strict=True`` and gives the same encoder."""
    _, _, port = speakers
    blob = {"state_dict": {"decoder.BOS": torch.zeros(1, 1, 80),
                           **{f"speaker_encoder.{k}": v for k, v in port.state_dict().items()}}}
    torch.save(blob, tmp_path / "combined.pth")
    main, speaker_sd = weights.load_reference_pth(str(tmp_path / "combined.pth"))
    assert set(main) == {"decoder.BOS"}
    assert set(speaker_sd) == {f"lstm.{w}_l{i}" for w in ("weight_ih", "weight_hh", "bias_ih",
                                                         "bias_hh") for i in range(3)} | {
        "linear.weight", "linear.bias"}
    other = SpeakerEncoder(Config().model)
    other.load_state_dict(speaker_sd, strict=True)
    wav = t(_waveform(2))
    with torch.no_grad():
        torch.testing.assert_close(other.inference(wav), port.inference(wav), rtol=0, atol=0)


def test_voice_conditioned_inference_matches_jax(speakers):
    enc, sv, port = speakers
    jc, tc = small_configs()
    rng = np.random.RandomState(3)
    video = rng.randn(B, T, 32, 32, 3).astype(np.float32)
    wav = _waveform(3)
    key = jax.random.PRNGKey(13)
    jm = JLip2Speech(jc)
    spk0 = np.zeros((B, jc.face_embedding_dim), np.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, video, None, None,
                                            1.0, spk0, {"gumbel": key}, train=False))
    v = to_plain(fill_tree(shapes, 3))

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def infer(v, sv, video, wav):
        spk = enc.apply(sv, wav, method=JSpeakerEncoder.inference)
        return jm.apply(v, video, None, None, 1.0, spk, {"gumbel": key}, train=False)

    want = infer(v, sv, video, wav)
    S = want["content_dist"].shape[0] // B
    gumbel = jax.random.gumbel(key, (B * S, jc.content_vocab_size), jnp.float32)
    model = Lip2Speech(tc, face_net=False)
    model.load_state_dict(weights.from_flax(v, tc), strict=True)
    with torch.no_grad():
        got = model(t(video), None, speaker_embedding=port.inference(t(wav)), gumbel=t(gumbel))
    assert rel_err(got["speaker_embedding"], t(want["speaker_embedding"])) <= EMB_TOL
    for name in ("mel", "gate", "attention"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **AR_TOL)
    np.testing.assert_allclose(got["mel_postnet"].numpy(), np.asarray(want["mel_postnet"]),
                               **POSTNET_TOL)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lrw_demo"))
    make_sample_lrw(root, split="test", n_clips=3, n_frames=FRAMES, n_samples=CLIP_SAMPLES)
    return root


def _overrides(data: bool = True) -> list[str]:
    """``--override`` arguments for the small model (24 decoder steps) and,
    with ``data``, the fixture's frame sizes."""
    jc, _ = small_configs(max_decoder_steps=24)
    items = [("model." + f, getattr(jc, f)) for f in jc.__dataclass_fields__
             if getattr(jc, f) != getattr(type(jc)(), f)]
    items += [("data." + k, x) for k, x in DATA.items()] if data else []
    return [a for k, x in items for a in ("--override", f"{k}={x}")]


@pytest.mark.parametrize("encoding", ["face", "voice"])
def test_demo_cli_writes_artifacts(root, tmp_path, encoding):
    out = str(tmp_path / "demo_out")
    clips = demo.main(["--root", root, "--device", "cpu", "--encoding", encoding, "--n_clips",
                       "2", "--out", out, "--gl_iters", "4", *_overrides()])
    assert len(clips) == 2
    files = set(os.listdir(out))
    for i in range(2):
        assert {f"clip{i}_gt.wav", f"clip{i}_gt_gl.wav", f"clip{i}_pred.wav",
                f"mel_predicted_{i}.png", f"mel_target_{i}.png", f"alignment_{i}.png",
                f"gate_{i}.png"} <= files
        for name in ("gt", "gt_gl", "pred"):
            sr, wav = wavfile.read(os.path.join(out, f"clip{i}_{name}.wav"))
            assert sr == 16000 and len(wav) > 0 and np.isfinite(wav).all(), name
        # cut at the stop step, as the JAX demo cuts (the 24 frames' waveform is 23 hops)
        assert len(wavfile.read(os.path.join(out, f"clip{i}_pred.wav"))[1]) == \
            min(clips[i]["stop_step"], 23) * 256
    assert not any(f.startswith("clip2") for f in files)


class FirstFrame:
    """A generator whose uniform draws are all 0: every face crop is frame 0."""

    def random(self, n):
        return np.zeros(n)


def test_synthesize_from_lrw(root, tmp_path, monkeypatch):
    monkeypatch.setattr(lip2speech_tpu.native, "decode_jpeg_stack_native", lambda bufs: None)
    monkeypatch.setattr(lip2speech_tpu.data, "LRW",
                        functools.partial(lip2speech_tpu.data.LRW, rng=FirstFrame()))
    monkeypatch.setattr(synthesize, "LRW", functools.partial(LRW, rng=FirstFrame()))
    argv = ["--from_lrw", root, "--n_clips", "4", "--out", str(tmp_path / "s.wav")]
    cfg = Config()
    want = jsynth.load_frames(jsynth.parse_args(argv), JConfig())
    got = synthesize.load_frames(synthesize.parse_args(argv), cfg)
    assert got[0].shape == (4 * FRAMES, 96, 96, 3) and got[1].shape == (2, 160, 160, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    wav = synthesize.main([*argv, "--device", "cpu", "--gl_iters", "2",
                           *_overrides(data=False)])
    sr, written = wavfile.read(str(tmp_path / "s.wav"))
    assert sr == 16000 and len(written) == len(wav) > 0 and np.isfinite(written).all()
