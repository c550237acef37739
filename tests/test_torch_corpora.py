"""The port's WILD, GRID and AVSpeech readers and the host face alignment
against the JAX package's, on the CPU.

The port's fixture writers (``data/fixtures.py``) make each corpus once;
both packages read the same files. With the same seed and cv2, the first 8
draws of each reader must be equal to the bit (``mouth``, ``faces``,
``audio``), the streaming readers with their flip turned on. The JAX WILD
reader decodes its face stacks on its cv2 path (its libjpeg module is
patched out, as in ``tests/test_torch_data.py``). The landmarks of the
fixtures tilt the eye line, so the alignment rotates. The 2-second bucket
(50 frames, 32000 samples, 126 mel frames) goes through both packages'
``collate`` and ``prepare_batch``: the mel (as power) within 1e-5 of its largest value,
since the fixture's chirp is loud and an f32 DFT's error is relative to
the largest bin. The streaming cursor is also driven by the
threaded ``Loader`` with 4 workers: no window is read twice and a broken
clip's ``reset_item`` does not deadlock.
"""

import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

import lip2speech_tpu.native
from lip2speech_tpu import config as jconfig
from lip2speech_tpu.data import FaceAugmentation as JFaceAugmentation
from lip2speech_tpu.data import collate as j_collate
from lip2speech_tpu.data import face_align as j_align
from lip2speech_tpu.data import prepare_batch as j_prepare_batch
from lip2speech_tpu.data.streaming import GRID as JGRID
from lip2speech_tpu.data.streaming import AVSpeech as JAVSpeech
from lip2speech_tpu.data.wild import WILD as JWILD
from lip2speech_tpu.data.wild import load_wav as j_load_wav
from lip2speech_torch import config as tconfig
from lip2speech_torch import data as tdata
from lip2speech_torch.data import face_align
from lip2speech_torch.data.collate import collate, prepare_batch, to_device
from lip2speech_torch.data.wild import load_wav
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DRAWS = 8
# the 2-second bucket of WILD's segments: 50 frames, 2 s of audio, 126 mels
BUCKET = dict(max_video_frames=50, max_audio_samples=32000, max_mel_frames=126)
MEL_REL = 1e-5


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpora"))
    tdata.make_sample_wild(os.path.join(root, "wild"), n_clips=3, seed=1)
    tdata.make_sample_streaming(os.path.join(root, "grid"), n_clips=3, seed=2)
    tdata.make_sample_streaming(os.path.join(root, "avspeech", "test"), n_clips=3, ext=".mp4",
                                seed=3)
    return root


@pytest.fixture
def jax_cv2(monkeypatch):
    """The JAX reader on its cv2 path."""
    monkeypatch.setattr(lip2speech_tpu.native, "decode_jpeg_stack_native", lambda bufs: None)


def test_fixture_layouts(corpora):
    files = sorted(os.listdir(os.path.join(corpora, "wild")))
    assert files[:4] == ["seg00000.json", "seg00000.mp4", "seg00000.wav", "seg00000_face.npz"]
    assert sorted(os.listdir(os.path.join(corpora, "grid")))[:3] == [
        "clip00000.avi", "clip00000.json", "clip00000.wav"]
    assert "clip00000.mp4" in os.listdir(os.path.join(corpora, "avspeech", "test"))
    sr, wav = load_wav(os.path.join(corpora, "grid", "clip00000.wav"))
    assert sr == 16000 and wav.dtype == np.float32 and wav.shape == (32000,)


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32", "stereo"])
def test_load_wav_matches_jax(tmp_path, dtype):
    from scipy.io import wavfile

    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (400, 2) if dtype == "stereo" else 400)
    data = {"int16": (x * 32767).astype(np.int16), "int32": (x * 2**31 * 0.99).astype(np.int32),
            "uint8": ((x + 1) * 127.5).astype(np.uint8)}.get(dtype, x.astype(np.float32))
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 16000, data)
    (sr, got), (jsr, want) = load_wav(path), j_load_wav(path)
    assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
    assert got.shape == (400,) and np.array_equal(got, want)


def test_alignment_matches_jax_at_a_tilted_eye_line(corpora):
    import cv2

    with open(os.path.join(corpora, "grid", "clip00001.json")) as f:
        info = json.load(f)
    cap = cv2.VideoCapture(os.path.join(corpora, "grid", "clip00001.avi"))
    for i in range(3):
        ok, frame = cap.read()
        assert ok
        rgb = frame[:, :, ::-1]
        lm, box = info[str(i)]["landmarks"], info[str(i)]["face_coords"]
        angle = face_align.eye_angle_degrees(lm)
        assert angle == j_align.eye_angle_degrees(lm) and abs(angle) > 5.0
        got = face_align.align_and_crop_face(rgb, box, lm)
        assert np.array_equal(got, j_align.align_and_crop_face(rgb, box, lm))
        x1, y1, x2, y2 = box
        assert got.shape == (y2 - y1, x2 - x1, 3)
        assert not np.array_equal(got, rgb[y1:y2, x1:x2])  # it rotated
    cap.release()
    empty = np.zeros((0, 0, 3), np.uint8)
    assert face_align.align_and_crop_face(rgb, (5, 5, 5, 9), lm).size == empty.size


def _readers(name, root):
    """(port reader, JAX reader) over the same files and seeds."""
    seed = np.random.default_rng
    if name == "WILD":
        return (tdata.WILD(root, "train", tconfig.DataConfig(), tdata.FaceAugmentation(rng=seed(5)),
                           seed(0)),
                JWILD(root, "train", jconfig.DataConfig(), JFaceAugmentation(rng=seed(5)), seed(0)))
    port, jax_ = {"GRID": (tdata.GRID, JGRID), "AVSpeech": (tdata.AVSpeech, JAVSpeech)}[name]
    return (port(root, mode="test", cfg=tconfig.DataConfig(), augmentation=tdata.FaceAugmentation(),
                 rng=seed(0)),
            jax_(root, mode="test", cfg=jconfig.DataConfig(), augmentation=JFaceAugmentation(),
                 rng=seed(0)))


@pytest.mark.parametrize("name,sub", [("WILD", "wild"), ("GRID", "grid"), ("AVSpeech", "avspeech")])
def test_reader_matches_jax_bit_for_bit(corpora, jax_cv2, name, sub):
    port, jax_ = _readers(name, os.path.join(corpora, sub))
    assert len(port) == len(jax_) == 3 and port.items == jax_.items
    lengths = set()
    for i in range(DRAWS):
        got, want = port[i % len(port)], jax_[i % len(jax_)]
        assert got["path"] == want["path"]
        for k in ("mouth", "faces", "audio"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)
        assert got["faces"].shape == (2, 160, 160, 3) and got["mouth"].shape[1:] == (96, 96, 3)
        lengths.add(got["mouth"].shape[0])
    if name != "WILD":  # windows of several lengths were drawn
        assert len(lengths) > 1


def test_two_second_bucket_collate_and_prepare_match_jax(corpora):
    """WILD's segments at the 2-second bucket through both packages' collate
    and prepare_batch (small mouth and face sizes keep it cheap)."""
    small = dict(BUCKET, mouth_size=(24, 24), face_size=(32, 32))
    td, jd = tconfig.DataConfig(**small), jconfig.DataConfig(**small)
    ds = tdata.WILD(os.path.join(corpora, "wild"), "train", td, rng=np.random.default_rng(0))
    samples = [ds[i] for i in range(2)]
    t_raw, j_raw = collate(samples, td), j_collate(samples, jd)
    for k, v in j_raw.items():
        assert np.array_equal(t_raw[k], v), k
    got = prepare_batch(to_device(t_raw, "cpu"), tconfig.AudioConfig(), td)
    want = j_prepare_batch({k: jnp.asarray(v) for k, v in j_raw.items()}, jconfig.AudioConfig(), jd)
    assert got["mel"].shape == (2, 80, 126) and tuple(want["mel"].shape) == (2, 80, 126)
    assert got["video"].shape[1] == 50 and got["mel_lengths"].tolist() == [126, 126]
    # a loud chirp: the f32 DFT's error is relative to the largest bin, so the
    # log-mel's quiet bins move by more than 1e-4; hold the linear mel
    lin_got, lin_want = np.exp(got["mel"].numpy()), np.exp(np.asarray(want["mel"]))
    assert np.abs(lin_got - lin_want).max() <= MEL_REL * lin_want.max()
    for k in ("gate", "mel_mask", "mel_lengths", "video_lengths"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("name,sub", [("WILD", "wild"), ("GRID", "grid"),
                                      ("AVSpeech", "avspeech")])
def test_get_dataset_takes_the_train_cli_arguments(corpora, name, sub):
    """``cli.train`` builds the reader as the JAX CLI does
    (``lip2speech_tpu/cli/train.py:120-127``): mode, config, augmentation."""
    ds = tdata.get_dataset(name, os.path.join(corpora, sub), mode="test", cfg=tconfig.DataConfig(),
                           augmentation=tdata.FaceAugmentation())
    assert len(ds) == 3 and ds[0]["faces"].shape == (2, 160, 160, 3)


class _Recording(tdata.GRID):
    """GRID that records every clip it opens and every window it reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.clips, self.windows = [], []

    def _next_clip(self):
        super()._next_clip()
        self.clips.append(os.path.basename(self._clip[0]))

    def _read_frames(self, video, start, dur):
        self.windows.append((os.path.basename(video), round(start, 6)))
        return super()._read_frames(video, start, dur)


def test_streaming_cursor_under_four_loader_threads(tmp_path):
    """Four loader threads share one cursor: over fewer windows than one
    pass through the clips, no window is read twice, and a clip that does
    not decode goes through ``reset_item`` without a deadlock."""
    root = str(tmp_path)
    tdata.make_sample_streaming(root, n_clips=10, n_frames=50, frame_hw=(64, 64), seed=4)
    cfg = tconfig.DataConfig(mouth_size=(24, 24), face_size=(32, 32), max_video_frames=29)
    ds = _Recording(root, mode="train", cfg=cfg, rng=np.random.default_rng(0), samples_per_epoch=16)
    broken = ds.items[ds._order[0]][0]  # the cursor's first clip
    with open(broken, "wb") as f:
        f.write(b"not a video")
    broken = os.path.basename(broken)
    batches, errors = [], []

    def run():
        try:
            batches.extend(tdata.Loader(ds, 4, cfg, num_workers=4, seed=0))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not worker.is_alive(), "the loader hung"
    assert not errors, errors
    assert len(batches) == 4
    # a window that starts at the clip's very end reads no frame and is
    # replaced too, so at least one window per sample
    assert len(ds.windows) >= 16 and len(set(ds.windows)) == len(ds.windows)
    # the broken clip was opened first, then replaced
    assert ds.clips[0] == broken and broken not in ds.clips[1:]
    assert all(w[0] != broken for w in ds.windows)


def test_reset_item_gives_up_after_16(tmp_path):
    root = str(tmp_path)
    tdata.make_sample_streaming(root, n_clips=1, n_frames=10, frame_hw=(32, 32))
    with open(os.path.join(root, "clip00000.avi"), "wb") as f:
        f.write(b"not a video")
    ds = tdata.GRID(root, cfg=tconfig.DataConfig(), rng=np.random.default_rng(0))
    for _ in range(2):  # the depth is restored after a failure
        with pytest.raises(RuntimeError, match="too many consecutive"):
            ds[0]
        assert ds._depth == 0


def test_avspeech_face_and_collate_match_jax(tmp_path):
    """The first 8 ``AVSpeechFace`` samples and their ``collate_speaker``
    batch, bit for bit; the clips are shorter than 2 s, so the window is
    cut to the clip and the batch padded."""
    from lip2speech_tpu.speaker.dataset import AVSpeechFace as JAVSpeechFace
    from lip2speech_tpu.speaker.dataset import collate_speaker as j_collate_speaker
    from lip2speech_torch.speaker.dataset import AVSpeechFace, collate_speaker

    root = str(tmp_path)
    tdata.make_sample_avspeech_face(root, "train", n_clips=3, n_frames=40, frame_hw=(96, 96),
                                    seed=6)
    port = AVSpeechFace(root, "train", tconfig.DataConfig(), rng=np.random.default_rng(0))
    jax_ = JAVSpeechFace(root, "train", jconfig.DataConfig(), rng=np.random.default_rng(0))
    assert len(port) == len(jax_) == 3 and port.items == jax_.items
    got, want = [port[i % 3] for i in range(DRAWS)], [jax_[i % 3] for i in range(DRAWS)]
    for g, w in zip(got, want):
        for k in ("speech", "face"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["face"].shape == (160, 160, 3) and 8000 <= g["speech"].shape[0] <= 32000
    gb, wb = collate_speaker(got), j_collate_speaker(want)
    assert set(gb) == set(wb) == {"speech", "faces_u8"}
    for k, v in wb.items():
        assert gb[k].dtype == v.dtype and np.array_equal(gb[k], v), k
    assert gb["speech"].shape == (DRAWS, 32000)
