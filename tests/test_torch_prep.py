"""The port's preprocessing tools and utilities against the JAX package's,
on the CPU.

Both packages run on the same MJPG ``.avi`` (written here with cv2) and
wav, each with its own ``FaceDetector`` at the same threshold: the 99.9th
percentile of the JAX detector's face scores on the video's frames (seeded
frames score far below the default 0.9). What they write must be equal:
the face sidecars of ``face_extractor`` (a first pass and a resuming one),
``lrw_preprocess.preprocess_clip``'s json, and ``wild_preprocess.
write_segment``'s json, JPEG stack (``_face.npz``) and ``.done`` marker.
Its mel is held as power, within 1e-5 of its largest value (an f32 DFT's
error is relative to the largest bin, as in ``tests/test_torch_corpora.py``).
The resampled wavs are equal files. No step needs ffmpeg: the segment's
wav lies beside it. The acquisition tools run their mocked cases as
``tests/test_acquisition.py`` runs the JAX package's.
"""

import bz2
import json
import os
import pickle
import urllib.parse

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from lip2speech_tpu.detect import FaceDetector as JFaceDetector
from lip2speech_tpu.prep import face_extractor as j_extractor
from lip2speech_tpu.prep import lrw_preprocess as j_lrw
from lip2speech_tpu.prep import resample as j_resample
from lip2speech_tpu.prep import speaker_preprocess as j_speaker
from lip2speech_tpu.prep import wild_downloader as j_wild_dl
from lip2speech_tpu.prep import wild_preprocess as j_wild
from lip2speech_torch.detect import FaceDetector
from lip2speech_torch.prep import avspeech_acquire as av
from lip2speech_torch.prep import detector_demo, face_extractor, lrw_preprocess, resample
from lip2speech_torch.prep import speaker_preprocess, wild_downloader, wild_preprocess
from lip2speech_torch.prep.common import require_ffmpeg, require_network
from lip2speech_torch.utils import model_hash, setup_logger
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FRAMES = 8
SIZE = 128
MEL_REL = 1e-5


def write_video(path: str, n: int = FRAMES, seed: int = 0):
    """An MJPG .avi at 25 fps of random frames, the last quarter blurred."""
    rng = np.random.RandomState(seed)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (SIZE, SIZE))
    for i in range(n):
        f = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        out.write(cv2.GaussianBlur(f, (0, 0), 4) if i >= 3 * n // 4 else f)
    out.release()


def read_frames(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(video path, the two detectors at the shared threshold)."""
    root = tmp_path_factory.mktemp("clip")
    video = str(root / "clip.avi")
    write_video(video)
    jdet = JFaceDetector()
    frames = read_frames(video)
    assert len(frames) == FRAMES
    scores = np.asarray(jdet.detect_fn(jnp.asarray(FaceDetector.detector_input(frames)))["scores"])
    jdet.threshold = float(np.percentile(scores[..., 1], 99.9))
    det = FaceDetector(threshold=jdet.threshold, device="cpu")
    return video, jdet, det


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_face_extractor_sidecars_match_jax(clip, tmp_path):
    video, jdet, det = clip
    out = {}
    for name, mod, d in (("jax", j_extractor, jdet), ("torch", face_extractor, det)):
        sidecar = str(tmp_path / f"{name}.json")
        n = mod.extract_faces_for_video(d, video, sidecar, batch_size=3)
        out[name] = (n, read(sidecar))
    assert out["torch"] == out["jax"]
    info = json.loads(out["torch"][1])
    assert 0 < len(info) < FRAMES
    assert all(len(v["landmarks"]) == 68 for v in info.values())
    # resuming: the frames already in the sidecar are not detected again
    calls = []

    def counting(frames):
        calls.append(len(frames))
        return det(frames)

    n = face_extractor.extract_faces_for_video(counting, video, str(tmp_path / "torch.json"),
                                               batch_size=3)
    assert n == len(info) and sum(calls) == FRAMES - len(info)
    assert read(str(tmp_path / "torch.json")) == out["jax"][1]


def test_face_extractor_cli_matches_jax(clip, tmp_path):
    """``python -m ...prep.face_extractor --root <dir> --device cpu`` and the
    JAX tool, each at its default threshold, on the same video."""
    video, _, _ = clip
    for name in ("jax", "torch"):
        os.makedirs(tmp_path / name)
        os.link(video, tmp_path / name / "clip.avi")
    j_extractor.main(["--root", str(tmp_path / "jax"), "--batch_size", "8"])
    face_extractor.main(["--root", str(tmp_path / "torch"), "--batch_size", "8", "--device", "cpu"])
    assert read(str(tmp_path / "torch" / "clip.json")) == read(str(tmp_path / "jax" / "clip.json"))


def test_lrw_preprocess_clip_matches_jax(clip, tmp_path):
    video, jdet, det = clip
    nj = j_lrw.preprocess_clip(video, jdet, None, str(tmp_path / "jax" / "w" / "c.json"))
    nt = lrw_preprocess.preprocess_clip(video, det, None, str(tmp_path / "torch" / "w" / "c.json"))
    assert nt == nj > 0
    assert read(str(tmp_path / "torch" / "w" / "c.json")) == read(str(tmp_path / "jax" / "w" / "c.json"))


def test_wild_write_segment_matches_jax(clip, tmp_path):
    video, jdet, det = clip
    rng = np.random.RandomState(8)
    t = np.arange(32000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * (200 + 400 * t) * t) + 0.05 * rng.randn(32000))
    for name, mod, d in (("jax", j_wild, jdet), ("torch", wild_preprocess, det)):
        os.makedirs(tmp_path / name)
        seg = str(tmp_path / name / "seg_00000.avi")
        os.link(video, seg)
        wavfile.write(str(tmp_path / name / "seg_00000.wav"), 16000, audio.astype(np.float32))
        assert mod.write_segment(seg, d) is True
    stem = {k: str(tmp_path / k / "seg_00000") for k in ("jax", "torch")}
    for ext in (".json", "_face.npz", ".done"):
        assert read(stem["torch"] + ext) == read(stem["jax"] + ext), ext
    faces = pickle.loads(bz2.decompress(read(stem["torch"] + "_face.npz")))
    assert len(faces) == len(json.loads(read(stem["torch"] + ".json")))
    got, want = (np.load(stem[k] + ".npz")["data"] for k in ("torch", "jax"))
    assert got.shape == want.shape == (1, 80, 126)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0,
                               atol=MEL_REL * np.exp(want).max())
    # a finished segment is not processed again
    assert wild_preprocess.write_segment(stem["torch"] + ".avi", None) is True


def test_speaker_frames_and_demo(clip, tmp_path):
    video, _, _ = clip
    counts = []
    for name, mod in (("jax", j_speaker), ("torch", speaker_preprocess)):
        os.makedirs(tmp_path / name)
        os.link(video, tmp_path / name / "clip.avi")
        counts.append(mod.video_to_frames(str(tmp_path / name / "clip.avi")))
    assert counts == [FRAMES, FRAMES]
    for i in range(FRAMES):
        assert read(str(tmp_path / "torch" / "clip" / "frames" / f"{i}.jpg")) == \
            read(str(tmp_path / "jax" / "clip" / "frames" / f"{i}.jpg"))
    out = str(tmp_path / "demo")
    n = detector_demo.main(["--video", video, "--out", out, "--max_frames", "3", "--device", "cpu"])
    assert n == 3 and sorted(os.listdir(out)) == ["00000.jpg", "00001.jpg", "00002.jpg"]


def test_resample_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    for name in ("jax", "torch"):
        os.makedirs(tmp_path / name / "sub")
        wavfile.write(str(tmp_path / name / "sub" / "a.wav"), 22050,
                      (0.1 * rng.randn(22050)).astype(np.float32))
        wavfile.write(str(tmp_path / name / "b.wav"), 16000, np.zeros(160, np.int16))
        rng = np.random.RandomState(9)
    assert j_resample.convert_sampling_rate(str(tmp_path / "jax")) == 1
    assert resample.convert_sampling_rate(str(tmp_path / "torch")) == 1
    for rel in ("sub/a.wav", "b.wav"):
        assert read(str(tmp_path / "torch" / rel)) == read(str(tmp_path / "jax" / rel))
    assert wavfile.read(str(tmp_path / "torch" / "sub" / "a.wav"))[0] == 16000


def test_setup_logger_dumps_source(tmp_path):
    model = torch.nn.Linear(3, 2)
    logger, mdir = setup_logger(model, base_dir=str(tmp_path))
    try:
        logger.info("hello")
        assert mdir == os.path.join(str(tmp_path), model_hash(model))
        logs = [f for f in os.listdir(mdir) if f.endswith(".log")]
        assert len(logs) == 1
        text = read(os.path.join(mdir, logs[0])).decode()
        assert "MODEL SOURCE" in text and "class Linear" in text and "hello" in text
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_gates():
    require_network("t", probe=lambda: True)
    with pytest.raises(RuntimeError, match="probe"):
        require_network("t", probe=lambda: False)
    if not any(os.access(os.path.join(p, "ffmpeg"), os.X_OK)
               for p in os.environ.get("PATH", "").split(os.pathsep)):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            require_ffmpeg()


# ---------------------------------------------------------------------------
# acquisition, every network and subprocess boundary mocked
# ---------------------------------------------------------------------------


def _write_csv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")


def test_avspeech_csv_and_request_url(tmp_path):
    p = str(tmp_path / "avspeech_train.csv")
    _write_csv(p, [("idA", 1.0, 4.0, 0.5, 0.5), ("idB", 0.0, 3.0, 0.1, 0.9),
                   ("idA", 2.0, 5.0, 0.2, 0.2)])
    infos = av.read_avspeech_csv(p)
    assert set(infos) == {"idA", "idB"}
    assert infos["idA"].start_time == 2.0 and infos["idB"].face_point == (0.1, 0.9)
    assert infos["idA"].stem() == "idA_2_5"
    url = av.build_videos_request_url(["a1", "b2"], api_key="KEY")
    parsed = urllib.parse.urlparse(url)
    assert (parsed.scheme, parsed.netloc, parsed.path) == ("https", "www.googleapis.com",
                                                           "/youtube/v3/videos")
    assert urllib.parse.parse_qs(parsed.query) == {"part": ["snippet"], "id": ["a1,b2"],
                                                   "key": ["KEY"]}
    with pytest.raises(AssertionError):
        av.build_videos_request_url([f"v{i}" for i in range(51)], "KEY")
    resp = {"items": [
        {"id": "a", "snippet": {"defaultAudioLanguage": "en"}},
        {"id": "b", "snippet": {"defaultLanguage": "en-US"}},
        {"id": "c", "snippet": {"defaultAudioLanguage": "fr"}},
        {"id": "d", "snippet": {}},
        {"id": "e", "snippet": {"defaultLanguage": "EN"}},
    ]}
    assert av.parse_snippet_response(resp) == ["a", "b", "e"]
    assert av.parse_snippet_response(resp, language="fr") == ["c"]


def test_avspeech_scrape_batches_filters_and_pickles(tmp_path):
    csv = str(tmp_path / "avspeech_test.csv")
    _write_csv(csv, [(f"v{i:03d}", i, i + 3.0, 0.5, 0.5) for i in range(120)])
    out = str(tmp_path / "test.pickle")
    calls = []

    def fake_fetch(url):
        ids = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)["id"][0].split(",")
        calls.append(len(ids))
        return {"items": [{"id": y, "snippet": {"defaultAudioLanguage": "en"}}
                          for y in ids if int(y[1:]) % 3 == 0]}

    kept = av.scrape_metadata(csv, "K", out, fetch_json=fake_fetch)
    assert calls == [50, 50, 20] and len(kept) == 40
    with open(out, "rb") as f:
        assert [v.yt_id for v in pickle.load(f)] == [v.yt_id for v in kept]


def test_avspeech_download_recipe(tmp_path):
    seen = {}

    def fake_run(args):
        seen["args"] = args
        return "https://cdn.example/stream.mp4\n"

    assert av.resolve_stream_url("abc123", run=fake_run) == "https://cdn.example/stream.mp4"
    a = seen["args"]
    assert "-g" in a and a[a.index("-f") + 1] == "22/18" and a[-1].endswith("watch?v=abc123")
    with pytest.raises(RuntimeError, match="no stream url"):
        av.resolve_stream_url("abc123", run=lambda a: "ERROR: private video")
    video, audio = av.ffmpeg_cut_args("http://u/s.mp4", av.VidInfo("vid", 12.5, 18.0),
                                      str(tmp_path))
    for args in (video, audio):
        assert args[args.index("-ss") + 1] == "12.5" and args[args.index("-to") + 1] == "18"
    assert video[video.index("-c:v") + 1] == "libx264" and "-an" in video
    assert video[-1] == os.path.join(str(tmp_path), "vid_12.5_18.mp4")
    assert audio[audio.index("-c:a") + 1] == "pcm_s16le" and "-vn" in audio
    ff_calls = []
    out = av.download_clip(av.VidInfo("x", 0.0, 2.0), str(tmp_path),
                           resolver=lambda y: f"http://cdn/{y}", run_ff=ff_calls.append)
    assert len(ff_calls) == 2 and out.endswith("x_0_2.mp4")
    infos = [av.VidInfo(f"v{i}", 0.0, 1.0) for i in range(5)]
    pkl = str(tmp_path / "list.pickle")
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)

    def flaky(info, out_dir):
        if info.yt_id in ("v1", "v3"):
            raise RuntimeError("geo-blocked")

    assert av.download_list(pkl, str(tmp_path / "out"), workers=2, download=flaky) == ["v1", "v3"]


def test_wild_downloader(tmp_path):
    assert wild_downloader.DEFAULT_IDS == j_wild_dl.DEFAULT_IDS
    ids = wild_downloader.read_id_file(wild_downloader.DEFAULT_IDS)
    assert len(ids) == 113 and all(len(y) == 11 for y in ids)
    cmd = wild_downloader.ytdl_command(["abc", "def"], "/data/DL", ytdl_bin="youtube-dl")
    assert cmd == j_wild_dl.ytdl_command(["abc", "def"], "/data/DL", ytdl_bin="youtube-dl")
    id_file = str(tmp_path / "ids.txt")
    with open(id_file, "w") as f:
        f.write("one\n\ntwo\n")
    calls = []
    assert wild_downloader.download_videos(id_file, str(tmp_path / "dl"), run=calls.append) == \
        ["one", "two"]
    assert len(calls) == 1 and calls[0][-1].endswith("watch?v=two")
