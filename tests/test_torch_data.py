"""The port's LRW data path against the JAX package's, on the CPU.

The same seed writes the synthetic fixture through both packages; the
port's JPEG reader, ``LRW`` samples and ``Loader`` batches must equal the
JAX package's. The JAX reader decodes through its libjpeg module where it
builds and through cv2 otherwise, the port through cv2 alone: the tests
force the JAX reader's cv2 path for bit-exact comparisons, and hold its
libjpeg path to within one uint8 level (an IDCT rounding). Loader parity
uses one worker: with more, which clip gets which random crop depends on
thread timing.
"""

import filecmp
import os
import threading
import time

import numpy as np
import pytest

import lip2speech_tpu.native
from lip2speech_tpu import data as jdata
from lip2speech_tpu.config import DataConfig as JDataConfig
from lip2speech_torch import data as tdata
from lip2speech_torch.config import DataConfig
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the native libjpeg decoder against cv2: one uint8 level (IDCT rounding)
NATIVE_TOL = 1
N_TRAIN = 6


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX fixture root, port fixture root), same seeds."""
    out = []
    for name, make in (("jax", jdata.make_sample_lrw), ("torch", tdata.make_sample_lrw)):
        root = str(tmp_path_factory.mktemp(f"lrw_{name}"))
        make(root, split="train", n_clips=N_TRAIN, seed=1)
        make(root, split="test", n_clips=3, seed=2)
        out.append(root)
    return tuple(out)


@pytest.fixture
def jax_cv2(monkeypatch):
    """The JAX reader on its cv2 path."""
    monkeypatch.setattr(lip2speech_tpu.native, "decode_jpeg_stack_native", lambda bufs: None)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fixture_matches_jax(roots):
    """The JPEG stacks are the same bytes; the audio (an .npz, whose zip
    entries carry a time stamp) decodes to the same arrays."""
    jroot, troot = roots
    files = _files(jroot)
    assert files == _files(troot) and len(files) == 3 * (N_TRAIN + 3)
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
        if rel.startswith("lipread_audio"):
            np.testing.assert_array_equal(np.load(a)["data"], np.load(b)["data"])
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


@pytest.mark.parametrize("kind", ["mouth", "face"])
def test_load_jpeg_stack_matches_jax(roots, monkeypatch, kind):
    from lip2speech_tpu.data.lrw import load_jpeg_stack as jax_load

    path = os.path.join(roots[1], "LRW_Faces", "ABOUT", "train", f"ABOUT_00002_{kind}.npz")
    got = tdata.load_jpeg_stack(path)
    assert got.dtype == np.uint8 and got.shape[0] == 29 and got.flags.c_contiguous
    if lip2speech_tpu.native.get_lib() is not None:
        native = jax_load(path)
        assert np.abs(native.astype(np.int16) - got).max() <= NATIVE_TOL
    monkeypatch.setattr(lip2speech_tpu.native, "decode_jpeg_stack_native", lambda bufs: None)
    np.testing.assert_array_equal(got, jax_load(path))


def test_load_jpeg_stack_raises_on_a_bad_frame(tmp_path):
    import bz2
    import pickle

    path = tmp_path / "bad.npz"
    path.write_bytes(bz2.compress(pickle.dumps([np.frombuffer(b"not a jpeg", np.uint8)])))
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        tdata.load_jpeg_stack(str(path))


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert os.path.basename(got[k]) == os.path.basename(want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


@pytest.mark.parametrize("cache", [0, 1 << 30])
def test_lrw_getitem_matches_jax(roots, jax_cv2, cache):
    jroot, troot = roots
    theirs = jdata.LRW(jroot, mode="train", cfg=JDataConfig(), rng=np.random.default_rng(3),
                       cache_bytes=cache)
    ours = tdata.LRW(troot, mode="train", cfg=DataConfig(), rng=np.random.default_rng(3),
                     cache_bytes=cache)
    assert len(ours) == len(theirs) == N_TRAIN
    for idx in (0, 4, 0):
        got, want = ours[idx], theirs[idx]
        assert got["mouth"].shape == (29, 96, 96, 3) and got["faces"].shape == (2, 160, 160, 3)
        _assert_same(got, want)


@pytest.mark.parametrize("augment", [False, True])
def test_loader_first_batches_match_jax(roots, jax_cv2, augment):
    jroot, troot = roots

    def batches(pkg, root, cfg):
        aug = pkg.FaceAugmentation(rng=np.random.default_rng(7)) if augment else None
        ds = pkg.LRW(root, mode="train", cfg=cfg, augmentation=aug, rng=np.random.default_rng(3))
        it = iter(pkg.Loader(ds, 2, cfg, shuffle=True, num_workers=1, seed=11, infinite=True))
        out = [next(it), next(it)]
        it.close()
        return out

    got = batches(tdata, troot, DataConfig())
    want = batches(jdata, jroot, JDataConfig())
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_loader_ragged_tail_and_len(roots):
    ds = tdata.LRW(roots[1], mode="train", cfg=DataConfig())
    loader = tdata.Loader(ds, 4, DataConfig(), shuffle=False, drop_last=False, num_workers=2)
    sizes = [b["mouth_u8"].shape[0] for b in loader]
    assert sizes == [4, 2] and len(loader) == 2
    assert loader.stats["batches"] == 2 and loader.stats["host_s"] > 0
    assert len(tdata.Loader(ds, 4, DataConfig(), drop_last=True)) == 1


def test_loader_pinned_batches_are_tensors(roots, monkeypatch):
    import torch

    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)  # no card here
    ds = tdata.LRW(roots[1], mode="test", cfg=DataConfig())
    batch = next(iter(tdata.Loader(ds, 3, DataConfig(), num_workers=1, pin_memory=True)))
    assert all(torch.is_tensor(v) for v in batch.values())
    assert batch["mouth_u8"].shape == (3, 29, 96, 96, 3)


def test_loader_raises_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("corrupt clip")

    with pytest.raises(RuntimeError, match="Loader worker failed") as info:
        next(iter(tdata.Loader(Broken(), 2, DataConfig(), num_workers=2)))
    assert isinstance(info.value.__cause__, ValueError)


def test_loader_early_break_leaks_no_thread(roots):
    ds = tdata.LRW(roots[1], mode="train", cfg=DataConfig())
    before = threading.active_count()
    for _ in range(3):
        for _batch in tdata.Loader(ds, 1, DataConfig(), num_workers=2, infinite=True, prefetch=1):
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_get_dataset():
    for name, reader in (("LRW", tdata.LRW), ("WILD", tdata.WILD), ("GRID", tdata.GRID),
                         ("AVSpeech", tdata.AVSpeech), ("avspeech", tdata.AVSpeech)):
        ds = tdata.get_dataset(name, "/nonexistent", mode="test")
        assert type(ds) is reader and not ds.items
    with pytest.raises(ValueError):
        tdata.get_dataset("nope", "/nonexistent")


def test_face_augmentation_flips_every_frame():
    aug = tdata.FaceAugmentation(p_flip=1.0, rng=np.random.default_rng(1))
    mouth = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    m2, f2 = aug(mouth, mouth.copy())
    np.testing.assert_array_equal(m2, mouth[:, :, ::-1, :])
    np.testing.assert_array_equal(f2, mouth[:, :, ::-1, :])
