"""The port's batched image ops (``lip2speech_torch/ops/image.py``) against
``lip2speech_tpu/ops/image.py`` on seeded numpy inputs: the flips bit for
bit (the JAX flip draw handed to the port), the eye-line angle and the
rotation within ``ROT_TOL`` (f32: ``cos``, ``sin`` and the sampling
position may round differently, and a pixel moves by the image's local
slope times that rounding), with integer and float landmarks whose eye
lines tilt both ways.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.ops import image as jimage
from lip2speech_torch.ops import image
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROT_TOL = 1e-4
ANGLE_TOL = 1e-6
B, H, W = 6, 24, 32  # not square: a swapped height and width shows


def _landmarks(integer: bool) -> np.ndarray:
    """(B, 68, 2) landmarks with the eyes (36-41, 42-47) around two points
    whose line tilts by about -0.4 .. 0.4 rad across the batch."""
    rng = np.random.RandomState(5)
    pts = rng.uniform(4, 20, (B, 68, 2))
    tilt = np.linspace(-0.4, 0.4, B)
    for i, a in enumerate(tilt):
        left = np.array([10.0, 12.0])
        pts[i, 36:42] = left + rng.uniform(-2, 2, (6, 2))
        pts[i, 42:48] = left + 12 * np.array([np.cos(a), np.sin(a)]) + rng.uniform(-2, 2, (6, 2))
    return np.round(pts).astype(np.int32) if integer else pts.astype(np.float32)


def test_hflip_bitwise():
    x = np.random.RandomState(0).randint(0, 256, (2, 3, H, W, 3)).astype(np.uint8)
    assert np.array_equal(image.hflip(torch.from_numpy(x)).numpy(), np.asarray(jimage.hflip(x)))


def test_batched_random_hflip_bitwise():
    """JAX's draw handed in: the same clips flipped, bit for bit; the port's
    own draw flips whole clips, those whose uniform is below p."""
    video = np.random.RandomState(1).rand(8, 2, H, W, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    flips = np.array(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < flips.sum() < 8
    want = np.asarray(jimage.batched_random_hflip(key, jnp.asarray(video)))
    got = image.batched_random_hflip(None, torch.from_numpy(video), flips=torch.from_numpy(flips))
    assert np.array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(4)
    drawn = torch.rand(8, generator=torch.Generator().manual_seed(4)) < 0.5
    own = image.batched_random_hflip(gen, torch.from_numpy(video))
    for i in range(8):
        assert torch.equal(own[i], torch.from_numpy(video[i]).flip(-2) if drawn[i]
                           else torch.from_numpy(video[i]))


@pytest.mark.parametrize("integer", [True, False])
def test_eye_alignment_angle(integer):
    lm = _landmarks(integer)
    want = np.asarray(jimage.eye_alignment_angle(jnp.asarray(lm)))
    got = image.eye_alignment_angle(torch.from_numpy(lm)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_TOL)
    assert (want < -0.1).any() and (want > 0.1).any()


def test_rotate_image_batched():
    """One batched call against JAX's ``rotate_image`` mapped over the images,
    angles of both signs."""
    imgs = np.random.RandomState(2).rand(B, H, W, 3).astype(np.float32)
    angles = np.linspace(-0.6, 0.6, B).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jimage.rotate_image))(imgs, angles))
    got = image.rotate_image(torch.from_numpy(imgs), torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL)


@pytest.mark.parametrize("integer", [True, False])
def test_align_face_batched(integer):
    crops = np.random.RandomState(6).rand(B, H, W, 3).astype(np.float32)
    lm = _landmarks(integer)
    want = np.asarray(jax.jit(jimage.align_face_batched)(crops, lm))
    got = image.align_face_batched(torch.from_numpy(crops), torch.from_numpy(lm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL)
    assert (got == 0).any() and (got != 0).mean() > 0.5  # rotated: corners fall outside
