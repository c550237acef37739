"""The port's video and face encoders against the JAX modules.

Same seeded weights on both sides (through ``weights.from_flax``), f32,
eval-mode BatchNorm. Both outputs are L2-normalised (per frame, per face),
so the tolerances are absolute on unit vectors: a few f32 rounding steps
carried through 20-odd conv layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.models.face import FaceRecognizer as JFaceRecognizer
from lip2speech_tpu.models.shufflenet import channel_shuffle as j_channel_shuffle
from lip2speech_tpu.models.video import VideoExtractor as JVideoExtractor
from lip2speech_tpu.ops import image as jimage
from lip2speech_torch import weights
from lip2speech_torch.models.face import FaceRecognizer
from lip2speech_torch.models.shufflenet import channel_shuffle
from lip2speech_torch.models.video import VideoExtractor
from lip2speech_torch.ops import image
from torch_port_common import fill_tree, small_configs, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_state(v, module: str) -> dict:
    """A sub-module's flax variables -> the port's state dict for it."""
    _, tc = small_configs()
    tree = {"params": {module: v["params"]}, "batch_stats": {module: v["batch_stats"]}}
    sd = weights.from_flax(tree, tc)
    return {k[len(module) + 1:]: x for k, x in sd.items()}


@pytest.mark.parametrize("width", [0.5, 1.0])
def test_video_extractor_matches_jax(width):
    rng = np.random.RandomState(0)
    video = rng.randn(2, 5, 48, 48, 3).astype(np.float32)
    jm = JVideoExtractor(24, width)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), video, train=False))
    v = to_plain(fill_tree(shapes, 1))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, video))

    m = VideoExtractor(24, width).eval()
    m.load_state_dict(_port_state(v, "encoder"), strict=True)
    with torch.no_grad():
        got = m(t(video)).numpy()
    assert got.shape == want.shape == (2, 5, m.output_dim)
    # Conv3d (port) vs the time-tap fold (JAX): the same 735-term sums in
    # another order, then the trunk; unit-norm output
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_face_recognizer_matches_jax():
    rng = np.random.RandomState(2)
    # 80x80 is the smallest convenient crop that keeps every VALID stage
    # non-empty (Mixed7a ends at 1x1); the reference crop is 160x160
    faces = rng.randn(2, 80, 80, 3).astype(np.float32)
    jm = JFaceRecognizer()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), faces, train=False))
    v = to_plain(fill_tree(shapes, 3))
    want_raw, want = map(np.asarray, jax.jit(lambda v, x: (
        jm.apply(v, x, train=False), jm.apply(v, x, method=JFaceRecognizer.inference)))(v, faces))

    m = FaceRecognizer().eval()
    m.load_state_dict(_port_state(v, "vgg_face"), strict=True)
    with torch.no_grad():
        x = t(faces).permute(0, 3, 1, 2)
        got_raw, got = m(x).numpy(), m.inference(x).numpy()
    # raw projection: ~60 conv layers in f32, relative to its scale
    scale = np.abs(want_raw).max()
    np.testing.assert_allclose(got_raw, want_raw, atol=1e-4 * scale, rtol=1e-4)
    # ReLU + L2 norm: unit vectors
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_channel_shuffle_matches_jax():
    x = np.arange(2 * 8 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 8)  # NHWC
    want = np.asarray(j_channel_shuffle(jnp.asarray(x), 2))
    got = channel_shuffle(t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)  # a permutation: exact


def test_image_normalisers_match_jax():
    img = np.random.RandomState(4).randint(0, 256, (2, 6, 6, 3)).astype(np.uint8)
    np.testing.assert_allclose(image.normalize_mouth(torch.as_tensor(img)).numpy(),
                               np.asarray(jimage.normalize_mouth(jnp.asarray(img))), atol=1e-6)
    np.testing.assert_array_equal(image.normalize_face(torch.as_tensor(img)).numpy(),
                                  np.asarray(jimage.normalize_face(jnp.asarray(img))))
