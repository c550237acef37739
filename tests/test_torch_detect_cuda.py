"""The face detector and ``utils.devtime`` on a card.

Marked ``cuda``: each test skips without one. This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_detect_cuda.py

The detector's two graphs on the card against the same graphs on the CPU,
on the repo's trained weights and seeded frames: RFB-320's outputs within
1e-4 (TF32 off; cuDNN's conv algorithms sum in other orders than the
CPU's), and the whole ``FaceDetector`` with the same ``None`` pattern and
boxes and landmarks within 1 px.
"""

import numpy as np
import pytest
import torch

from lip2speech_torch.detect import FaceDetector, artifacts, nms_torch, onnx_torch
from lip2speech_torch.utils.devtime import device_time

pytestmark = pytest.mark.cuda
GRAPH_ATOL = 1e-4


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_device_time_counts_per_call_seconds():
    dev = card()
    x = torch.randn(2048, 2048, device=dev)
    one = device_time(torch.matmul, x, x, n=4, repeats=3)
    four = device_time(lambda a: [a @ a for _ in range(4)], x, n=4, repeats=3)
    assert 0 < one < 1 and 2.0 < four / one < 8.0


def test_rfb320_and_detector_on_the_card_match_the_cpu():
    dev = card()
    graph = artifacts.load_onnx_npz(artifacts.RFB320_NPZ)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (8, 256, 256, 3)).astype(np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(FaceDetector.detector_input(frames)))
    want = onnx_torch.graph_runner(graph, torch.device("cpu"))(x)
    got = onnx_torch.graph_runner(graph, dev)(x)
    for k in ("scores", "boxes"):
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=GRAPH_ATOL)
    t = float(np.percentile(want["scores"][..., 1].numpy(), 99.9))
    ref = FaceDetector(threshold=t, device="cpu")(frames)
    res = FaceDetector(threshold=t)(frames)
    assert [r is None for r in res] == [r is None for r in ref]
    assert any(r is not None for r in ref)
    for g, w in zip(res, ref):
        if w is not None:
            assert np.abs(g[0] - w[0]).max() <= 1 and np.abs(g[1] - w[1]).max() <= 1
    boxes = want["boxes"][0].to(dev)
    scores = want["scores"][0, :, 1].to(dev)
    b, s, v = nms_torch(boxes, scores, 0.3, t)
    bc, sc, vc = nms_torch(boxes.cpu(), scores.cpu(), 0.3, t)
    assert torch.equal(v.cpu(), vc) and torch.equal(s.cpu(), sc)
