"""The port's face detector against the JAX package's, on the CPU, on the
repo's trained weights (``lip2speech_tpu/detect/weights/*.npz``).

Tolerances:
- RFB-320 ``scores`` and ``boxes``: 1e-5 absolute (the two executors
  differ in the conv's summation order only, a few 1e-7 measured);
- the landmark net's 136 outputs: 1e-5 absolute, per sample at batch 1;
- ``iou_matrix`` and ``hard_nms``: equal to the bit (the same numpy);
- ``nms_torch`` against ``nms_jax``: the same picks, scores within 1e-6;
- the whole ``FaceDetector``: the same ``None`` pattern, boxes and
  landmarks within 1 px (both truncate floats to integers).

Seeded frames score far below the default 0.9 threshold, so the detector
runs at the 99.9th percentile of the JAX scores on the same frames:
there are detections, and NMS, box selection and landmarks run. The
executors' other ops (MaxPool, Slice's input form, Gather on a tensor,
Squeeze) run on a small graph written by a protobuf writer here, which
both readers parse.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.detect import FaceDetector as JFaceDetector
from lip2speech_tpu.detect import artifacts as jart
from lip2speech_tpu.detect import hard_nms as j_hard_nms
from lip2speech_tpu.detect import iou_matrix as j_iou_matrix
from lip2speech_tpu.detect import nms_jax
from lip2speech_tpu.detect import onnx_jax, onnx_reader as j_reader, openvino_jax
from lip2speech_torch.detect import FaceDetector, artifacts, hard_nms, iou_matrix, nms_torch
from lip2speech_torch.detect import onnx_reader, onnx_torch, openvino_torch
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAPH_ATOL = 1e-5
LANDMARK_ATOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rfb():
    return jart.load_onnx_npz(jart.RFB320_NPZ), artifacts.load_onnx_npz(artifacts.RFB320_NPZ)


@pytest.fixture(scope="module")
def mobilefacenet():
    return jart.load_ir_npz(jart.MOBILEFACENET_NPZ), artifacts.load_ir_npz(artifacts.MOBILEFACENET_NPZ)


def seeded_frames(n: int = 8, blurred: int = 2, size: int = 256, seed: int = 0) -> np.ndarray:
    """Random RGB frames; the last ``blurred`` are smoothed, which scores
    them lower (frames without a detection)."""
    import cv2

    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    for i in range(n - blurred, n):
        frames[i] = cv2.GaussianBlur(frames[i], (0, 0), 6)
    return frames


def test_weight_paths_are_the_jax_packages_files():
    assert artifacts.RFB320_NPZ == jart.RFB320_NPZ
    assert artifacts.MOBILEFACENET_NPZ == jart.MOBILEFACENET_NPZ


def test_rfb320_matches_jax(rfb):
    jg, tg = rfb
    assert [n.op_type for n in tg.nodes] == [n.op_type for n in jg.nodes]
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 240, 320)).astype(np.float32)
    want = jax.jit(lambda v: onnx_jax.run_graph(jg, {jg.inputs[0]: v}))(x)
    run = onnx_torch.graph_runner(tg, CPU)
    got = run(torch.from_numpy(x))
    assert set(got) == {"scores", "boxes"}
    for k in ("scores", "boxes"):
        assert got[k].shape == (2, 4420, 4 if k == "boxes" else 2)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=GRAPH_ATOL)
    # without the device copies made ahead, the same numbers
    again = onnx_torch.run_graph(tg, {tg.inputs[0]: torch.from_numpy(x)})
    assert torch.equal(again["scores"], got["scores"])


def test_landmark_net_matches_jax(mobilefacenet):
    (jl, jc), (tl, tc) = mobilefacenet
    name = next(l.name for l in jl.values() if l.type == "Parameter")
    jrun = jax.jit(lambda v: openvino_jax.run_ir(jl, jc, {name: v}))
    run, tname = openvino_torch.ir_runner(tl, tc, CPU)
    assert tname == name
    faces = np.random.RandomState(2).uniform(0, 1, (3, 1, 3, 112, 112)).astype(np.float32)
    for f in faces:
        got = run(torch.from_numpy(f))
        assert got.shape == (1, 136)
        np.testing.assert_allclose(got.numpy(), np.asarray(jrun(f)), rtol=0, atol=LANDMARK_ATOL)


def test_iou_and_hard_nms_equal_to_the_bit():
    rng = np.random.RandomState(3)
    centers = rng.rand(60, 2) * 100
    sizes = 5 + rng.rand(60, 2) * 10
    boxes = np.concatenate([centers - sizes, centers + sizes], 1).astype(np.float32)
    bp = np.concatenate([boxes, rng.rand(60, 1).astype(np.float32)], 1)
    assert np.array_equal(iou_matrix(boxes, boxes), j_iou_matrix(boxes, boxes))
    for top_k, cand in ((-1, 200), (3, 200), (-1, 10)):
        got = hard_nms(bp, 0.3, top_k=top_k, candidate_size=cand)
        assert np.array_equal(got, j_hard_nms(bp, 0.3, top_k=top_k, candidate_size=cand))


@pytest.mark.parametrize("score_threshold,max_out", [(0.0, 40), (0.5, 8)])
def test_nms_torch_matches_nms_jax(score_threshold, max_out):
    # the boxes of tests/test_detect.py::test_nms_jax_matches_host
    rng = np.random.RandomState(0)
    centers = rng.rand(40, 2) * 100
    sizes = 5 + rng.rand(40, 2) * 10
    boxes = np.concatenate([centers - sizes, centers + sizes], 1).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    jb, js, jv = nms_jax(jnp.asarray(boxes), jnp.asarray(scores), 0.3, score_threshold,
                         max_out=max_out)
    tb, ts, tv = nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3,
                           score_threshold, max_out=max_out)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert np.array_equal(tb.numpy()[tv.numpy()], np.asarray(jb)[np.asarray(jv)])
    if score_threshold == 0.0:
        picked = hard_nms(np.concatenate([boxes, scores[:, None]], 1), 0.3)
        np.testing.assert_allclose(np.sort(ts.numpy()[tv.numpy()]), np.sort(picked[:, 4]),
                                   atol=1e-6)


def assert_same_detections(got, want):
    assert [r is None for r in got] == [r is None for r in want]
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g[1].shape == (68, 2) and g[0].dtype == np.int64 and g[1].dtype == np.int64
        assert np.abs(g[0] - w[0]).max() <= 1
        assert np.abs(g[1] - w[1]).max() <= 1


def detector_threshold(jdet, frames) -> float:
    """The 99.9th percentile of the JAX detector's face scores."""
    scores = np.asarray(jdet.detect_fn(jnp.asarray(FaceDetector.detector_input(frames)))["scores"])
    return float(np.percentile(scores[..., 1], 99.9))


def test_face_detector_matches_jax():
    frames = seeded_frames()
    jdet = JFaceDetector()
    t = detector_threshold(jdet, frames)
    jdet.threshold = t
    det = FaceDetector(threshold=t, device="cpu")
    want, got = jdet(frames), det(frames)
    assert any(r is None for r in want) and sum(r is not None for r in want) >= 3
    assert_same_detections(got, want)
    # the target-embedding rule, with a stand-in embedding: a crop's mean colour
    embed = lambda crop: crop.reshape(-1, 3).mean(0) / 255.0  # noqa: E731
    target = np.array([0.45, 0.5, 0.55])
    jdet = JFaceDetector(threshold=t, target_face_embedding=target, face_embed_fn=embed)
    det = FaceDetector(threshold=t, target_face_embedding=target, face_embed_fn=embed,
                       device="cpu")
    want, got = jdet(frames), det(frames)
    assert any(r is not None for r in want)
    assert_same_detections(got, want)


def test_face_detector_device_rules(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceDetector()
    monkeypatch.setenv("LIP2SPEECH_DETECTOR_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        FaceDetector(device="cpu")


# ---------------------------------------------------------------------------
# the .onnx and IR readers, on files written here
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int, payload) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + payload
    return key + _varint(len(payload)) + payload


def _tensor(name: str, arr: np.ndarray, form: str = "raw") -> bytes:
    dtype = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}[arr.dtype]
    out = b"".join(_field(1, 0, d) for d in arr.shape) + _field(2, 0, dtype)
    if form == "raw":
        out += _field(9, 2, arr.tobytes())
    elif dtype == 1:  # packed float_data
        out += _field(4, 2, struct.pack(f"<{arr.size}f", *arr.ravel()))
    else:  # packed int64_data
        out += _field(7, 2, b"".join(_varint(int(v)) for v in arr.ravel()))
    return out + _field(8, 2, name.encode())


def _attr(name: str, value) -> bytes:
    out = _field(1, 2, name.encode())
    if isinstance(value, np.ndarray):
        return out + _field(5, 2, _tensor("", value, "data"))
    if isinstance(value, float):
        return out + _field(2, 5, struct.pack("<f", value))
    if isinstance(value, int):
        return out + _field(3, 0, value)
    if isinstance(value, list):  # packed ints
        return out + _field(8, 2, b"".join(_varint(v) for v in value))
    return out + _field(4, 2, value.encode())


def _node(op: str, inputs, outputs, **attrs) -> bytes:
    out = b"".join(_field(1, 2, i.encode()) for i in inputs)
    out += b"".join(_field(2, 2, o.encode()) for o in outputs)
    out += _field(3, 2, f"{op}_{outputs[0]}".encode()) + _field(4, 2, op.encode())
    return out + b"".join(_field(5, 2, _attr(k, v)) for k, v in attrs.items())


def small_onnx(path: str):
    """x (2,3,9,9) -> Conv -> BatchNormalization -> Relu -> MaxPool ->
    Slice (input form) -> Gather on a tensor -> Squeeze -> Softmax, and the
    shape arithmetic to a Reshape."""
    rng = np.random.RandomState(4)
    inits = {
        "w": rng.randn(4, 3, 3, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32),
        "s": rng.uniform(0.5, 1.5, 4).astype(np.float32), "o": rng.randn(4).astype(np.float32),
        "m": rng.randn(4).astype(np.float32), "v": rng.uniform(0.5, 1.5, 4).astype(np.float32),
        "st": np.array([0], np.int64), "en": np.array([3], np.int64),
        "ax": np.array([1], np.int64), "ix": np.array([1], np.int64),
    }
    nodes = [
        _node("Conv", ["x", "w", "b"], ["c"], pads=[1, 1, 1, 1], strides=[1, 1]),
        _node("BatchNormalization", ["c", "s", "o", "m", "v"], ["n"], epsilon=1e-3),
        _node("Relu", ["n"], ["r"]),
        _node("MaxPool", ["r"], ["p"], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 0, 0]),
        _node("Slice", ["p", "st", "en", "ax"], ["sl"]),
        _node("Gather", ["sl", "ix"], ["g"], axis=2),
        _node("Squeeze", ["g"], ["q"], axes=[2]),
        _node("Softmax", ["q"], ["sm"], axis=1),
        _node("Shape", ["sm"], ["shp"]),
        _node("Constant", [], ["zero"], value=np.array([0], np.int64)),
        _node("Gather", ["shp", "zero"], ["n0"], axis=0),
        _node("Constant", [], ["rest"], value=np.array([12], np.int64)),
        _node("Concat", ["n0", "rest"], ["tgt"], axis=0),
        _node("Reshape", ["sm", "tgt"], ["y0"]),
        _node("Constant", [], ["k"], value=np.array([0.5], np.float32)),
        _node("Mul", ["y0", "k"], ["y1"]),
        _node("Exp", ["y1"], ["y"]),
    ]
    graph = b"".join(_field(1, 2, n) for n in nodes)
    graph += b"".join(_field(5, 2, _tensor(k, v, "raw" if i % 2 else "data"))
                      for i, (k, v) in enumerate(inits.items()))
    graph += _field(11, 2, _field(1, 2, b"x")) + _field(12, 2, _field(1, 2, b"y"))
    with open(path, "wb") as f:
        f.write(_field(1, 0, 7) + _field(7, 2, graph))


def test_onnx_reader_and_executor_on_a_written_graph(tmp_path):
    path = str(tmp_path / "small.onnx")
    small_onnx(path)
    jg, tg = j_reader.load_onnx(path), onnx_reader.load_onnx(path)
    assert tg.inputs == jg.inputs == ["x"] and tg.outputs == jg.outputs == ["y"]
    assert sorted(tg.initializers) == sorted(jg.initializers)
    for k, v in jg.initializers.items():
        assert tg.initializers[k].dtype == v.dtype and np.array_equal(tg.initializers[k], v)
    for a, b in zip(tg.nodes, jg.nodes):
        assert (a.op_type, a.inputs, a.outputs, a.name) == (b.op_type, b.inputs, b.outputs, b.name)
        assert a.attrs.keys() == b.attrs.keys()
        for k in a.attrs:
            assert np.array_equal(np.asarray(a.attrs[k]), np.asarray(b.attrs[k]))
    x = np.random.RandomState(5).randn(2, 3, 9, 9).astype(np.float32)
    want = np.asarray(onnx_jax.run_graph(jg, {"x": jnp.asarray(x)})["y"])
    run, graph = onnx_torch.make_runner(path, device="cpu")
    got = run(torch.from_numpy(x))["y"]
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAPH_ATOL)


def small_ir(tmp_path) -> tuple[str, str]:
    """Parameter -> Convolution (fp16 weights in the .bin) -> Result."""
    w = np.random.RandomState(6).randn(2, 3, 3, 3).astype(np.float16)
    bin_path, xml_path = str(tmp_path / "m.bin"), str(tmp_path / "m.xml")
    w.tofile(bin_path)
    xml = f"""<?xml version="1.0"?>
<net name="tiny" version="10">
  <layers>
    <layer id="0" name="input" type="Parameter" version="opset1">
      <data element_type="f16" shape="1,3,8,8"/>
      <output><port id="0" precision="FP16"/></output>
    </layer>
    <layer id="1" name="w" type="Const" version="opset1">
      <data element_type="f16" offset="0" shape="2,3,3,3" size="{w.nbytes}"/>
      <output><port id="1" precision="FP16"/></output>
    </layer>
    <layer id="2" name="conv" type="Convolution" version="opset1">
      <data dilations="1,1" pads_begin="1,0" pads_end="0,1" strides="2,1"/>
      <input><port id="0"/><port id="1"/></input>
      <output><port id="2" precision="FP16"/></output>
    </layer>
    <layer id="3" name="out" type="Result" version="opset1">
      <input><port id="0"/></input>
    </layer>
  </layers>
  <edges>
    <edge from-layer="0" from-port="0" to-layer="2" to-port="0"/>
    <edge from-layer="1" from-port="1" to-layer="2" to-port="1"/>
    <edge from-layer="2" from-port="2" to-layer="3" to-port="0"/>
  </edges>
</net>
"""
    with open(xml_path, "w") as f:
        f.write(xml)
    return xml_path, bin_path


def test_ir_loader_and_executor_on_a_written_ir(tmp_path):
    xml_path, bin_path = small_ir(tmp_path)
    jl, jc = openvino_jax.load_ir(xml_path, bin_path)
    tl, tc = openvino_torch.load_ir(xml_path, bin_path)
    assert [(l.id, l.name, l.type, l.data, l.inputs, l.out_ports) for l in tl.values()] == \
        [(l.id, l.name, l.type, l.data, l.inputs, l.out_ports) for l in jl.values()]
    assert tc.keys() == jc.keys() and all(
        tc[k].dtype == np.float32 and np.array_equal(tc[k], jc[k]) for k in jc)
    x = np.random.RandomState(7).rand(1, 3, 8, 8).astype(np.float32)
    want = np.asarray(openvino_jax.run_ir(jl, jc, {"input": x}))
    run, name = openvino_torch.make_ir_runner(xml_path, bin_path, device="cpu")
    got = run(torch.from_numpy(x))
    assert name == "input" and got.shape == want.shape == (1, 2, 4, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
