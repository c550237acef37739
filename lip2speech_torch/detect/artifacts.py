"""The face detector's weight artifacts (.npz).

Counterpart of ``lip2speech_tpu/detect/artifacts.py``. The RFB-320 ONNX
graph and the mobilefacenet OpenVINO IR ship in the repo as ``.npz`` files
(graph structure as an embedded JSON document, weights as plain arrays)
under ``lip2speech_tpu/detect/weights/``. They are data, not modules: the
port reads them by path, resolved from the repo root, and imports nothing
of the JAX package. ``load_onnx_npz`` and ``load_ir_npz`` give the same
``OnnxGraph`` and ``IRLayer`` objects as the JAX package's loaders.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(REPO_ROOT, "lip2speech_tpu", "detect", "weights")
RFB320_NPZ = os.path.join(WEIGHTS_DIR, "rfb320.npz")
MOBILEFACENET_NPZ = os.path.join(WEIGHTS_DIR, "mobilefacenet.npz")


def _save_npz(path: str, meta: dict, arrays: dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"__meta__": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    payload.update(arrays)
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _load_npz(path: str):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode())
    return meta, data


# ---------------------------------------------------------------------------
# ONNX graph (RFB-320 detector)
# ---------------------------------------------------------------------------


def save_onnx_npz(graph, path: str) -> None:
    arrays = {f"init/{k}": v for k, v in graph.initializers.items()}
    nodes = []
    for i, n in enumerate(graph.nodes):
        attrs = {}
        for k, v in n.attrs.items():
            if isinstance(v, np.ndarray):
                key = f"attr/{i}/{k}"
                arrays[key] = v
                attrs[k] = {"__array__": key}
            else:
                attrs[k] = v
        nodes.append({"op_type": n.op_type, "inputs": n.inputs, "outputs": n.outputs,
                      "name": n.name, "attrs": attrs})
    meta = {"kind": "onnx", "nodes": nodes, "inputs": graph.inputs, "outputs": graph.outputs}
    _save_npz(path, meta, arrays)


def load_onnx_npz(path: str):
    from lip2speech_torch.detect.onnx_reader import OnnxGraph, OnnxNode

    meta, data = _load_npz(path)
    if meta["kind"] != "onnx":
        raise ValueError(f"{path} holds no ONNX graph")
    nodes = []
    for nd in meta["nodes"]:
        attrs = {
            k: (data[v["__array__"]] if isinstance(v, dict) and "__array__" in v else v)
            for k, v in nd["attrs"].items()
        }
        nodes.append(OnnxNode(nd["op_type"], nd["inputs"], nd["outputs"], nd["name"], attrs))
    inits = {k[len("init/"):]: data[k] for k in data.files if k.startswith("init/")}
    return OnnxGraph(nodes, inits, meta["inputs"], meta["outputs"])


# ---------------------------------------------------------------------------
# OpenVINO IR (mobilefacenet landmarks)
# ---------------------------------------------------------------------------


def save_ir_npz(layers: dict, consts: dict, path: str) -> None:
    meta_layers = [
        {"id": l.id, "name": l.name, "type": l.type, "data": l.data,
         "inputs": [list(t) for t in l.inputs], "out_ports": l.out_ports}
        for l in layers.values()  # insertion order == topological order
    ]
    arrays = {f"const/{k}": np.asarray(v) for k, v in consts.items()}
    _save_npz(path, {"kind": "ir", "layers": meta_layers}, arrays)


def load_ir_npz(path: str):
    from lip2speech_torch.detect.openvino_torch import IRLayer

    meta, data = _load_npz(path)
    if meta["kind"] != "ir":
        raise ValueError(f"{path} holds no OpenVINO IR")
    layers = {
        ld["id"]: IRLayer(ld["id"], ld["name"], ld["type"], ld["data"],
                          [tuple(t) for t in ld["inputs"]], ld["out_ports"])
        for ld in meta["layers"]
    }
    consts = {k[len("const/"):]: data[k] for k in data.files if k.startswith("const/")}
    return layers, consts
