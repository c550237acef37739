"""Run an OpenVINO IR (v10 xml+bin) with PyTorch ops.

Counterpart of ``lip2speech_tpu/detect/openvino_jax.py``: it runs the
68-point landmark regressor (``mobilefacenet.xml``/``.bin``, or the repo's
``.npz`` of it) directly on torch tensors in place of the OpenVINO CPU
plugin. ``load_ir`` parses the IR XML and reads the constants out of the
``.bin`` (fp16 widened to f32); ``run_ir`` executes the op set
{Convolution, GroupConvolution, Add, Multiply, PReLU, MatMul, Reshape,
Squeeze, Unsqueeze}. ``ir_weights`` moves the float constants to a device
once; integer constants stay numpy (they are shape targets).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from lip2speech_torch.models.layers import resolve_device

DTYPES = {"f16": np.float16, "f32": np.float32, "i64": np.int64, "i32": np.int32}


@dataclass
class IRLayer:
    id: str
    name: str
    type: str
    data: dict
    inputs: list  # list of (layer_id, port_id) in port order
    out_ports: list


def load_ir(xml_path: str, bin_path: str):
    tree = ET.parse(xml_path)
    root = tree.getroot()
    blob = np.fromfile(bin_path, np.uint8)

    layers: dict[str, IRLayer] = {}
    for layer in root.find("layers"):
        data = dict(layer.find("data").attrib) if layer.find("data") is not None else {}
        out_ports = []
        out = layer.find("output")
        if out is not None:
            for port in out:
                out_ports.append(port.attrib["id"])
        layers[layer.attrib["id"]] = IRLayer(
            layer.attrib["id"], layer.attrib.get("name", ""),
            layer.attrib["type"], data, [], out_ports,
        )

    # edges: from-layer/from-port -> to-layer/to-port
    edges: dict[tuple[str, str], tuple[str, str]] = {}
    for edge in root.find("edges"):
        a = edge.attrib
        edges[(a["to-layer"], a["to-port"])] = (a["from-layer"], a["from-port"])

    for layer in root.find("layers"):
        lid = layer.attrib["id"]
        inp = layer.find("input")
        if inp is None:
            continue
        for port in inp:
            layers[lid].inputs.append(edges[(lid, port.attrib["id"])])

    consts: dict[str, np.ndarray] = {}
    for l in layers.values():
        if l.type == "Const":
            off = int(l.data["offset"])
            size = int(l.data["size"])
            dt = DTYPES[l.data["element_type"]]
            shape = [int(s) for s in l.data["shape"].split(",")] if l.data["shape"] else []
            arr = blob[off : off + size].view(dt).reshape(shape)
            consts[l.id] = arr.astype(np.float32) if dt == np.float16 else arr
    return layers, consts


def _ints(s: str) -> list[int]:
    return [int(v) for v in s.split(",")]


def _conv(data: dict, x: torch.Tensor, w: torch.Tensor, grouped: bool) -> torch.Tensor:
    pb, pe = _ints(data["pads_begin"]), _ints(data["pads_end"])
    groups = 1
    if grouped:  # GroupConvolution: weights (G, O/G, I/G, kh, kw)
        g, o, i, kh, kw = w.shape
        w = w.reshape(g * o, i, kh, kw)
        groups = g
    if any(pb) or any(pe):
        x = F.pad(x, (pb[1], pe[1], pb[0], pe[0]))
    return F.conv2d(x, w, stride=tuple(_ints(data["strides"])),
                    dilation=tuple(_ints(data.get("dilations", "1,1"))), groups=groups)


def ir_weights(consts: dict, device: torch.device) -> dict:
    """The float constants as tensors on ``device``; integer ones as they are."""
    return {k: torch.tensor(v, device=device) if np.asarray(v).dtype.kind == "f" else v
            for k, v in consts.items()}


def run_ir(layers: dict, consts: dict, feeds: dict) -> torch.Tensor:
    """Execute; ``feeds`` maps Parameter layer names to arrays or tensors
    (read as f32, on the device of ``consts``' tensors, see ``ir_weights``;
    numpy ``consts`` run on the CPU). Returns the Result input tensor."""
    device = next((v.device for v in consts.values() if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    env: dict[str, object] = {}

    def get(src):
        lid, _ = src
        return env[lid]

    def tensor(src) -> torch.Tensor:
        return torch.as_tensor(get(src), device=device)

    result = None
    for l in layers.values():
        t = l.type
        if t == "Const":
            env[l.id] = consts[l.id]
        elif t == "Parameter":
            env[l.id] = torch.as_tensor(feeds[l.name], dtype=torch.float32, device=device)
        elif t in ("Convolution", "GroupConvolution"):
            env[l.id] = _conv(l.data, tensor(l.inputs[0]), tensor(l.inputs[1]),
                              t == "GroupConvolution")
        elif t == "Add":
            env[l.id] = tensor(l.inputs[0]) + tensor(l.inputs[1])
        elif t == "Multiply":
            env[l.id] = tensor(l.inputs[0]) * tensor(l.inputs[1])
        elif t == "PReLU":
            x = tensor(l.inputs[0])
            a = tensor(l.inputs[1])
            a = a.reshape(1, -1, 1, 1) if x.ndim == 4 else a
            env[l.id] = torch.clamp(x, min=0) + a * torch.clamp(x, max=0)
        elif t == "MatMul":
            a = tensor(l.inputs[0])
            b = tensor(l.inputs[1])
            if l.data.get("transpose_b") in ("true", "True", "1"):
                b = b.permute(*reversed(range(b.ndim)))
            env[l.id] = a @ b
        elif t in ("Reshape", "Squeeze", "Unsqueeze"):
            x = get(l.inputs[0])
            tgt = [int(v) for v in np.asarray(get(l.inputs[1]), np.int64).reshape(-1)]
            if t == "Reshape":
                env[l.id] = x.reshape(tgt)
            elif t == "Squeeze":
                env[l.id] = x.squeeze(tuple(tgt))
            else:
                out = x
                for ax in sorted(tgt):
                    out = out.unsqueeze(ax)
                env[l.id] = out
        elif t == "Result":
            result = get(l.inputs[0])
        else:  # pragma: no cover
            raise NotImplementedError(f"IR op {t}")
    return result


def ir_runner(layers: dict, consts: dict, device: torch.device) -> tuple[Callable, str]:
    """(``x -> output`` on ``device`` without autograd, the input's name);
    the constants are moved there once."""
    weights = ir_weights(consts, device)
    input_name = next(l.name for l in layers.values() if l.type == "Parameter")

    def run(x):
        with torch.no_grad():
            return run_ir(layers, weights, {input_name: x})

    return run, input_name


def make_ir_runner(xml_path: str, bin_path: str, device=None) -> tuple[Callable, str]:
    """Load an IR and return (runner on ``device``, input name); the device
    is CUDA unless the caller names another."""
    layers, consts = load_ir(xml_path, bin_path)
    return ir_runner(layers, consts, resolve_device(device))
