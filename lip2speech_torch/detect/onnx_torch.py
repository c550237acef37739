"""Run a (small) ONNX graph with PyTorch ops.

Counterpart of ``lip2speech_tpu/detect/onnx_jax.py``: it runs the RFB-320
face detector's graph (``version-RFB-320.onnx``, or the repo's ``.npz``
of it) directly on torch tensors in place of the ONNX Runtime engine.
Supports the op set of that graph (Conv, BatchNormalization, Relu,
element-wise ops, Exp, Softmax, Reshape/Transpose/Slice/Concat and the
shape-arithmetic ops) and MaxPool.

Shape arithmetic (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) is
evaluated concretely with numpy, as the JAX executor does while it traces:
the reshape targets are host integers and never reach the device.
BatchNormalization is folded in numpy exactly as the JAX executor folds it
(``x * (scale * inv) + (bias - mean * scale * inv)``); ``F.batch_norm``
would round differently. ``graph_weights`` moves the graph's float
constants and folds to a device once; ``graph_runner`` keeps them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from lip2speech_torch.detect.onnx_reader import OnnxGraph, OnnxNode
from lip2speech_torch.models.layers import resolve_device


def _is_concrete(*xs) -> bool:
    return all(isinstance(x, (np.ndarray, np.generic, int, float, list)) for x in xs)


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``: tensors are moved, numpy values copied there."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _pad2d(x: torch.Tensor, top: int, left: int, bottom: int, right: int,
           value: float = 0.0) -> torch.Tensor:
    if top or left or bottom or right:
        return F.pad(x, (left, right, top, bottom), value=value)
    return x


def _bn_fold(node: OnnxNode, scale, bias, mean, var) -> tuple[np.ndarray, np.ndarray]:
    """(multiplier, addend), each (1, C, 1, 1), in the JAX executor's order."""
    eps = node.attrs.get("epsilon", 1e-5)
    inv = 1.0 / np.sqrt(np.asarray(var) + eps)
    mul = np.asarray(scale) * inv
    add = np.asarray(bias) - np.asarray(mean) * np.asarray(scale) * inv
    return mul[None, :, None, None], add[None, :, None, None]


def _conv(node: OnnxNode, x, w, b=None):
    groups = node.attrs.get("group", 1)
    strides = node.attrs.get("strides", [1, 1])
    pads = node.attrs.get("pads", [0, 0, 0, 0])  # top, left, bottom, right
    dil = node.attrs.get("dilations", [1, 1])
    x = _pad2d(x, pads[0], pads[1], pads[2], pads[3])
    return F.conv2d(x, _on(w, x.device), None if b is None else _on(b, x.device),
                    stride=tuple(strides), dilation=tuple(dil), groups=groups)


def _slice(node: OnnxNode, data, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset<10 attribute form
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes")
    starts = np.asarray(starts).tolist()
    ends = np.asarray(ends).tolist()
    axes = list(range(len(starts))) if axes is None else np.asarray(axes).tolist()
    steps = [1] * len(starts) if steps is None else np.asarray(steps).tolist()
    idx = [slice(None)] * data.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if sp < 1 and not _is_concrete(data):
            raise NotImplementedError("ONNX Slice with a negative step on a tensor")
        idx[ax] = slice(st, None if en > 2**31 else en, sp)
    return data[tuple(idx)]


def _gather(x: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """``np.take(x, idx, axis)`` on a tensor."""
    idx = torch.tensor(np.asarray(idx), device=x.device)
    axis = axis % x.ndim
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + tuple(idx.shape) + x.shape[axis + 1:])


_BINARY = {
    "Mul": (np.multiply, torch.mul), "Add": (np.add, torch.add),
    "Sub": (np.subtract, torch.sub), "Div": (np.divide, torch.div),
}


def graph_weights(graph: OnnxGraph, device: torch.device) -> dict:
    """The graph's float initializers and float Constant values as tensors
    on ``device``, and each BatchNormalization's fold of its initializers
    under ``bn:<output>``. Integer constants stay numpy: they feed the shape
    arithmetic."""
    out: dict = {}
    for name, v in graph.initializers.items():
        if np.asarray(v).dtype.kind == "f":
            out[name] = torch.tensor(np.asarray(v), device=device)
    for node in graph.nodes:
        if node.op_type == "Constant":
            v = node.attrs["value"]
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                out[node.outputs[0]] = torch.tensor(v, device=device)
        elif node.op_type == "BatchNormalization":
            mul, add = _bn_fold(node, *(graph.initializers[n] for n in node.inputs[1:5]))
            out["bn:" + node.outputs[0]] = (torch.as_tensor(mul, device=device),
                                            torch.as_tensor(add, device=device))
    return out


def run_graph(graph: OnnxGraph, feeds: dict, weights: dict | None = None) -> dict:
    """Evaluate the graph on the feeds' device; returns {output_name: tensor}.

    ``weights`` is ``graph_weights(graph, device)``; without it the
    constants are moved to the first feed's device for this call."""
    feeds = {k: torch.as_tensor(v) for k, v in feeds.items()}
    device = next(iter(feeds.values())).device
    if weights is None:
        weights = graph_weights(graph, device)
    env: dict[str, object] = dict(graph.initializers)
    env.update({k: v for k, v in weights.items() if not k.startswith("bn:")})
    env.update(feeds)

    for node in graph.nodes:
        i = [env[n] if n else None for n in node.inputs]
        op = node.op_type
        if op == "Conv":
            out = _conv(node, *i)
        elif op == "BatchNormalization":
            mul, add = weights["bn:" + node.outputs[0]]
            out = i[0] * mul + add
        elif op == "Relu":
            out = np.maximum(i[0], 0) if _is_concrete(i[0]) else torch.relu(i[0])
        elif op == "Constant":
            out = env.get(node.outputs[0], node.attrs["value"])
        elif op == "Shape":
            out = np.asarray(tuple(i[0].shape), np.int64)
        elif op == "Gather":
            axis = node.attrs.get("axis", 0)
            if _is_concrete(*i):
                out = np.take(i[0], np.asarray(i[1]), axis=axis)
            else:
                out = _gather(_on(i[0], device), i[1], axis)
        elif op == "Unsqueeze":
            axes = node.attrs.get("axes") or np.asarray(i[1]).tolist()
            out = i[0]
            for ax in sorted(np.atleast_1d(axes).tolist()):
                out = np.expand_dims(out, ax) if _is_concrete(out) else out.unsqueeze(ax)
        elif op == "Squeeze":
            axes = tuple(node.attrs.get("axes"))
            out = np.squeeze(i[0], axes) if _is_concrete(i[0]) else i[0].squeeze(axes)
        elif op == "Concat":
            axis = node.attrs.get("axis", 0)
            if _is_concrete(*i):
                out = np.concatenate([np.atleast_1d(x) for x in i], axis)
            else:
                out = torch.cat([torch.atleast_1d(_on(x, device)) for x in i], axis)
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(i[1], dtype=np.int64).reshape(-1)]
            out = np.reshape(i[0], shape) if _is_concrete(i[0]) else i[0].reshape(shape)
        elif op == "Transpose":
            perm = node.attrs["perm"]
            out = np.transpose(i[0], perm) if _is_concrete(i[0]) else i[0].permute(*perm)
        elif op == "Slice":
            out = _slice(node, *i)
        elif op in _BINARY:
            fn_np, fn_t = _BINARY[op]
            if _is_concrete(*i):
                out = fn_np(i[0], i[1])
            else:
                out = fn_t(_on(i[0], device), _on(i[1], device))
        elif op == "Exp":
            out = torch.exp(_on(i[0], device))
        elif op == "Softmax":
            out = torch.softmax(_on(i[0], device), dim=node.attrs.get("axis", -1))
        elif op == "MaxPool":
            k = node.attrs["kernel_shape"]
            s = node.attrs.get("strides", k)
            p = node.attrs.get("pads", [0, 0, 0, 0])
            x = _pad2d(_on(i[0], device), p[0], p[1], p[2], p[3], value=float("-inf"))
            out = F.max_pool2d(x, tuple(k), tuple(s))
        else:  # pragma: no cover
            raise NotImplementedError(f"ONNX op {op}")
        for name in node.outputs:
            env[name] = out

    return {o: env[o] for o in graph.outputs}


def graph_runner(graph: OnnxGraph, device: torch.device) -> Callable:
    """``x -> {output: tensor}`` on ``device``, without autograd; the
    graph's constants are moved there once."""
    weights = graph_weights(graph, device)
    name = graph.inputs[0]

    def run(x):
        with torch.no_grad():
            return run_graph(graph, {name: _on(x, device)}, weights)

    return run


def make_runner(path: str, device=None) -> tuple[Callable, OnnxGraph]:
    """Load an .onnx file and return (runner on ``device``, graph); the
    device is CUDA unless the caller names another."""
    from lip2speech_torch.detect.onnx_reader import load_onnx

    graph = load_onnx(path)
    return graph_runner(graph, resolve_device(device)), graph
