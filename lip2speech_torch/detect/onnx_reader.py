"""Minimal ONNX protobuf reader (no onnx/onnxruntime dependency).

Counterpart of ``lip2speech_tpu/detect/onnx_reader.py`` (the port keeps
its own copy): parses just enough of the ONNX ModelProto wire format to
recover the graph (nodes with attributes) and the initializer tensors, so
the face detector's compiled graph (``version-RFB-320.onnx``) can be run
by ``onnx_torch.run_graph``. Used for the ``.onnx`` fallback path; the
repo's own weights ship as ``.npz`` (``artifacts.py``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
               7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    dims: list[int] = []
    dtype = np.float32
    name = ""
    raw = b""
    float_data: list[float] = []
    int64_data: list[int] = []
    int32_data: list[int] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == _VARINT:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif fnum == 2:
            dtype = ONNX_DTYPES.get(val, np.float32)
        elif fnum == 4:  # float_data (packed)
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 5:
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                int32_data.append(v)
        elif fnum == 7:
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                int64_data.append(v)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict = field(default_factory=dict)


def _parse_attr(buf: bytes) -> tuple[str, object]:
    name = ""
    f = i = s = t = None
    floats: list[float] = []
    ints: list[int] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i = val if isinstance(val, int) else struct.unpack("<q", val)[0]
        elif fnum == 4:
            s = val.decode(errors="replace")
        elif fnum == 5:
            t = parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == _LEN:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == _LEN:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v)
            else:
                ints.append(val)
    for v in (t, s, f):
        if v is not None:
            return name, v
    if floats:
        return name, floats
    if ints:
        return name, ints
    if i is not None:
        return name, i
    return name, None


def parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


@dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]
    outputs: list[str]


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        model = f.read()
    graph_buf = None
    for fnum, _, val in iter_fields(model):
        if fnum == 7:  # ModelProto.graph
            graph_buf = val
    if graph_buf is None:
        raise ValueError("no graph in ONNX file")

    nodes: list[OnnxNode] = []
    inits: dict[str, np.ndarray] = {}
    inputs: list[str] = []
    outputs: list[str] = []
    for fnum, _, val in iter_fields(graph_buf):
        if fnum == 1:
            nodes.append(parse_node(val))
        elif fnum == 5:
            name, arr = parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            inputs.append(_value_info_name(val))
        elif fnum == 12:
            outputs.append(_value_info_name(val))
    inputs = [i for i in inputs if i not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs)
