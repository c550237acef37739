"""The free-running AR mel decode: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``lip2speech_tpu/ops/pallas_decoder.py``
(``_make_kernel``, the body at :47-138, and ``pallas_ar_decode``, the wrapper
at :154-247) with ``lip2speech_torch/csrc/ar_decode.cu``, and computes the
same function in the same layout: given the decoder's AR parameters ``p``
(JAX layout: dense kernels are (in, out)), the encoder outputs ``enc`` and
the BOS frame, it returns mels ``(M, B, n_mels)``, stop logits ``(M, B, 1)``
and attention weights ``(M, B, T)``, all f32. State (h, c, ys) is f32 as in
the Pallas kernel; the flax scan instead carries its compute dtype. Every
product's input is rounded to the weight type (bf16 by default, f32 for
tight comparisons) and accumulates in f32.

What bounds the kernel on an H100: 300 dependent steps of six dependent
stages each. At small batch the step time is latency (grid barriers and L2
round trips for ~10.5 MB of bf16 weights); at B=256 it is ~2.7 GFLOP of f32
FMA per step on the CUDA cores. The design runs every step in one
cooperative launch with a grid-wide barrier between stages, so the weights
stay in device memory (the 50 MB L2 holds them across steps) and nothing
returns to the host; each stage is split into (batch rows x 32 columns)
tiles that the resident blocks take in turn. See the source for the rest.

``ar_decode`` takes the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises; ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.kernels import build
from lip2speech_torch.models.layers import lstm_cell_step, sinusoid_table

SOURCE = "ar_decode.cu"

# kernel launches since the count was last set to 0
launches = 0

WEIGHT_ORDER = [
    ("prenet0", "kernel"), ("prenet0", "bias"), ("prenet0_w", None),
    ("prenet1", "kernel"), ("prenet1", "bias"), ("prenet1_w", None),
    ("Q", "kernel"), ("Q", "bias"), ("Q_w", None),
    ("attention_proj", "kernel"), ("attention_proj", "bias"),
    ("content_Q", "kernel"), ("content_Q", "bias"),
    ("lstm0", "wx"), ("lstm0", "wh"), ("lstm0", "b"),
    ("lstm1", "wx"), ("lstm1", "wh"), ("lstm1", "b"),
    ("fc_out", "kernel"), ("fc_out", "bias"),
    ("stop", "kernel"), ("stop", "bias"),
]


def _weights(p: dict) -> dict[str, torch.Tensor]:
    """The 23 AR weights by 'name.leaf' (JAX layout)."""
    return {
        f"{name}.{leaf}" if leaf else name: (p[name] if leaf is None else p[name][leaf]).detach()
        for name, leaf in WEIGHT_ORDER
    }


@functools.lru_cache(maxsize=16)
def decode_positions(cfg: ModelConfig, n_steps: int, device: torch.device) -> torch.Tensor:
    """``sinusoid_table(max(max_decoder_steps, M), F)[:M]``, (M, F) f32 on
    ``device``, made once per shape."""
    table = sinusoid_table(max(cfg.max_decoder_steps, n_steps), cfg.ffn_hidden_dim)
    return torch.tensor(table[:n_steps], device=device)


def ar_decode_reference(cfg: ModelConfig, p: dict, enc: dict, bos: torch.Tensor,
                        n_steps: int | None = None, weight_dtype=torch.bfloat16):
    """Plain PyTorch step loop computing what the kernel computes."""
    M = n_steps or cfg.max_decoder_steps
    dev = enc["k"].device

    def rnd(x):  # round to the weight type, compute in f32
        return x.detach().to(weight_dtype).float()

    w = {k: rnd(v) for k, v in _weights(p).items()}
    t_attn = p["temperature"].detach().float().reshape(())
    t_content = p["content_temp"].detach().float().reshape(())
    pos = rnd(decode_positions(cfg, M, dev))
    k_bank, v_bank = rnd(enc["k"]), rnd(enc["v"])
    c_key, c_val = rnd(enc["content_key"]), rnd(enc["content_value"])
    ec = rnd(enc["encoder_cell"])

    def dot(x, name):
        return rnd(x) @ w[name]

    def lstm(x, h, c, name):
        return lstm_cell_step(w[f"{name}.wx"], w[f"{name}.wh"], w[f"{name}.b"], rnd(x), rnd(h), c)

    h0, h1 = rnd(enc["hidden"][0]), rnd(enc["hidden"][1])
    c0 = torch.zeros_like(h0)
    c1 = torch.zeros_like(h1)
    ys = rnd(bos)
    mels, stops, attns = [], [], []
    for i in range(M):
        pre = torch.sin(dot(ys, "prenet0.kernel") + w["prenet0.bias"]) * w["prenet0_w"]
        pre = torch.sin(dot(pre, "prenet1.kernel") + w["prenet1.bias"]) * w["prenet1_w"]
        h_cat = torch.cat([h0, h1], dim=-1)
        q = torch.sin(dot(h_cat, "Q.kernel") + w["Q.bias"]) * w["Q_w"] + pos[i]
        a = torch.softmax(((q * t_attn)[:, None, :] * k_bank).sum(-1), dim=-1)
        o = (a[:, :, None] * v_bank).sum(1)
        ys_mid = pre + (dot(o, "attention_proj.kernel") + w["attention_proj.bias"])
        # content attention is queried by the cell states, not h
        cq = dot(torch.cat([c0, c1], dim=-1), "content_Q.kernel") + w["content_Q.bias"]
        cq = cq * torch.sigmoid(cq)
        ca = torch.softmax(((cq * t_content)[:, None, :] * c_key).sum(-1), dim=-1)
        content_o = (ca[:, :, None] * c_val).sum(1)
        h0, c0 = lstm(torch.cat([content_o, ys_mid], dim=-1), h0, c0, "lstm0")
        h1, c1 = lstm(h0, h1, c1, "lstm1")
        ys = dot(h1, "fc_out.kernel") + w["fc_out.bias"]
        stop = dot(torch.cat([h1, ec], dim=-1), "stop.kernel") + w["stop.bias"]
        mels.append(ys)
        stops.append(stop)
        attns.append(a)
    return torch.stack(mels), torch.stack(stops), torch.stack(attns)


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.ar_decode_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.ar_decode_launch.restype = ctypes.c_int
        lib.ar_decode_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.ar_decode_scratch_floats.restype = ctypes.c_longlong
        lib.ar_decode_error_string.argtypes = [ctypes.c_int]
        lib.ar_decode_error_string.restype = ctypes.c_char_p
        lib.ar_decode_num_ptrs.restype = ctypes.c_int
        lib.ar_decode_num_dims.restype = ctypes.c_int
        _lib = lib
    return _lib


def lstm_column_order(F: int) -> torch.Tensor:
    """Column permutation of a (.., 4F) gate matrix that puts gates i, f, g,
    o of 8 consecutive hidden units into each run of 32 columns (one kernel
    tile)."""
    tile = torch.arange(F // 8)[:, None, None]
    gate = torch.arange(4)[None, :, None]
    unit = torch.arange(8)[None, None, :]
    return (gate * F + tile * 8 + unit).reshape(-1)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ar_decode: {msg}")


def ar_decode_cuda(cfg: ModelConfig, p: dict, enc: dict, bos: torch.Tensor,
                   n_steps: int | None = None, weight_dtype=torch.bfloat16):
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launches
    M = n_steps or cfg.max_decoder_steps
    F, NM, L = cfg.ffn_hidden_dim, cfg.n_mels, cfg.content_latent_dim
    dev = enc["k"].device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}")
    _check(weight_dtype in (torch.float32, torch.bfloat16), f"weight dtype {weight_dtype}")
    B, T, _ = enc["k"].shape
    S = enc["content_key"].shape[1]
    shapes = {
        "hidden": (2, B, F), "k": (B, T, F), "v": (B, T, F), "content_key": (B, S, L),
        "content_value": (B, S, L), "encoder_cell": (B, F),
    }
    for name, shape in shapes.items():
        _check(tuple(enc[name].shape) == shape, f"enc[{name!r}] has shape {tuple(enc[name].shape)}, want {shape}")
        _check(enc[name].device == dev, f"enc[{name!r}] is on {enc[name].device}, want {dev}")
    _check(tuple(bos.shape) == (B, NM) and bos.device == dev, f"bos must be ({B}, {NM}) on {dev}")
    _check(F % 8 == 0 and L + F // 2 == F, "need ffn_hidden_dim % 8 == 0 and content_latent_dim == ffn_hidden_dim / 2")

    def vec(x):  # f32 values rounded to the weight type
        return x.detach().to(dev).to(weight_dtype).float().contiguous()

    def mat(x):
        return x.detach().to(dev).to(weight_dtype).contiguous()

    w = _weights(p)
    order = lstm_column_order(F).to(dev)
    lstm = {}
    for name in ("lstm0", "lstm1"):
        lstm[name] = (mat(torch.cat([w[f"{name}.wx"], w[f"{name}.wh"]], 0)[:, order]),
                      vec(w[f"{name}.b"][order]))
    temps = torch.stack([p["temperature"].detach().reshape(()),
                         p["content_temp"].detach().reshape(())]).float().to(dev).contiguous()
    with torch.cuda.device(dev):
        lib = _library()
        mel = torch.empty((M, B, NM), device=dev)
        stop = torch.empty((M, B, 1), device=dev)
        attn = torch.empty((M, B, T), device=dev)
        scratch = torch.empty(lib.ar_decode_scratch_floats(B, F, L, NM), device=dev)
        barrier = torch.zeros(3, dtype=torch.int32, device=dev)
        tensors = [
            vec(enc["hidden"]), mat(enc["k"]), mat(enc["v"]), mat(enc["content_key"]),
            mat(enc["content_value"]), vec(enc["encoder_cell"]), vec(bos),
            vec(decode_positions(cfg, M, dev)),
            mat(w["prenet0.kernel"]), vec(w["prenet0.bias"]), vec(w["prenet0_w"]),
            mat(w["prenet1.kernel"]), vec(w["prenet1.bias"]), vec(w["prenet1_w"]),
            mat(w["Q.kernel"]), vec(w["Q.bias"]), vec(w["Q_w"]),
            mat(w["attention_proj.kernel"]), vec(w["attention_proj.bias"]),
            mat(w["content_Q.kernel"]), vec(w["content_Q.bias"]),
            *lstm["lstm0"], *lstm["lstm1"],
            mat(w["fc_out.kernel"]), vec(w["fc_out.bias"]),
            mat(w["stop.kernel"]), vec(w["stop.bias"]),
            temps, mel, stop, attn, scratch, barrier,
        ]
        _check(len(tensors) == lib.ar_decode_num_ptrs(), "pointer list out of step with the kernel")
        dims = [B, T, S, F, L, NM, M, int(weight_dtype == torch.bfloat16)]
        _check(len(dims) == lib.ar_decode_num_dims(), "dims out of step with the kernel")
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        c_dims = (ctypes.c_int * len(dims))(*dims)
        err = lib.ar_decode_launch(ptrs, c_dims, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ar_decode kernel launch failed: {lib.ar_decode_error_string(err).decode()}")
        launches += 1
    return mel, stop, attn


def ar_decode(cfg: ModelConfig, p: dict, enc: dict, bos: torch.Tensor,
              n_steps: int | None = None, weight_dtype=torch.bfloat16):
    """The AR decode: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error), never a fallback from one to the other."""
    if enc["k"].device.type == "cpu":
        return ar_decode_reference(cfg, p, enc, bos, n_steps, weight_dtype)
    return ar_decode_cuda(cfg, p, enc, bos, n_steps, weight_dtype)
