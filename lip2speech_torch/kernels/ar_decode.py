"""The free-running AR mel decode: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``lip2speech_tpu/ops/pallas_decoder.py``
(``_make_kernel``, the body at :47-138, and ``pallas_ar_decode``, the wrapper
at :154-247) with ``lip2speech_torch/csrc/ar_decode.cu``, and computes the
same function in the same layout: given the decoder's AR parameters ``p``
(JAX layout: dense kernels are (in, out)), the encoder outputs ``enc`` and
the BOS frame, it returns mels ``(M, B, n_mels)``, stop logits ``(M, B, 1)``
and attention weights ``(M, B, T)``, all f32. The cell state is f32 as in
the Pallas kernel (the flax scan instead carries its compute dtype). Every
product's input is rounded to the weight type (bf16 by default, f32 for
tight comparisons) and accumulates in f32, so the kernel may keep h and the
frame fed back (ys) in the weight type.

What bounds the kernel on an H100: 300 dependent steps, each a chain of
small products over ~5.24 M weights (10.5 MB in bf16). At small batch the
step time is latency (grid barriers, and the round trips that feed each
stage); at B=256 it is ~2.7 GFLOP a step. The design: one cooperative
launch of one block per SM runs every step; each block owns contiguous
column runs of every matrix (whole hidden units for the LSTM) and, in
bf16, keeps its ~80 KB of weight slices in shared memory for the whole
launch; five grid barriers a step close five stages. ``pack_ar_weights``
cuts the weights into those slices and writes the ownership table the
kernel reads; ``packed_weights`` caches the pack, so a batch whose weights
did not change does not repack them (``packs`` counts packs). See the
source for the rest.

``ar_decode`` takes the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises; ``launches`` counts launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.kernels import build

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
    # imported here: the models package imports this module
    from lip2speech_torch.models.layers import sinusoid_table

    table = sinusoid_table(max(cfg.max_decoder_steps, n_steps), cfg.ffn_hidden_dim)
    return torch.tensor(table[:n_steps], device=device)


def ar_decode_reference(cfg: ModelConfig, p: dict, enc: dict, bos: torch.Tensor,
                        n_steps: int | None = None, weight_dtype=torch.bfloat16):
    """Plain PyTorch step loop computing what the kernel computes."""
    from lip2speech_torch.models.layers import lstm_cell_step  # as in decode_positions

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
        lib.ar_decode_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.ar_decode_scratch_bytes.restype = ctypes.c_longlong
        lib.ar_decode_error_string.argtypes = [ctypes.c_int]
        lib.ar_decode_error_string.restype = ctypes.c_char_p
        lib.ar_decode_num_ptrs.restype = ctypes.c_int
        lib.ar_decode_num_dims.restype = ctypes.c_int
        lib.ar_decode_stage_names.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def lstm_column_order(F: int, units: int) -> torch.Tensor:
    """Column permutation of a (.., 4F) gate matrix that puts gates i, f, g,
    o of ``units`` consecutive hidden units into each run of 4 * units
    columns."""
    tile = torch.arange(F // units)[:, None, None]
    gate = torch.arange(4)[None, :, None]
    unit = torch.arange(units)[None, None, :]
    return (gate * F + tile * units + unit).reshape(-1)


# The packed matrices, in the kernel's order. Each has K input rows and
# units of `width` output columns; a block owns a run of whole units.
#   query_out      [h0 | h1] -> Q (F units), fc_out (n_mels), stop's h1 part (1)
#   content_query  [c0 | c1] -> content_Q (L units)
#   prenet0        ys (zero-padded to a multiple of 16) -> prenet0 (F/2 units)
#   proj_prenet1   [o | pre0] -> unit j: attention_proj j, prenet1 j
#   lstm0, lstm1   [x | h] -> unit u: gates i, f, g, o of hidden unit u
MATRICES = ("query_out", "content_query", "prenet0", "proj_prenet1", "lstm0", "lstm1")
TABLE_COLS = 2 + 3 * len(MATRICES)  # region offset, length; (unit0, units, offset) per matrix
VEC_HEAD = 4  # vec: t_attn, t_content, b_stop, 0, then w_stop[F:]

# weight packs made since the count was last set to 0
packs = 0


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _packed_matrices(cfg: ModelConfig, w: dict[str, torch.Tensor]):
    """(W (K, columns) in packed column order, unit width, bias, scale) of
    each of MATRICES, f32. Rows a column does not read are zero."""
    F, L, NM = cfg.ffn_hidden_dim, cfg.content_latent_dim, cfg.n_mels
    H, NMp = F // 2, _round_up(NM, 16)
    dev = w["Q.kernel"].device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    qo = zeros(2 * F, F + NM + 1)
    qo[:, :F] = w["Q.kernel"]
    qo[F:, F:F + NM] = w["fc_out.kernel"]
    qo[F:, F + NM] = w["stop.kernel"][:F, 0]
    pre0 = zeros(NMp, H)
    pre0[:NM] = w["prenet0.kernel"]
    pp = zeros(F + H, 2 * H)
    pp[:F, 0::2] = w["attention_proj.kernel"]
    pp[F:, 1::2] = w["prenet1.kernel"]
    pp_bias, pp_scale = zeros(2 * H), zeros(2 * H)
    pp_bias[0::2], pp_bias[1::2] = w["attention_proj.bias"], w["prenet1.bias"]
    pp_scale[1::2] = w["prenet1_w"]
    order = lstm_column_order(F, 1).to(dev)
    mats = [
        (qo, 1, torch.cat([w["Q.bias"], w["fc_out.bias"], zeros(1)]),
         torch.cat([w["Q_w"].reshape(-1), zeros(NM + 1)])),
        (w["content_Q.kernel"], 1, w["content_Q.bias"], zeros(L)),
        (pre0, 1, w["prenet0.bias"], w["prenet0_w"].reshape(-1)),
        (pp, 2, pp_bias, pp_scale),
    ]
    for name in ("lstm0", "lstm1"):
        wl = torch.cat([w[f"{name}.wx"], w[f"{name}.wh"]], 0)[:, order]
        mats.append((wl, 4, w[f"{name}.b"][order], zeros(4 * F)))
    return mats


def _even(n: int, blocks: range, n_blocks: int) -> tuple[list[int], list[int]]:
    """(first unit, units) of every block: n units in contiguous runs over
    ``blocks``, none for the others."""
    u0, nu = [0] * n_blocks, [0] * n_blocks
    for k, b in enumerate(blocks):
        u0[b] = n * k // len(blocks)
        nu[b] = n * (k + 1) // len(blocks) - u0[b]
    return u0, nu


def partition(cfg: ModelConfig, n_blocks: int) -> list[tuple[list[int], list[int]]]:
    """Which units of each matrix every block owns. Stage A's two matrices
    have inputs of their own, so they go to disjoint sets of blocks in
    proportion to their columns (each block stages one input). prenet0 goes
    to the first half of the blocks: the kernel hands stage B's attention
    rows out from the last block down, so at small batch the two overlap.
    The other matrices are spread over all blocks."""
    F, L, NM = cfg.ffn_hidden_dim, cfg.content_latent_dim, cfg.n_mels
    n_qo, n_cq = F + NM + 1, L
    every = range(n_blocks)
    if n_blocks == 1:
        stage_a = [_even(n_qo, every, 1), _even(n_cq, every, 1)]
    else:
        g_cq = min(n_blocks - 1, max(1, round(n_blocks * n_cq / (n_qo + n_cq))))
        stage_a = [_even(n_qo, range(n_blocks - g_cq), n_blocks),
                   _even(n_cq, range(n_blocks - g_cq, n_blocks), n_blocks)]
    H = F // 2
    return stage_a + [_even(H, range(max(1, n_blocks // 2)), n_blocks), _even(H, every, n_blocks),
                      _even(F, every, n_blocks), _even(F, every, n_blocks)]


def pack_ar_weights(cfg: ModelConfig, p: dict, weight_dtype, n_blocks: int) -> dict:
    """The kernel's weights, made once per set of weights (plain torch).

    Every matrix of MATRICES is cut into the blocks' column runs
    (``partition``); block b's slices lie one after another in its region
    of ``w``, each column-major with K padded by 16 bytes (``ldw``), the
    layout the kernel copies into shared memory. Returns ``w`` (weight
    type), ``table`` (n_blocks, TABLE_COLS) int32, ``meta`` (matrices, 5)
    int32 (K, ldw, unit width, offset in ``vec``, columns), ``vec`` (f32:
    VEC_HEAD scalars, stop's encoder_cell weights, then each matrix's bias
    and scale; all but the temperatures rounded to the weight type) and
    ``w_elems``, the largest region."""
    global packs
    F = cfg.ffn_hidden_dim
    vec_elems = 16 // torch.tensor([], dtype=weight_dtype).element_size()
    w = {k: v.float() for k, v in _weights(p).items()}

    def rnd(x):
        return x.to(weight_dtype).float()

    mats = _packed_matrices(cfg, w)
    parts = partition(cfg, n_blocks)
    dev = w["Q.kernel"].device
    temps = torch.stack([p["temperature"].detach().reshape(()), p["content_temp"].detach().reshape(())])
    vec = [temps.float().to(dev), rnd(w["stop.bias"].reshape(1)), torch.zeros(1, device=dev),
           rnd(w["stop.kernel"][F:, 0])]
    meta = []
    off = VEC_HEAD + F
    for W, width, bias, scale in mats:
        K, n = W.shape
        meta.append([K, K + vec_elems, width, off, n])
        vec += [rnd(bias), rnd(scale)]
        off += 2 * n
    table = torch.zeros(n_blocks, TABLE_COLS, dtype=torch.int32)
    regions, at, w_elems = [], 0, 0
    for b in range(n_blocks):
        cols, length = [], 0
        for m, (W, width, _, _) in enumerate(mats):
            K, ldw = meta[m][0], meta[m][1]
            u0, nu = parts[m][0][b], parts[m][1][b]
            sl = torch.zeros(nu * width, ldw, device=dev)
            sl[:, :K] = W[:, u0 * width:(u0 + nu) * width].t()
            table[b, 2 + 3 * m:5 + 3 * m] = torch.tensor([u0, nu, length])
            cols.append(sl.reshape(-1))
            length += sl.numel()
        pad = _round_up(length, 8) - length
        cols.append(torch.zeros(pad, device=dev))
        table[b, :2] = torch.tensor([at, length + pad])
        regions += cols
        at += length + pad
        w_elems = max(w_elems, length + pad)
    packs += 1
    return {
        "w": torch.cat(regions).to(weight_dtype), "table": table.to(dev),
        "meta": torch.tensor(meta, dtype=torch.int32, device=dev), "vec": torch.cat(vec).contiguous(),
        "w_elems": w_elems, "n_blocks": n_blocks,
    }


# packs by the identity and version of every weight tensor; an entry keeps
# its tensors alive, so a new tensor cannot take the address of a cached one
_packs: collections.OrderedDict = collections.OrderedDict()
_PACKS_KEPT = 4


def packed_weights(cfg: ModelConfig, p: dict, weight_dtype, n_blocks: int) -> dict:
    """``pack_ar_weights``, made again only when a weight tensor was
    replaced or written in place (its address or version changed)."""
    tensors = list(_weights(p).values()) + [p["temperature"].detach(), p["content_temp"].detach()]
    key = (cfg, weight_dtype, n_blocks, tuple(
        (x.data_ptr(), x._version, x.dtype, x.device, tuple(x.shape), x.stride()) for x in tensors))
    hit = _packs.get(key)
    if hit is None:
        hit = (tensors, pack_ar_weights(cfg, p, weight_dtype, n_blocks))
        _packs[key] = hit
        while len(_packs) > _PACKS_KEPT:
            _packs.popitem(last=False)
    _packs.move_to_end(key)
    return hit[1]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ar_decode: {msg}")


def stage_names() -> list[str]:
    """What each slot of ``ar_decode_cuda``'s ``stage_ns`` times."""
    return _library().ar_decode_stage_names().decode().split(",")


def ar_decode_cuda(cfg: ModelConfig, p: dict, enc: dict, bos: torch.Tensor,
                   n_steps: int | None = None, weight_dtype=torch.bfloat16,
                   stage_ns: torch.Tensor | None = None):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``stage_ns``, an int64 tensor on the device with one slot per
    ``stage_names()``, gets each stage's nanoseconds (block 0's clock from
    one grid barrier to the next, summed over the steps) added to it."""
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
    _check(F % 32 == 0 and 2 * L == F, "need ffn_hidden_dim % 32 == 0 and content_latent_dim == ffn_hidden_dim / 2")
    if stage_ns is not None:
        _check(stage_ns.dtype == torch.int64 and stage_ns.device == dev and stage_ns.is_contiguous(),
               f"stage_ns must be a contiguous int64 tensor on {dev}")

    def vec(x):  # f32 values rounded to the weight type
        return x.detach().to(dev).to(weight_dtype).float().contiguous()

    def mat(x):
        return x.detach().to(dev).to(weight_dtype).contiguous()

    with torch.cuda.device(dev):
        lib = _library()
        _check(stage_ns is None or stage_ns.numel() >= len(stage_names()), "stage_ns has too few slots")
        pack = packed_weights(cfg, p, weight_dtype, torch.cuda.get_device_properties(dev).multi_processor_count)
        mel = torch.empty((M, B, NM), device=dev)
        stop = torch.empty((M, B, 1), device=dev)
        attn = torch.empty((M, B, T), device=dev)
        bf16 = int(weight_dtype == torch.bfloat16)
        scratch = torch.empty(lib.ar_decode_scratch_bytes(B, F, L, NM, bf16), dtype=torch.uint8, device=dev)
        barrier = torch.zeros(1, dtype=torch.int32, device=dev)
        tensors = [
            vec(enc["hidden"]), mat(enc["k"]), mat(enc["v"]), mat(enc["content_key"]),
            mat(enc["content_value"]), vec(enc["encoder_cell"]), vec(bos),
            vec(decode_positions(cfg, M, dev)),
            pack["w"], pack["table"], pack["meta"], pack["vec"],
            mel, stop, attn, scratch, barrier,
        ]
        addrs = [x.data_ptr() for x in tensors] + [0 if stage_ns is None else stage_ns.data_ptr()]
        _check(len(addrs) == lib.ar_decode_num_ptrs(), "pointer list out of step with the kernel")
        dims = [B, T, S, F, L, NM, M, bf16, pack["n_blocks"], pack["w_elems"]]
        _check(len(dims) == lib.ar_decode_num_dims(), "dims out of step with the kernel")
        ptrs = (ctypes.c_void_p * len(addrs))(*addrs)
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
