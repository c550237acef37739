"""Weights carried across from the JAX package or a reference ``.pth``.

``from_flax`` is the port's copy of ``build_entries``, ``_normalize_fpath``
and ``flax_to_torch`` (``lip2speech_tpu/train/checkpoint.py:91-313``): it
takes the flax ``{"params", "batch_stats"}`` tree as numpy arrays and
returns tensors under the reference torch names, which are the port's own
parameter names. Layout rules: flax Dense kernel (in,out) -> torch Linear
(out,in); flax ConvNd (*k,in,out) -> torch (out,in,*k); the folded LSTM bias
goes to ``bias_ih_*`` with zeros in ``bias_hh_*``; BN scale/bias/mean/var ->
weight/bias/running_mean/running_var.

Unlike ``flax_to_torch``, a tree without ``vgg_face`` (a model run with an
external speaker embedding) converts too: the keys of a top-level module
(``encoder``, ``vgg_face``, ``decoder``) that the tree lacks are left out.

``critic_from_flax`` carries the WGAN critic across under its flax names
(``build_entries`` has none for it), and ``speaker_from_flax`` the voice
speaker encoder under the reference names, the inverse of the JAX demo's
mapping (``lip2speech_tpu/cli/demo.py:53-63``). ``named_from_flax`` carries
any tree of Dense, Conv and norm layers whose port modules keep the flax
names (``models/audio_extras.py``, the speaker models), and
``speaker_training_from_flax`` the speaker-pretraining tree (face net,
face decoder, temperature, and the frozen voice encoder).
``rank_from_flax`` gives one rank's state dict of a tensor-parallel model
(``from_flax``, then its slices of the sharded kernels).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.shufflenet import STAGE_REPEATS
from lip2speech_torch.parallel.dist import local_rows
from lip2speech_torch.parallel.tensor import partition_params

T_LINEAR = "linear"
T_CONV1 = "conv1"
T_CONV2 = "conv2"
T_CONV3 = "conv3"
T_NONE = "none"

# flax -> torch layout
_INV: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    T_LINEAR: lambda w: w.T,
    T_CONV1: lambda w: w.transpose(2, 1, 0),
    T_CONV2: lambda w: w.transpose(3, 2, 0, 1),
    T_CONV3: lambda w: w.transpose(4, 3, 0, 1, 2),
    T_NONE: lambda w: w,
}


def _bn(entries, tkey, fpath):
    entries.append((f"{tkey}.weight", ("params",) + fpath + ("scale",), T_NONE))
    entries.append((f"{tkey}.bias", ("params",) + fpath + ("bias",), T_NONE))
    entries.append((f"{tkey}.running_mean", ("batch_stats",) + fpath + ("mean",), T_NONE))
    entries.append((f"{tkey}.running_var", ("batch_stats",) + fpath + ("var",), T_NONE))


def _dense(entries, tkey, fpath, bias=True):
    entries.append((f"{tkey}.weight", ("params",) + fpath + ("kernel",), T_LINEAR))
    if bias:
        entries.append((f"{tkey}.bias", ("params",) + fpath + ("bias",), T_NONE))


def _conv(entries, tkey, fpath, code, bias=True):
    entries.append((f"{tkey}.weight", ("params",) + fpath + ("kernel",), code))
    if bias:
        entries.append((f"{tkey}.bias", ("params",) + fpath + ("bias",), T_NONE))


def _lstm_layer(entries, tprefix, suffix, fpath):
    entries.append((f"{tprefix}.weight_ih_{suffix}", ("params",) + fpath + ("wx",), T_LINEAR))
    entries.append((f"{tprefix}.weight_hh_{suffix}", ("params",) + fpath + ("wh",), T_LINEAR))
    entries.append((f"{tprefix}.bias_ih_{suffix}+{tprefix}.bias_hh_{suffix}",
                    ("params",) + fpath + ("b",), T_NONE))


def _inception_block(entries, t, f, branches):
    for tb, fb in branches:
        _conv(entries, f"{t}.{tb}.conv", f + (fb, "conv"), T_CONV2, bias=False)
        _bn(entries, f"{t}.{tb}.bn", f + (fb, "bn"))


def build_entries(cfg: ModelConfig) -> list[tuple[str, tuple, str]]:
    """(torch_key, flax_path, transform) for every Lip2Speech tensor."""
    e: list[tuple[str, tuple, str]] = []

    # encoder (VideoExtractor)
    _conv(e, "encoder.frontend3D.0", ("encoder", "frontend_conv"), T_CONV3, bias=False)
    _bn(e, "encoder.frontend3D.1", ("encoder", "frontend_bn"))
    e.append(("encoder.frontend3D.2.weight", ("params", "encoder", "frontend_prelu", "alpha"), T_NONE))
    i = 0
    for stage_idx, reps in enumerate(STAGE_REPEATS):
        for r in range(reps):
            t = f"encoder.trunk.0.{i}"
            f = ("encoder", "trunk", f"stage{stage_idx + 2}_{r}")
            if r == 0:
                _conv(e, f"{t}.banch1.0", f + ("b1_dw_conv",), T_CONV2, bias=False)
                _bn(e, f"{t}.banch1.1", f + ("b1_dw_bn",))
                _conv(e, f"{t}.banch1.2", f + ("b1_pw_conv",), T_CONV2, bias=False)
                _bn(e, f"{t}.banch1.3", f + ("b1_pw_bn",))
            _conv(e, f"{t}.banch2.0", f + ("b2_pw1_conv",), T_CONV2, bias=False)
            _bn(e, f"{t}.banch2.1", f + ("b2_pw1_bn",))
            _conv(e, f"{t}.banch2.3", f + ("b2_dw_conv",), T_CONV2, bias=False)
            _bn(e, f"{t}.banch2.4", f + ("b2_dw_bn",))
            _conv(e, f"{t}.banch2.5", f + ("b2_pw2_conv",), T_CONV2, bias=False)
            _bn(e, f"{t}.banch2.6", f + ("b2_pw2_bn",))
            i += 1
    _conv(e, "encoder.trunk.1.0", ("encoder", "trunk", "conv_last_conv"), T_CONV2, bias=False)
    _bn(e, "encoder.trunk.1.1", ("encoder", "trunk", "conv_last_bn"))

    # vgg_face (InceptionResnetV1 + projection)
    rn = "vgg_face.resnet"
    fr = ("vgg_face", "resnet")
    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a", "conv2d_4b"):
        _conv(e, f"{rn}.{name}.conv", fr + (name, "conv"), T_CONV2, bias=False)
        _bn(e, f"{rn}.{name}.bn", fr + (name, "bn"))
    for i5 in range(5):
        t, f = f"{rn}.repeat_1.{i5}", fr + (f"repeat_1_{i5}",)
        _inception_block(e, t, f, [("branch0", "branch0"),
                                   ("branch1.0", "branch1_0"), ("branch1.1", "branch1_1"),
                                   ("branch2.0", "branch2_0"), ("branch2.1", "branch2_1"), ("branch2.2", "branch2_2")])
        _conv(e, f"{t}.conv2d", f + ("conv2d",), T_CONV2)
    _inception_block(e, f"{rn}.mixed_6a", fr + ("mixed_6a",),
                     [("branch0", "branch0"), ("branch1.0", "branch1_0"),
                      ("branch1.1", "branch1_1"), ("branch1.2", "branch1_2")])
    for i10 in range(10):
        t, f = f"{rn}.repeat_2.{i10}", fr + (f"repeat_2_{i10}",)
        _inception_block(e, t, f, [("branch0", "branch0"),
                                   ("branch1.0", "branch1_0"), ("branch1.1", "branch1_1"), ("branch1.2", "branch1_2")])
        _conv(e, f"{t}.conv2d", f + ("conv2d",), T_CONV2)
    _inception_block(e, f"{rn}.mixed_7a", fr + ("mixed_7a",),
                     [("branch0.0", "branch0_0"), ("branch0.1", "branch0_1"),
                      ("branch1.0", "branch1_0"), ("branch1.1", "branch1_1"),
                      ("branch2.0", "branch2_0"), ("branch2.1", "branch2_1"), ("branch2.2", "branch2_2")])
    for i5 in range(5):
        t, f = f"{rn}.repeat_3.{i5}", fr + (f"repeat_3_{i5}",)
        _inception_block(e, t, f, [("branch0", "branch0"),
                                   ("branch1.0", "branch1_0"), ("branch1.1", "branch1_1"), ("branch1.2", "branch1_2")])
        _conv(e, f"{t}.conv2d", f + ("conv2d",), T_CONV2)
    _inception_block(e, f"{rn}.block8", fr + ("block8",),
                     [("branch0", "branch0"), ("branch1.0", "branch1_0"),
                      ("branch1.1", "branch1_1"), ("branch1.2", "branch1_2")])
    _conv(e, f"{rn}.block8.conv2d", fr + ("block8", "conv2d"), T_CONV2)
    _dense(e, f"{rn}.last_linear", fr + ("last_linear",), bias=False)
    _bn(e, f"{rn}.last_bn", fr + ("last_bn",))
    _dense(e, "vgg_face.projection_layer.0", ("vgg_face", "proj_0"))
    _dense(e, "vgg_face.projection_layer.2", ("vgg_face", "proj_1"))

    # decoder
    d = ("decoder",)
    e.append(("decoder.BOS", ("params",) + d + ("BOS",), "bos"))
    _dense(e, "decoder.encoder_proj.linear_layer", d + ("encoder_proj", "Dense_0"))
    _dense(e, "decoder.encoder_site.0.linear_layer", d + ("encoder_site", "Dense_0"))
    e.append(("decoder.encoder_site.1.w", ("params",) + d + ("encoder_site_psine", "w"), T_NONE))
    _dense(e, "decoder.attention_site.0.linear_layer", d + ("attention_site", "Dense_0"))
    e.append(("decoder.attention_site.1.w", ("params",) + d + ("attention_site_psine", "w"), T_NONE))
    e.append(("decoder.residual_bottleneck.weight", ("params",) + d + ("residual_bottleneck", "kernel"), "conv1_as_dense"))
    e.append(("decoder.residual_bottleneck.bias", ("params",) + d + ("residual_bottleneck", "bias"), T_NONE))
    _lstm_layer(e, "decoder.encoder_rnn", "l0", d + ("encoder_rnn", "l0_fwd"))
    _lstm_layer(e, "decoder.encoder_rnn", "l0_reverse", d + ("encoder_rnn", "l0_bwd"))
    _dense(e, "decoder.E_C.linear_layer", d + ("E_C", "Dense_0"))
    for bank, fb in (("K", "K_bank"), ("V", "V_bank")):
        for j, kk in enumerate((1, 3, 7, 11)):
            _conv(e, f"decoder.{bank}.0.conv.{j}.0", d + (fb, f"conv_k{kk}"), T_CONV1)
            _bn(e, f"decoder.{bank}.0.conv.{j}.1", d + (fb, f"bn_k{kk}"))
        _conv(e, f"decoder.{bank}.0.bottleneck", d + (fb, "bottleneck"), T_CONV1)
        e.append((f"decoder.{bank}.1.w", ("params",) + d + (f"{bank[0]}_psine", "w"), T_NONE))
    ct = "decoder.content"
    fc = d + ("content",)
    e.append((f"{ct}.word_embeddings", ("params",) + fc + ("word_embeddings",), T_NONE))
    for j, kk in enumerate((1, 3, 5, 7)):
        _conv(e, f"{ct}.agg.{j}.0", fc + (f"agg_k{kk}",), T_CONV1)
        _bn(e, f"{ct}.agg.{j}.1", fc + (f"agg_bn_k{kk}",))
    _conv(e, f"{ct}.bottleneck", fc + ("bottleneck",), T_CONV1)
    for j, nm in ((0, "loc_0"), (2, "loc_1"), (4, "loc_2")):
        _dense(e, f"{ct}.location_fc.{j}", fc + (nm,))
    _dense(e, f"{ct}.K.0", fc + ("K_0",))
    _dense(e, f"{ct}.K.2", fc + ("K_1",))
    _dense(e, f"{ct}.Q.0", d + ("content_Q",), bias=True)
    e.append((f"{ct}.temperature", ("params",) + d + ("content_temperature",), T_NONE))
    e.append(("decoder.temperature", ("params",) + d + ("temperature",), T_NONE))
    _dense(e, "decoder.attention_proj.linear_layer", d + ("attention_proj",))
    _dense(e, "decoder.prenet.0.linear_layer", d + ("prenet0",))
    e.append(("decoder.prenet.1.w", ("params",) + d + ("prenet0_psine_w",), T_NONE))
    _dense(e, "decoder.prenet.3.linear_layer", d + ("prenet1",))
    e.append(("decoder.prenet.4.w", ("params",) + d + ("prenet1_psine_w",), T_NONE))
    _dense(e, "decoder.Q.0.linear_layer", d + ("Q",))
    e.append(("decoder.Q.1.w", ("params",) + d + ("Q_psine_w",), T_NONE))
    _lstm_layer(e, "decoder.decoder_rnn", "l0", d + ("decoder_rnn_l0",))
    _lstm_layer(e, "decoder.decoder_rnn", "l1", d + ("decoder_rnn_l1",))
    _dense(e, "decoder.fc_out.linear_layer", d + ("fc_out",))
    _dense(e, "decoder.stop_token_layer.linear_layer", d + ("stop_token",))

    pn = "decoder.postnet"
    fp = d + ("postnet",)
    n = cfg.postnet_n_convolutions
    for j in range(n):
        _conv(e, f"{pn}.convolutions.{j}.0.conv", fp + (f"conv_{j}",), T_CONV1)
        _bn(e, f"{pn}.convolutions.{j}.1", fp + (f"bn_{j}",))
        if j < n - 1:
            e.append((f"{pn}.sin_activation.{j}.w", ("params",) + fp + (f"psine_{j}", "w"), T_NONE))
    return e


# the flax Decoder keeps its AR-step parameters flat (decoder/prenet0_kernel)
_FLAT_DENSE = {"prenet0", "prenet1", "Q", "attention_proj", "content_Q", "fc_out", "stop_token"}


def _normalize_fpath(path: tuple) -> tuple:
    if len(path) >= 3 and path[1] == "decoder":
        leafdict, leaf = path[-2], path[-1]
        if leafdict in _FLAT_DENSE and leaf in ("kernel", "bias"):
            return path[:-2] + (f"{leafdict}_{leaf}",)
        if leafdict in ("decoder_rnn_l0", "decoder_rnn_l1") and leaf in ("wx", "wh", "b"):
            return path[:-2] + (f"{leafdict}_{leaf}",)
        if leaf == "w" and leafdict in ("prenet0_psine_w", "prenet1_psine_w", "Q_psine_w"):
            return path[:-1]
    return path


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def from_flax(variables: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree of numpy arrays -> state dict
    under the reference torch names. Keys of a top-level module the tree
    lacks are left out."""
    present = set(variables["params"])
    sd: dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))

    for tkey, fpath, code in build_entries(cfg):
        if fpath[1] not in present:
            continue
        fpath = _normalize_fpath(fpath)
        val = np.asarray(_get(variables[fpath[0]], fpath[1:]))
        if "+" in tkey:
            k1, k2 = tkey.split("+")
            put(k1, val)
            put(k2, np.zeros_like(val))
        elif code == "bos":
            put(tkey, val.reshape(1, 1, -1))
        elif code == "conv1_as_dense":
            put(tkey, val.T[:, :, None])
        else:
            put(tkey, _INV[code](val))
    return sd


def rank_from_flax(variables: dict, cfg: ModelConfig, model_index: int,
                   n_model: int) -> dict[str, torch.Tensor]:
    """``from_flax`` for model index ``model_index`` of a model axis of
    ``n_model``: every tensor that ``parallel.tensor.partition_params``
    shards cut to this index's output channels (the state dict of a rank
    after ``tensor.shard_``), the rest whole."""
    sd = from_flax(variables, cfg)
    sharded = partition_params({k: tuple(v.shape) for k, v in sd.items()}, n_model)
    return {k: v if k not in sharded else
            local_rows(v, model_index, n_model, sharded[k]).contiguous() for k, v in sd.items()}


def critic_from_flax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """The flax ``Discriminator``'s params and batch_stats (numpy arrays) ->
    the state dict of ``models.discriminator.Discriminator``, whose modules
    keep the flax names."""
    return named_from_flax(params, batch_stats)


def speaker_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The flax ``SpeakerEncoder``'s params (numpy arrays) -> the state dict
    of ``models.speaker.SpeakerEncoder``: the folded LSTM bias in
    ``bias_ih_l{l}``, zeros in ``bias_hh_l{l}``."""
    sd = {}
    for l in range(len(params["lstm"])):
        cell = params["lstm"][f"l{l}_fwd"]
        sd[f"lstm.weight_ih_l{l}"] = np.asarray(cell["wx"]).T
        sd[f"lstm.weight_hh_l{l}"] = np.asarray(cell["wh"]).T
        sd[f"lstm.bias_ih_l{l}"] = np.asarray(cell["b"])
        sd[f"lstm.bias_hh_l{l}"] = np.zeros_like(np.asarray(cell["b"]))
    sd["linear.weight"] = np.asarray(params["linear"]["kernel"]).T
    sd["linear.bias"] = np.asarray(params["linear"]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_reference_pth(path: str) -> tuple[dict, dict]:
    """Load a combined reference checkpoint. Returns (model_state,
    speaker_encoder_state); the ``speaker_encoder.*`` split mirrors the
    reference demo.py:33-43."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    speaker = {k[len("speaker_encoder."):]: v for k, v in sd.items()
               if k.startswith("speaker_encoder.")}
    main = {k: v for k, v in sd.items() if not k.startswith("speaker_encoder.")}
    return main, speaker


# flax leaf -> torch leaf of the tensors ``named_from_flax`` carries
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}
# flax kernel rank -> torch layout (a Dense kernel, a 1-D and a 2-D conv)
_BY_RANK = {2: _INV[T_LINEAR], 3: _INV[T_CONV1], 4: _INV[T_CONV2]}


def named_from_flax(params: dict, batch_stats: dict | None = None,
                    rename: dict[str, str] | None = None) -> dict[str, torch.Tensor]:
    """A flax tree of Dense, Conv, BatchNorm and GroupNorm layers (numpy
    arrays) -> the state dict of a port module that keeps the flax module
    names, each joined by ``.``; ``rename`` maps a flax module name to the
    port's (``ConvBlock_0`` -> ``blocks.0``)."""
    rename = rename or {}
    sd = {}

    def walk(kind, tree, path):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(kind, v, path + (rename.get(k, k),))
                continue
            v = np.array(v)  # a copy: a JAX array's buffer is read-only
            if kind == "params" and k == "kernel":
                v = _BY_RANK[v.ndim](v)
            sd[".".join(path + (_LEAF[(kind, k)],))] = torch.from_numpy(np.ascontiguousarray(v))

    walk("params", params, ())
    walk("batch_stats", batch_stats or {}, ())
    return sd


FACE_DECODER_RENAME = {**{f"ConvBlock_{i}": f"blocks.{i}" for i in range(4)},
                       **{f"Conv_{i}": f"up.{i}" for i in range(4)}}


def speaker_training_from_flax(params: dict, batch_stats: dict,
                               speaker_params: dict | None = None) -> dict[str, torch.Tensor]:
    """The JAX speaker-pretraining ``params`` (``{"face", "decoder", "t"}``)
    and ``batch_stats`` (``{"face", "decoder"}``), numpy arrays -> the state
    dict of ``speaker.train_loop.SpeakerTraining``: ``face.*`` under the
    face net's reference names, ``decoder.*``, ``t``, and with
    ``speaker_params`` (the frozen voice encoder's params) ``speaker.*``."""
    variables = {"params": {"vgg_face": params["face"]},
                 "batch_stats": {"vgg_face": batch_stats["face"]}}
    sd = {}
    for tkey, fpath, code in build_entries(ModelConfig()):
        if tkey.startswith("vgg_face."):
            val = np.array(_get(variables, fpath))  # a copy: a JAX array is read-only
            sd["face." + tkey[len("vgg_face."):]] = torch.from_numpy(
                np.ascontiguousarray(_INV[code](val)))
    dec = named_from_flax(params["decoder"], batch_stats["decoder"], FACE_DECODER_RENAME)
    sd.update({f"decoder.{k}": v for k, v in dec.items()})
    sd["t"] = torch.tensor(float(np.asarray(params["t"])))
    if speaker_params is not None:
        sd.update({f"speaker.{k}": v for k, v in speaker_from_flax(speaker_params).items()})
    return sd
