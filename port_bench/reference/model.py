"""The plain reference of the Lip2Speech model, in plain PyTorch.

A frozen, independent statement of the function that the benchmark holds
the program to: the mouth-video encoder (Conv3d front end and ShuffleNetV2
trunk), the face-identity net (InceptionResnetV1 and its projection), the
decoder (BiLSTM encode, K/V conv banks, gumbel content codebook, the
autoregressive loop, the postnet), free-running and teacher-forced. The
parameters carry the reference implementation's names, so one state dict
loads into this model and into the program's with ``strict=True``.

Everything is computed in the type of the weights it is given (f32 in the
benchmark), with every LSTM written out as its cell steps and every
attention as batched products, so that ``torch.utils.flop_counter`` sees
each product. Every operand of a product passes through ``ctx.q``: the
identity for the reference, a rounding to a lower precision for the
control (``precision.py``).

This file imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.precision import exact, unrounded

SHUFFLE_CHANNELS = {1.0: (24, 116, 232, 464, 768), 0.5: (24, 48, 96, 192, 768)}
SHUFFLE_REPEATS = (4, 8, 4)


@dataclasses.dataclass
class Ctx:
    """What a forward needs besides its inputs: ``train`` (BatchNorms on
    batch statistics, dropout on), ``q`` (the rounding of every product's
    operands), ``score_grad`` (off: no gradient flows back through the AR
    loop's two attention scores, to their queries, keys and temperatures)
    and ``stats`` (filled with each trained BatchNorm's new running
    statistics, by buffer name)."""

    train: bool = False
    q: Callable[[torch.Tensor], torch.Tensor] = exact
    score_grad: bool = True
    stats: dict = dataclasses.field(default_factory=dict)

    def scores(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.score_grad else x.detach()


# ----------------------------------------------------------------- products

def linear(ctx, x, m: nn.Linear):
    return F.linear(ctx.q(x), ctx.q(m.weight), m.bias)


def conv(ctx, x, m):
    fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[m.weight.ndim - 2]
    return fn(ctx.q(x), ctx.q(m.weight), m.bias, m.stride, m.padding, m.dilation, m.groups)


def mm(ctx, a, b):
    return torch.matmul(ctx.q(a), ctx.q(b))


def batch_norm(ctx, x, m, name: str):
    """Eval: the running statistics. Train (flax's rule): the batch mean and
    biased variance in f32, and the scale they make, under any rounding;
    the new statistics 0.9 * old + 0.1 * batch go to ``ctx.stats``."""
    if not ctx.train:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    with unrounded():  # the statistics and the scale they make stay f32 under any rounding
        mean = x.mean(dims)
        var = torch.clamp(torch.square(x).mean(dims) - torch.square(mean), min=0.0)
        mul = torch.rsqrt(var + m.eps) * m.weight
    with torch.no_grad():
        ctx.stats[f"{name}.running_mean"] = 0.9 * m.running_mean + 0.1 * mean
        ctx.stats[f"{name}.running_var"] = 0.9 * m.running_var + 0.1 * var
    return (x - mean.view(shape)) * mul.view(shape) + m.bias.view(shape)


def dropout(x, keep, rate):
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


def psine(x, w, channel_dim=-1):
    return torch.sin(x) * (w if channel_dim == -1 else w.view(-1, *([1] * (x.ndim - 1 - channel_dim))))


def lstm_cell(ctx, wx, wh, b, x, h, c):
    """Gate order (i, f, g, o)."""
    gates = mm(ctx, x, wx.t()) + mm(ctx, h, wh.t()) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def adaptive_avg_pool_matrix(in_len: int, out_len: int) -> np.ndarray:
    m = np.zeros((in_len, out_len), np.float32)
    for j in range(out_len):
        lo, hi = (j * in_len) // out_len, -(-((j + 1) * in_len) // out_len)
        m[lo:hi, j] = 1.0 / (hi - lo)
    return m


class LSTMWeights(nn.Module):
    """An LSTM's parameters under ``nn.LSTM``'s names, no code."""

    def __init__(self, n_in, hidden, layers=1, bidirectional=False):
        super().__init__()
        for layer in range(layers):
            for sfx in ([""] + (["_reverse"] if bidirectional else [])):
                k = n_in if layer == 0 else hidden
                self.register_parameter(f"weight_ih_l{layer}{sfx}", nn.Parameter(torch.empty(4 * hidden, k)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}", nn.Parameter(torch.empty(4 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}", nn.Parameter(torch.empty(4 * hidden)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}", nn.Parameter(torch.empty(4 * hidden)))

    def cell(self, layer):
        g = lambda n: getattr(self, n.format(layer))  # noqa: E731
        return (g("weight_ih_l{}"), g("weight_hh_l{}"), g("bias_ih_l{}") + g("bias_hh_l{}"))

    def cell_reverse(self, layer):
        g = lambda n: getattr(self, n.format(layer))  # noqa: E731
        return (g("weight_ih_l{}_reverse"), g("weight_hh_l{}_reverse"),
                g("bias_ih_l{}_reverse") + g("bias_hh_l{}_reverse"))


class PSine(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.w = nn.Parameter(torch.ones(dims))


class LinearNorm(nn.Module):
    def __init__(self, i, o, bias=True):
        super().__init__()
        self.linear_layer = nn.Linear(i, o, bias=bias)


class ConvNorm(nn.Module):
    def __init__(self, i, o, k):
        super().__init__()
        self.conv = nn.Conv1d(i, o, k, padding=(k - 1) // 2)


# ----------------------------------------------------------- video encoder

def _conv_bn(cin, cout, k, stride=1, groups=1):
    return [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False), nn.BatchNorm2d(cout)]


class ShuffleUnit(nn.Module):
    def __init__(self, in_c, out_c, downsample):
        super().__init__()
        half = out_c // 2
        stride = 2 if downsample else 1
        self.downsample = downsample
        if downsample:
            self.banch1 = nn.Sequential(*_conv_bn(in_c, in_c, 3, stride, in_c), *_conv_bn(in_c, half, 1), nn.ReLU())
        b2 = in_c if downsample else half
        self.banch2 = nn.Sequential(*_conv_bn(b2, half, 1), nn.ReLU(), *_conv_bn(half, half, 3, stride, half),
                                    *_conv_bn(half, half, 1), nn.ReLU())


def run_seq(ctx, seq: nn.Sequential, x, name: str):
    """Conv / BatchNorm / ReLU sequences, as the trunk's branches are."""
    for i, m in enumerate(seq):
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            x = conv(ctx, x, m)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            x = batch_norm(ctx, x, m, f"{name}.{i}")
        elif isinstance(m, nn.ReLU):
            x = F.relu(x)
        else:
            raise TypeError(type(m))
    return x


def shuffle(x):
    b, c, h, w = x.shape
    return x.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


class VideoEncoder(nn.Module):
    def __init__(self, width=1.0):
        super().__init__()
        chans = SHUFFLE_CHANNELS[width]
        self.frontend3D = nn.Sequential(
            nn.Conv3d(3, chans[0], (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
            nn.BatchNorm3d(chans[0]), nn.PReLU(chans[0]))
        units, in_c = [], chans[0]
        for s, reps in enumerate(SHUFFLE_REPEATS):
            for i in range(reps):
                units.append(ShuffleUnit(in_c, chans[s + 1], i == 0))
                in_c = chans[s + 1]
        self.trunk = nn.Sequential(nn.Sequential(*units), nn.Sequential(*_conv_bn(in_c, chans[-1], 1), nn.ReLU()))

    def forward(self, ctx, video):
        B, T = video.shape[:2]
        f = self.frontend3D
        x = conv(ctx, video.permute(0, 4, 1, 2, 3), f[0])
        x = batch_norm(ctx, x, f[1], "encoder.frontend3D.1")
        x = F.prelu(x, f[2].weight)
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = x.transpose(1, 2).reshape(B * T, x.shape[1], x.shape[3], x.shape[4])
        for u, unit in enumerate(self.trunk[0]):
            name = f"encoder.trunk.0.{u}"
            if unit.downsample:
                x = torch.cat([run_seq(ctx, unit.banch1, x, f"{name}.banch1"),
                               run_seq(ctx, unit.banch2, x, f"{name}.banch2")], 1)
            else:
                h = x.shape[1] // 2
                x = torch.cat([x[:, :h], run_seq(ctx, unit.banch2, x[:, h:], f"{name}.banch2")], 1)
            x = shuffle(x)
        x = run_seq(ctx, self.trunk[1], x, "encoder.trunk.1").mean(dim=(2, 3)).reshape(B, T, -1)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


# ----------------------------------------------------------------- face net

class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)


def basic(ctx, m: BasicConv2d, x):
    return F.relu(batch_norm(ctx, conv(ctx, x, m.conv), m.bn, "face"))


def chain(ctx, seq, x):
    for m in seq:
        x = basic(ctx, m, x)
    return x


class Block(nn.Module):
    """Block35 / Block17 / Block8 by ``kind``."""

    SPEC = {
        "35": (256, 0.17, [[(1, 0)], [(1, 0), (3, 1)], [(1, 0), (3, 1), (3, 1)]], 32, 96),
        "17": (896, 0.10, [[(1, 0)], [(1, 0), ((1, 7), (0, 3)), ((7, 1), (3, 0))]], 128, 256),
        "8": (1792, 0.20, [[(1, 0)], [(1, 0), ((1, 3), (0, 1)), ((3, 1), (1, 0))]], 192, 384),
    }

    def __init__(self, kind, no_relu=False):
        super().__init__()
        c, self.scale, branches, w, up = self.SPEC[kind]
        self.no_relu = no_relu
        for i, br in enumerate(branches):
            mods = [BasicConv2d(c if j == 0 else w, w, k, padding=p) for j, (k, p) in enumerate(br)]
            setattr(self, f"branch{i}", mods[0] if len(mods) == 1 else nn.Sequential(*mods))
        self.n_branches = len(branches)
        self.conv2d = nn.Conv2d(up, c, 1)

    def forward(self, ctx, x):
        outs = []
        for i in range(self.n_branches):
            br = getattr(self, f"branch{i}")
            outs.append(basic(ctx, br, x) if isinstance(br, BasicConv2d) else chain(ctx, br, x))
        out = x + self.scale * conv(ctx, torch.cat(outs, 1), self.conv2d)
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1), BasicConv2d(192, 192, 3, padding=1),
                                     BasicConv2d(192, 256, 3, stride=2))

    def forward(self, ctx, x):
        return torch.cat([basic(ctx, self.branch0, x), chain(ctx, self.branch1, x), F.max_pool2d(x, 3, 2)], 1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, padding=1),
                                     BasicConv2d(256, 256, 3, stride=2))

    def forward(self, ctx, x):
        return torch.cat([chain(ctx, self.branch0, x), chain(ctx, self.branch1, x),
                          chain(ctx, self.branch2, x), F.max_pool2d(x, 3, 2)], 1)


class Resnet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block("35") for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block("17") for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block("8") for _ in range(5)])
        self.block8 = Block("8", no_relu=True)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = nn.BatchNorm1d(512, eps=1e-3)


class FaceNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet()
        self.projection_layer = nn.Sequential(nn.Linear(512, 512), nn.GELU(), nn.Linear(512, 256))

    def forward(self, ctx, x):
        """Eval mode always (the face net is frozen): (B, 3, H, W) -> the
        ReLU'd, L2-normalised identity embedding (B, 256)."""
        ctx = dataclasses.replace(ctx, train=False)
        r = self.resnet
        for m in (r.conv2d_1a, r.conv2d_2a, r.conv2d_2b):
            x = basic(ctx, m, x)
        x = F.max_pool2d(x, 3, 2)
        for m in (r.conv2d_3b, r.conv2d_4a, r.conv2d_4b):
            x = basic(ctx, m, x)
        for m in [*r.repeat_1, r.mixed_6a, *r.repeat_2, r.mixed_7a, *r.repeat_3, r.block8]:
            x = m(ctx, x)
        x = batch_norm(ctx, linear(ctx, x.mean(dim=(2, 3)), r.last_linear), r.last_bn, "face")
        p = self.projection_layer
        emb = F.relu(linear(ctx, F.gelu(linear(ctx, x, p[0])), p[2]))
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)


# ------------------------------------------------------------------ decoder

class MultiHop(nn.Module):
    KERNELS = (1, 3, 7, 11)

    def __init__(self, c, f):
        super().__init__()
        self.conv = nn.ModuleList(nn.Sequential(nn.Conv1d(c, c, k, padding=k // 2), nn.BatchNorm1d(c))
                                  for k in self.KERNELS)
        self.bottleneck = nn.Conv1d(c * (len(self.KERNELS) + 1), f, 1)

    def forward(self, ctx, x, name):
        outs = [x] + [F.silu(batch_norm(ctx, conv(ctx, x, m[0]), m[1], f"{name}.conv.{i}.1"))
                      for i, m in enumerate(self.conv)]
        return conv(ctx, torch.cat(outs, 1), self.bottleneck)


class Content(nn.Module):
    KERNELS = (1, 3, 5, 7)

    def __init__(self, c, vocab, latent):
        super().__init__()
        self.word_embeddings = nn.Parameter(torch.empty(vocab, latent))
        self.agg = nn.ModuleList(nn.Sequential(nn.Conv1d(c, c, k, stride=k), nn.BatchNorm1d(c))
                                 for k in self.KERNELS)
        self.bottleneck = nn.Conv1d(c * (len(self.KERNELS) + 1), latent, 1)
        self.location_fc = nn.Sequential(nn.Linear(latent, latent), nn.SiLU(), nn.Linear(latent, latent),
                                         nn.SiLU(), nn.Linear(latent, vocab), nn.SiLU())
        self.K = nn.Sequential(nn.Linear(latent, latent), nn.SiLU(), nn.Linear(latent, latent), nn.SiLU())
        self.Q = nn.Sequential(nn.Linear(2 * c, latent), nn.SiLU())
        self.temperature = nn.Parameter(torch.ones(1))


def silu_mlp(ctx, seq, x):
    for m in seq:
        if isinstance(m, nn.Linear):
            x = linear(ctx, x, m)
        else:
            x = F.silu(x)
    return x


class Postnet(nn.Module):
    def __init__(self, n_mels, emb, k, n):
        super().__init__()
        chans = [n_mels] + [emb] * (n - 1) + [n_mels]
        self.convolutions = nn.ModuleList(nn.Sequential(ConvNorm(chans[j], chans[j + 1], k),
                                                        nn.BatchNorm1d(chans[j + 1])) for j in range(n))
        self.sin_activation = nn.ModuleList(PSine(emb) for _ in range(n - 1))

    def forward(self, ctx, x, keep=None, rate=0.0):
        def layer(j, h):
            c = self.convolutions[j]
            return batch_norm(ctx, conv(ctx, h, c[0].conv), c[1], f"decoder.postnet.convolutions.{j}.1")

        for i, act in enumerate(self.sin_activation):
            h = psine(layer(i, x), act.w, channel_dim=1)
            x = dropout(h + x if i else h, None if keep is None else keep[i], rate)
        n = len(self.convolutions) - 1
        return dropout(layer(n, x), None if keep is None else keep[n], rate)


class Decoder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m
        Fh, half, face = m["ffn_hidden_dim"], m["ffn_hidden_dim"] // 2, m["face_embedding_dim"]
        self.BOS = nn.Parameter(torch.empty(1, 1, m["n_mels"]))
        self.encoder_proj = LinearNorm(2 * Fh, Fh)
        self.encoder_site = nn.Sequential(LinearNorm(face, Fh), PSine(Fh))
        self.attention_site = nn.Sequential(LinearNorm(face, Fh), PSine(Fh))
        self.residual_bottleneck = nn.Conv1d(m["encoder_embedding_dim"], Fh, 1)
        self.encoder_rnn = LSTMWeights(m["encoder_embedding_dim"], Fh, bidirectional=True)
        self.E_C = LinearNorm(2 * Fh, Fh)
        self.K = nn.Sequential(MultiHop(Fh, Fh), PSine(Fh))
        self.V = nn.Sequential(MultiHop(Fh, Fh), PSine(Fh))
        self.content = Content(Fh, m["content_vocab_size"], m["content_latent_dim"])
        self.temperature = nn.Parameter(torch.ones(1))
        self.attention_proj = LinearNorm(Fh, half)
        self.prenet = nn.Sequential(LinearNorm(m["n_mels"], half), PSine(half), nn.Dropout(),
                                    LinearNorm(half, half), PSine(half))
        self.Q = nn.Sequential(LinearNorm(2 * Fh, Fh), PSine(Fh))
        self.decoder_rnn = LSTMWeights(Fh, Fh, layers=2)
        self.fc_out = LinearNorm(Fh, m["n_mels"])
        self.stop_token_layer = LinearNorm(2 * Fh, 1)
        self.postnet = Postnet(m["n_mels"], m["postnet_embedding_dim"], m["postnet_kernel_size"],
                               m["postnet_n_convolutions"])

    def lin(self, ctx, x, ln):
        return linear(ctx, x, ln.linear_layer)

    def encode(self, ctx, feats, face, gumbel):
        """Everything before the loop: the BiLSTM, the K/V banks and the
        content codebook (its noise ``gumbel`` (B*S, vocab) is an input)."""
        B, T, _ = feats.shape
        Fh = self.m["ffn_hidden_dim"]
        rb = self.residual_bottleneck
        residual = F.linear(ctx.q(feats), ctx.q(rb.weight[:, :, 0]), rb.bias)
        enc_site = psine(self.lin(ctx, face, self.encoder_site[0]), self.encoder_site[1].w)
        att_site = psine(self.lin(ctx, face, self.attention_site[0]), self.attention_site[1].w)
        rnn = self.encoder_rnn
        outs = []
        finals = []
        for cell, steps in ((rnn.cell(0), range(T)), (rnn.cell_reverse(0), range(T - 1, -1, -1))):
            h = c = enc_site
            seq = [None] * T
            for t in steps:
                h, c = lstm_cell(ctx, *cell, feats[:, t], h, c)
                seq[t] = h
            outs.append(torch.stack(seq, 1))
            finals.append((h, c))
        hidden = torch.stack([finals[0][0], finals[1][0]])
        encoder_cell = self.lin(ctx, torch.cat([finals[0][1], finals[1][1]], -1), self.E_C)
        enc_out = self.lin(ctx, torch.cat(outs, -1), self.encoder_proj) + att_site[:, None] + residual
        pos = torch.as_tensor(sinusoid_table(self.m["max_encoder_positions"], Fh)[:T], device=feats.device,
                              dtype=feats.dtype)
        enc_t = enc_out.transpose(1, 2)
        k_bank = psine(self.K[0](ctx, enc_t, "decoder.K.0").transpose(1, 2), self.K[1].w) + pos
        v_bank = psine(self.V[0](ctx, enc_t, "decoder.V.0").transpose(1, 2), self.V[1].w) + pos
        ck, cv, dist = self.content_forward(ctx, enc_t, gumbel)
        return {"hidden": hidden, "encoder_cell": encoder_cell, "k": k_bank, "v": v_bank,
                "content_key": ck, "content_value": cv, "content_dist": dist}

    def content_forward(self, ctx, x, gumbel):
        c = self.content
        T = x.shape[-1]
        feats, min_t = [x], T
        for i, (k, m) in enumerate(zip(Content.KERNELS, c.agg)):
            h = x if T >= k else F.pad(x, (0, k - T))
            h = F.silu(batch_norm(ctx, conv(ctx, h, m[0]), m[1], f"decoder.content.agg.{i}.1"))
            feats.append(h)
            min_t = min(min_t, h.shape[-1])
        pooled = torch.cat([mm(ctx, f, torch.as_tensor(adaptive_avg_pool_matrix(f.shape[-1], min_t),
                                                       device=x.device, dtype=x.dtype)) for f in feats], 1)
        w = conv(ctx, pooled, c.bottleneck).transpose(1, 2)
        key = silu_mlp(ctx, c.K, w)
        flat = silu_mlp(ctx, c.location_fc, w).reshape(-1, c.word_embeddings.shape[0])
        z = torch.softmax((flat + gumbel) / self.m["gumbel_tau"], dim=-1)
        value = mm(ctx, z, c.word_embeddings).reshape(w.shape[0], min_t, -1)
        return key, value, torch.softmax(flat, dim=-1)

    def loop(self, ctx, enc, M, teacher=None, use_teacher=None, keeps=None):
        """The autoregressive loop over M steps: free-running when
        ``teacher`` is None, else step i reads ``teacher[i]`` where
        ``use_teacher[i]``. ``keeps`` holds the prenet, attention and rnn
        dropout masks (M, B, .)."""
        m = self.m
        keeps = keeps or {}
        Fh = m["ffn_hidden_dim"]
        k_t = enc["k"].transpose(1, 2)
        c_key_t = enc["content_key"].transpose(1, 2)
        B = k_t.shape[0]
        dev, dt = k_t.device, k_t.dtype
        pos = torch.as_tensor(sinusoid_table(max(m["max_decoder_steps"], M), Fh)[:M], device=dev, dtype=dt)
        cells = [self.decoder_rnn.cell(0), self.decoder_rnn.cell(1)]
        h0, h1 = enc["hidden"][0], enc["hidden"][1]
        c0 = torch.zeros_like(h0)
        c1 = torch.zeros_like(h1)
        ys = self.BOS.reshape(1, -1).expand(B, -1)
        mels, stops, attns = [], [], []
        for i in range(M):
            x = ys if teacher is None else torch.where(use_teacher[i], teacher[i], ys)
            pre = psine(self.lin(ctx, x, self.prenet[0]), self.prenet[1].w)
            pre = dropout(pre, keeps.get("prenet", [None] * M)[i], m["prenet_dropout"])
            pre = psine(self.lin(ctx, pre, self.prenet[3]), self.prenet[4].w)
            q = psine(self.lin(ctx, torch.cat([h0, h1], -1), self.Q[0]), self.Q[1].w) + pos[i]
            scores = ctx.scores(mm(ctx, (q * self.temperature)[:, None], k_t)[:, 0])
            scores = dropout(scores, keeps.get("attention", [None] * M)[i], m["attention_dropout"])
            a = torch.softmax(scores, dim=-1)
            o = self.lin(ctx, mm(ctx, a[:, None], enc["v"])[:, 0], self.attention_proj)
            cq = silu_mlp(ctx, self.content.Q, torch.cat([c0, c1], -1))
            ca = torch.softmax(ctx.scores(mm(ctx, (cq * self.content.temperature)[:, None], c_key_t)[:, 0]), dim=-1)
            content_o = mm(ctx, ca[:, None], enc["content_value"])[:, 0]
            h0, c0 = lstm_cell(ctx, *cells[0], torch.cat([content_o, pre + o], -1), h0, c0)
            h0_in = dropout(h0, keeps.get("rnn", [None] * M)[i], m["decoder_rnn_dropout"])
            h1, c1 = lstm_cell(ctx, *cells[1], h0_in, h1, c1)
            ys = self.lin(ctx, h1, self.fc_out)
            stops.append(self.lin(ctx, torch.cat([h1, enc["encoder_cell"]], -1), self.stop_token_layer))
            mels.append(ys)
            attns.append(a)
        return torch.stack(mels, -1), torch.stack(stops, 1), torch.stack(attns, 1)


def teacher_schedule(rand, tf_ratio):
    """Step i reads the teacher frame when ``rand[i] > tf_ratio`` and fewer
    than floor(tf_ratio * M) earlier steps did (the reference's rule)."""
    passed = rand > tf_ratio
    return passed & (torch.cumsum(passed.to(torch.int32), 0) <= math.floor(tf_ratio * rand.shape[0]))


class Lip2SpeechReference(nn.Module):
    """``m`` is the configuration's model section (a dict)."""

    def __init__(self, m: dict):
        super().__init__()
        self.m = m
        self.encoder = VideoEncoder(m["shufflenet_width"])
        self.vgg_face = FaceNet()
        self.decoder = Decoder(m)

    def infer(self, ctx, video, faces, gumbel, n_steps=None):
        """Free-running: normalised video (B, T, H, W, 3), faces (B, n, H,
        W, 3), codebook noise -> mel, mel_postnet (B, n_mels, M), gate (B, M,
        1), lengths (B,), content_dist, speaker_embedding."""
        ctx = dataclasses.replace(ctx, train=False)
        feats = self.encoder(ctx, video)
        spk = self.vgg_face(ctx, faces[:, 0].permute(0, 3, 1, 2))
        T = feats.shape[1]
        enc = self.decoder.encode(ctx, torch.cat([feats, spk[:, None].expand(-1, T, -1)], -1), spk, gumbel)
        mel, gate, _ = self.decoder.loop(ctx, enc, n_steps or self.m["max_decoder_steps"])
        post = self.decoder.postnet(ctx, mel) + mel
        fired = torch.sigmoid(gate[..., 0]) > self.m["gate_threshold"]
        first = torch.argmax(fired.to(torch.int32), dim=1) + 1
        lengths = torch.where(fired.any(1), first, torch.full_like(first, fired.shape[1]))
        return {"mel": mel, "mel_postnet": post, "gate": gate, "lengths": lengths,
                "content_dist": enc["content_dist"], "speaker_embedding": spk}

    def teacher_forced(self, ctx, video, faces, mels, tf_ratio, draws):
        """The train-mode forward (``ctx.train``): dropout from ``draws``
        (encoder (B, T, C), prenet / attention / rnn (M, B, .), postnet: a
        list of (B, C, M)), the teacher schedule from ``draws['teacher']``."""
        m = self.m
        feats = self.encoder(ctx, video)
        if ctx.train:
            feats = dropout(feats, draws["encoder"], m["encoder_feature_dropout"])
        with torch.no_grad():
            spk = self.vgg_face(ctx, faces[:, 0].permute(0, 3, 1, 2))
        T = feats.shape[1]
        dec = self.decoder
        enc = dec.encode(ctx, torch.cat([feats, spk[:, None].expand(-1, T, -1)], -1), spk, draws["gumbel"])
        B, _, M = mels.shape
        bos = dec.BOS.reshape(1, -1)
        teacher = torch.cat([bos[None].expand(B, 1, -1), mels.transpose(1, 2)[:, :M - 1]], 1).transpose(0, 1)
        use = teacher_schedule(draws["teacher"], tf_ratio)
        keeps = {k: draws[k] for k in ("prenet", "attention", "rnn")} if ctx.train else None
        mel, gate, _ = dec.loop(ctx, enc, M, teacher, use, keeps)
        post = dec.postnet(ctx, mel, draws["postnet"] if ctx.train else None, m["postnet_dropout"]) + mel
        return {"mel": mel, "mel_postnet": post, "gate": gate, "content_dist": enc["content_dist"]}
