"""Autoregressive mel decoder (PyTorch).

Counterpart of ``lip2speech_tpu/models/decoder.py`` with the reference
module names: the face-conditioned BiLSTM encoder, the K/V multi-kernel
conv banks, the gumbel content codebook, the AR loop and the postnet.

Two forwards, as in the JAX ``Decoder.__call__``:

- free-running (``mels=None``): eval-mode BatchNorm, no dropout; the AR
  loop is ``kernels.ar_decode``, the CUDA kernel on the GPU and its plain
  step loop on the CPU;
- teacher-forced (``mels`` given, ``decoder.py:426-518``): a plain PyTorch
  step loop over the scan step (``_build_step``, ``decoder.py:230-313``)
  with autograd through it. In train mode its BatchNorms train by flax's
  rule and dropout applies; every random draw is an input (``draws``) or
  comes from the caller's ``torch.Generator``.

The evaluation forward (eval mode, ``mels`` given, ``tf_ratio >= 1``) uses
no teacher frame: a step reads one only when its uniform draw exceeds
``tf_ratio`` (``decoder.py:266``), and with no dropout it is the
free-running decode cut to the mels' ``M`` steps. It runs through
``ar_decode`` with ``n_steps=M``, without gradients.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.kernels.ar_decode import ar_decode, decode_positions
from lip2speech_torch.models.layers import (
    BatchNorm1d,
    ConvNorm,
    LinearNorm,
    PSine,
    RankAware,
    at_least_f32,
    clip_grad_norm,
    dropout,
    keep_mask,
    lstm_cell_step,
    sinusoid_table,
)
from lip2speech_torch.parallel import tensor
from lip2speech_torch.parallel.dist import uniform
from lip2speech_torch.utils import trace


@functools.lru_cache(maxsize=64)
def adaptive_avg_pool_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) averaging matrix with torch ``adaptive_avg_pool1d``'s
    bins (decoder.py:61-71); returned read-only."""
    m = np.zeros((in_len, out_len), np.float32)
    for j in range(out_len):
        lo = (j * in_len) // out_len
        hi = -(-((j + 1) * in_len) // out_len)
        m[lo:hi, j] = 1.0 / (hi - lo)
    m.setflags(write=False)
    return m


def gumbel_noise(shape, generator, device) -> torch.Tensor:
    """-log(-log(U)) in f32, ``shape[0]`` the batch axis."""
    u = uniform(shape, generator, device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def teacher_schedule(rand: torch.Tensor, tf_ratio) -> torch.Tensor:
    """(M,) bool: which steps read the teacher frame. The rule is inverted
    against its name (``decoder.py:266-268, 469-471``): step i uses it when
    ``rand[i] > tf_ratio`` and fewer than ``floor(tf_ratio * M)`` teacher
    frames were used before, i.e. the first ``floor(tf_ratio * M)`` steps
    whose draw passes."""
    tf = torch.as_tensor(tf_ratio, dtype=torch.float32, device=rand.device)
    budget = torch.floor(tf * rand.shape[0])
    passed = rand > tf
    return passed & (torch.cumsum(passed.to(torch.int32), 0) <= budget)


class MultiHopConv(nn.Module):
    """Conv bank k=1,3,7,11 (each + BN + SiLU) and a 1x1 bottleneck over
    the concatenation with the input; (B, C, T) -> (B, features, T). The
    five convs are column-parallel under tensor parallelism
    (``parallel.tensor``)."""

    KERNELS = (1, 3, 7, 11)

    def __init__(self, channels: int, features: int):
        super().__init__()
        self.conv = nn.ModuleList(
            nn.Sequential(tensor.Conv1d(channels, channels, k, padding=k // 2),
                          BatchNorm1d(channels))
            for k in self.KERNELS
        )
        self.bottleneck = tensor.Conv1d(channels * (len(self.KERNELS) + 1), features, 1)

    def forward(self, x):
        return self.bottleneck(torch.cat([x] + [F.silu(m(x)) for m in self.conv], dim=1))


class ContentEncoder(RankAware, nn.Module):
    """Multi-scale aggregation + gumbel codebook (decoder.py:152-222).
    Also holds the AR loop's content query ``Q`` and ``temperature``."""

    KERNELS = (1, 3, 5, 7)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = cfg.ffn_hidden_dim
        vocab, latent = cfg.content_vocab_size, cfg.content_latent_dim
        self.tau = cfg.gumbel_tau
        self.grad_clip = cfg.content_grad_clip
        self.word_embeddings = nn.Parameter(torch.rand(vocab, latent))
        self.agg = nn.ModuleList(
            nn.Sequential(nn.Conv1d(c, c, k, stride=k), BatchNorm1d(c)) for k in self.KERNELS
        )
        self.bottleneck = nn.Conv1d(c * (len(self.KERNELS) + 1), latent, 1)
        self.location_fc = nn.Sequential(
            nn.Linear(latent, latent), nn.SiLU(), nn.Linear(latent, latent), nn.SiLU(),
            nn.Linear(latent, vocab), nn.SiLU(),
        )
        self.K = nn.Sequential(nn.Linear(latent, latent), nn.SiLU(), nn.Linear(latent, latent), nn.SiLU())
        self.Q = nn.Sequential(nn.Linear(2 * c, latent), nn.SiLU())
        self.temperature = nn.Parameter(torch.full((1,), math.sqrt(latent)))

    def forward(self, x, gumbel: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """x (B, C, T) -> key (B, S, latent), value (B, S, latent),
        dist (B*S, vocab). ``gumbel`` (B*S, vocab) is the noise of the
        codebook draw, f32; drawn from ``generator`` when not given. With
        ``content_grad_clip`` set, the logits' cotangent is clipped
        (``decoder.py:198-210``)."""
        T = x.shape[-1]
        feats = [x]
        min_t = T
        for k, m in zip(self.KERNELS, self.agg):
            # a scale whose strided VALID conv would emit no frame is padded
            # up to one frame (the reference never sees T < 7)
            h = x if T >= k else F.pad(x, (0, k - T))
            h = F.silu(m(h))
            feats.append(h)
            min_t = min(min_t, h.shape[-1])
        pooled = torch.cat([
            f @ torch.tensor(adaptive_avg_pool_matrix(f.shape[-1], min_t), dtype=f.dtype, device=f.device)
            for f in feats
        ], dim=1)
        w = self.bottleneck(pooled).transpose(1, 2)  # (B, S, latent)
        key = self.K(w)
        flat = self.location_fc(w).reshape(-1, self.word_embeddings.shape[0])
        if self.grad_clip > 0.0:
            flat = clip_grad_norm(flat, self.grad_clip, self.dp)
        if gumbel is None:
            gumbel = gumbel_noise(flat.shape, generator, flat.device)
        z = torch.softmax((flat + gumbel.to(flat.dtype)) / self.tau, dim=-1)
        value = (z @ self.word_embeddings).reshape(w.shape[0], min_t, -1)
        return key, value, torch.softmax(flat, dim=-1)


class Postnet(nn.Module):
    """5-conv residual mel refiner with PSine activations;
    (B, n_mels, M) -> (B, n_mels, M). ``keep`` holds one keep mask per conv,
    (B, C_out, M), applied after the residual add (after the last BN for
    the last conv); ``None`` applies no dropout (``decoder.py:104-149``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.rate = cfg.postnet_dropout
        n, k, emb = cfg.postnet_n_convolutions, cfg.postnet_kernel_size, cfg.postnet_embedding_dim
        chans = [cfg.n_mels] + [emb] * (n - 1) + [cfg.n_mels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[j], chans[j + 1], k), BatchNorm1d(chans[j + 1]))
            for j in range(n)
        )
        self.sin_activation = nn.ModuleList(PSine(emb) for _ in range(n - 1))

    def forward(self, x, keep: list[torch.Tensor] | None = None):
        def drop(h, i):
            return h if keep is None else dropout(h, keep[i], self.rate)

        for i, act in enumerate(self.sin_activation):
            h = act(self.convolutions[i](x), channel_dim=1)
            x = drop(h + x if i != 0 else h, i)
        return drop(self.convolutions[-1](x), len(self.convolutions) - 1)


class Decoder(RankAware, nn.Module):
    """Encoder features (B, T, E) + face embedding (B, 256) -> mels, gate
    logits, attention, lengths; free-running or teacher-forced."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        Fh = cfg.ffn_hidden_dim
        half = Fh // 2
        face = cfg.face_embedding_dim
        self.BOS = nn.Parameter(torch.randn(1, 1, cfg.n_mels))
        self.encoder_proj = LinearNorm(2 * Fh, Fh)
        self.encoder_site = nn.Sequential(LinearNorm(face, Fh), PSine(Fh))
        self.attention_site = nn.Sequential(LinearNorm(face, Fh), PSine(Fh))
        self.residual_bottleneck = nn.Conv1d(cfg.encoder_embedding_dim, Fh, 1)
        self.encoder_rnn = nn.LSTM(cfg.encoder_embedding_dim, Fh, batch_first=True, bidirectional=True)
        self.E_C = LinearNorm(2 * Fh, Fh)
        self.K = nn.Sequential(MultiHopConv(Fh, Fh), PSine(Fh))
        self.V = nn.Sequential(MultiHopConv(Fh, Fh), PSine(Fh))
        self.content = ContentEncoder(cfg)
        self.temperature = nn.Parameter(torch.full((1,), math.sqrt(Fh)))
        self.attention_proj = LinearNorm(Fh, half)
        self.prenet = nn.Sequential(LinearNorm(cfg.n_mels, half), PSine(half),
                                    nn.Dropout(cfg.prenet_dropout), LinearNorm(half, half), PSine(half))
        self.Q = nn.Sequential(LinearNorm(2 * Fh, Fh), PSine(Fh))
        # holds the AR loop's LSTM weights under the reference names; the
        # loop itself is kernels.ar_decode or the teacher-forced step loop
        self.decoder_rnn = nn.LSTM(Fh, Fh, num_layers=2)
        self.fc_out = LinearNorm(Fh, cfg.n_mels)
        self.stop_token_layer = LinearNorm(2 * Fh, 1)
        self.postnet = Postnet(cfg)
        self._bias_sums: dict[int, tuple] = {}  # _lstm_bias's cache

    def ar_params(self) -> dict:
        """The AR loop's parameters in the JAX layout (``Decoder._ar_params``):
        dense kernels (in, out), LSTM wx (in, 4F), wh (F, 4F), one bias."""

        def dense(m):
            lin = m.linear_layer if isinstance(m, LinearNorm) else m
            return {"kernel": lin.weight.t(), "bias": lin.bias}

        rnn = self.decoder_rnn

        def lstm(layer):
            return {
                "wx": getattr(rnn, f"weight_ih_l{layer}").t(),
                "wh": getattr(rnn, f"weight_hh_l{layer}").t(),
                "b": self._lstm_bias(layer),
            }

        return {
            "prenet0": dense(self.prenet[0]), "prenet0_w": self.prenet[1].w,
            "prenet1": dense(self.prenet[3]), "prenet1_w": self.prenet[4].w,
            "Q": dense(self.Q[0]), "Q_w": self.Q[1].w,
            "attention_proj": dense(self.attention_proj),
            "content_Q": dense(self.content.Q[0]),
            "content_temp": self.content.temperature,
            "temperature": self.temperature,
            "lstm0": lstm(0), "lstm1": lstm(1),
            "fc_out": dense(self.fc_out), "stop": dense(self.stop_token_layer),
        }

    def _lstm_bias(self, layer: int) -> torch.Tensor:
        """bias_ih + bias_hh of the AR LSTM's layer, the same tensor until
        either bias is replaced or written in place, so the AR kernel's
        weight pack (keyed by tensor identity) stays cached across batches.
        Summed afresh whenever autograd would record the sum."""
        a = getattr(self.decoder_rnn, f"bias_ih_l{layer}")
        b = getattr(self.decoder_rnn, f"bias_hh_l{layer}")
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return a + b
        key = (a.data_ptr(), a._version, b.data_ptr(), b._version, a.dtype, a.device)
        hit = self._bias_sums.get(layer)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, a + b, (a, b))  # holding a, b keeps their addresses unique
            self._bias_sums[layer] = hit
        return hit[1]

    def encode(self, encoder_outputs, face_features, gumbel=None, generator=None) -> dict:
        """Everything before the AR loop (decoder.py:381-424)."""
        with trace.span("decoder.encode"):
            T = encoder_outputs.shape[1]
            w = self.residual_bottleneck.weight[:, :, 0]
            residual = F.linear(encoder_outputs, w, self.residual_bottleneck.bias)
            enc_site = self.encoder_site(face_features)
            att_site = self.attention_site(face_features)
            h0 = torch.stack([enc_site, enc_site]).contiguous()  # both directions; c0 = h0
            enc_out, (hidden, cell) = self.encoder_rnn(encoder_outputs, (h0, h0))
            encoder_cell = self.E_C(torch.cat([cell[0], cell[1]], dim=-1))
            enc_out = self.encoder_proj(enc_out) + att_site[:, None, :] + residual

            pos = torch.as_tensor(
                np.array(sinusoid_table(self.cfg.max_encoder_positions, self.cfg.ffn_hidden_dim)[:T]),
                dtype=enc_out.dtype, device=enc_out.device,
            )
            enc_t = enc_out.transpose(1, 2)
            k_bank = self.K[1](self.K[0](enc_t).transpose(1, 2)) + pos
            v_bank = self.V[1](self.V[0](enc_t).transpose(1, 2)) + pos
            content_key, content_value, content_dist = self.content(enc_t, gumbel, generator)
            return {
                "hidden": hidden, "encoder_cell": encoder_cell, "k": k_bank, "v": v_bank,
                "content_key": content_key, "content_value": content_value,
                "content_dist": content_dist,
            }

    def forward(self, encoder_outputs, face_features, gumbel=None, generator=None,
                mels=None, tf_ratio=1.0, draws: dict | None = None) -> dict:
        """Free-running when ``mels`` is None, else teacher-forced by
        ``mels (B, n_mels, M)``. ``draws`` holds random draws by name
        (``TeacherForcedDraws``); a draw it lacks comes from ``generator``.
        ``gumbel`` is the same as ``draws["gumbel"]``."""
        draws = dict(draws or {})
        if gumbel is not None:
            draws.setdefault("gumbel", gumbel)
        enc = self.encode(encoder_outputs, face_features, draws.get("gumbel"), generator)
        B = encoder_outputs.shape[0]
        if mels is None:
            out = self._free_running(enc, B, self.cfg.max_decoder_steps)
        elif not self.training and float(tf_ratio) >= 1.0:
            out = self._free_running(enc, B, mels.shape[-1])
        else:
            out = self._teacher_forced(enc, mels, tf_ratio, draws, generator)
        out["face_features"] = face_features
        out["content_dist"] = enc["content_dist"]
        fired = torch.sigmoid(out["gate"][..., 0].float()) > self.cfg.gate_threshold
        first = torch.argmax(fired.to(torch.int32), dim=1) + 1
        M = fired.shape[1]
        out["lengths"] = torch.where(fired.any(dim=1), first, torch.full_like(first, M))
        return out

    def _free_running(self, enc: dict, B: int, n_steps: int) -> dict:
        cfg = self.cfg
        bos = self.BOS.reshape(1, -1).expand(B, -1)
        weight_dtype = self.fc_out.linear_layer.weight.dtype
        with trace.span("decoder.ar_decode"):
            mels, stops, attn = ar_decode(cfg, self.ar_params(), enc, bos, n_steps,
                                          weight_dtype=weight_dtype)
        outputs = mels.permute(1, 2, 0)  # (B, n_mels, M) f32
        with trace.span("decoder.postnet"):
            post = self.postnet(outputs.to(weight_dtype)).float() + outputs
        return {"mel": outputs, "mel_postnet": post, "gate": stops.permute(1, 0, 2),
                "attention": attn.permute(1, 0, 2)}

    def _teacher_forced(self, enc: dict, mels: torch.Tensor, tf_ratio, draws: dict,
                        generator: torch.Generator | None) -> dict:
        """The scan of ``decoder.py:476-485`` as a step loop. Dense outputs
        come in the compute dtype from products that accumulate in f32; the
        LSTM cells (``layers.lstm_cell_step``), the attention scores, their
        dropout and softmax are f32; the carry (h, c, the fed-back frame) is
        in the compute dtype, as in the scan."""
        cfg = self.cfg
        k_bank, v_bank = enc["k"], enc["v"]
        dtype, dev = k_bank.dtype, k_bank.device
        B, T, Fh = k_bank.shape
        M = mels.shape[-1]
        train = self.training

        def draw(name, shape, rate):
            if not train or rate == 0.0:
                return None
            if name in draws:
                return draws[name].to(dev)
            return keep_mask(shape, rate, generator, dev, batch_dim=1)

        rand = draws.get("teacher")
        rand = uniform(M, generator, dev, batch_dim=None) if rand is None else rand.to(dev)
        use_teacher = teacher_schedule(rand, tf_ratio)
        prenet_keep = draw("prenet", (M, B, Fh // 2), cfg.prenet_dropout)
        attention_keep = draw("attention", (M, B, T), cfg.attention_dropout)
        rnn_keep = draw("rnn", (M, B, Fh), cfg.decoder_rnn_dropout)
        if train and cfg.postnet_dropout > 0.0:
            postnet_keep = draws.get("postnet")
            if postnet_keep is None:
                chans = [c[0].conv.out_channels for c in self.postnet.convolutions]
                postnet_keep = [keep_mask((B, c, M), cfg.postnet_dropout, generator, dev) for c in chans]
            postnet_keep = [m.to(dev) for m in postnet_keep]
        else:
            postnet_keep = None

        bos = self.BOS.reshape(1, -1).to(dtype)
        # teacher[i] is BOS at i = 0 and mel frame i - 1 after that
        teacher = torch.cat([bos[None].expand(B, 1, -1), mels.to(dtype).transpose(1, 2)[:, :M - 1]], 1)
        teacher = teacher.transpose(0, 1)  # (M, B, n_mels)
        pos = decode_positions(cfg, M, dev).to(dtype)
        rnn = self.decoder_rnn
        # (wx, wh, b) per layer, cast to f32 once: the cell's products are f32
        lstm = [tuple(at_least_f32(w) for w in (
                    getattr(rnn, f"weight_ih_l{i}").t(), getattr(rnn, f"weight_hh_l{i}").t(),
                    getattr(rnn, f"bias_ih_l{i}") + getattr(rnn, f"bias_hh_l{i}")))
                for i in range(2)]
        c_key_t = enc["content_key"].transpose(1, 2)
        k_bank_t = k_bank.transpose(1, 2)
        encoder_cell = enc["encoder_cell"]

        def cell(layer, x, h, c):
            return lstm_cell_step(*lstm[layer], x, h, c)

        h = enc["hidden"]  # (2, B, F): the BiLSTM finals
        c = torch.zeros_like(h)
        ys = bos.expand(B, -1)
        mel_frames, stops, attns = [], [], []
        with trace.span("decoder.teacher_forced"):
            for i in range(M):
                if cfg.scan_grad_clip > 0.0:
                    h = clip_grad_norm(h, cfg.scan_grad_clip, self.dp)
                    c = clip_grad_norm(c, cfg.scan_grad_clip, self.dp)
                    ys = clip_grad_norm(ys, cfg.scan_grad_clip, self.dp)
                ys_in = torch.where(use_teacher[i], teacher[i], ys)
                pre = self.prenet[1](self.prenet[0](ys_in))
                if prenet_keep is not None:
                    pre = dropout(pre, prenet_keep[i], cfg.prenet_dropout)
                pre = self.prenet[4](self.prenet[3](pre))
                q = self.Q(torch.cat([h[0], h[1]], -1)) + pos[i]
                scores = at_least_f32(torch.bmm((q * self.temperature)[:, None], k_bank_t)[:, 0])
                if attention_keep is not None:  # on the f32 scores: a dropped score is 0
                    scores = dropout(scores, attention_keep[i], cfg.attention_dropout)
                a = torch.softmax(scores, dim=-1).to(dtype)
                o = self.attention_proj(torch.bmm(a[:, None], v_bank)[:, 0])
                # content attention, queried by the cell states
                cq = self.content.Q(torch.cat([c[0], c[1]], -1))
                ca = torch.softmax(torch.bmm((cq * self.content.temperature)[:, None], c_key_t)[:, 0], dim=-1)
                content_o = torch.bmm(ca[:, None], enc["content_value"])[:, 0]
                h0, c0 = cell(0, torch.cat([content_o, pre + o], -1), h[0], c[0])
                h0_in = h0 if rnn_keep is None else dropout(h0, rnn_keep[i], cfg.decoder_rnn_dropout)
                h1, c1 = cell(1, h0_in, h[1], c[1])
                ys = self.fc_out(h1)
                stops.append(self.stop_token_layer(torch.cat([h1, encoder_cell], -1)))
                mel_frames.append(ys)
                attns.append(a)
                h, c = torch.stack([h0, h1]), torch.stack([c0, c1])

        outputs = torch.stack(mel_frames, -1)  # (B, n_mels, M)
        with trace.span("decoder.postnet"):
            post = self.postnet(outputs, postnet_keep) + outputs
        return {"mel": outputs, "mel_postnet": post, "gate": torch.stack(stops, 1),
                "attention": torch.stack(attns, 1)}
