"""Autoregressive mel decoder, inference forward (PyTorch).

Counterpart of ``lip2speech_tpu/models/decoder.py`` with the reference
module names: the face-conditioned BiLSTM encoder, the K/V multi-kernel
conv banks, the gumbel content codebook, the free-running AR loop and the
postnet. The AR loop is ``kernels.ar_decode``: the CUDA kernel on the GPU,
its plain step loop on the CPU. Inference only: eval-mode BatchNorm, no
dropout, no teacher forcing (the teacher-forced training forward belongs
to the training port).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.kernels.ar_decode import ar_decode
from lip2speech_torch.models.layers import ConvNorm, LinearNorm, PSine, sinusoid_table


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


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """-log(-log(U)) in f32."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class MultiHopConv(nn.Module):
    """Conv bank k=1,3,7,11 (each + BN + SiLU) and a 1x1 bottleneck over
    the concatenation with the input; (B, C, T) -> (B, features, T)."""

    KERNELS = (1, 3, 7, 11)

    def __init__(self, channels: int, features: int):
        super().__init__()
        self.conv = nn.ModuleList(
            nn.Sequential(nn.Conv1d(channels, channels, k, padding=k // 2), nn.BatchNorm1d(channels))
            for k in self.KERNELS
        )
        self.bottleneck = nn.Conv1d(channels * (len(self.KERNELS) + 1), features, 1)

    def forward(self, x):
        return self.bottleneck(torch.cat([x] + [F.silu(m(x)) for m in self.conv], dim=1))


class ContentEncoder(nn.Module):
    """Multi-scale aggregation + gumbel codebook (decoder.py:152-222).
    Also holds the AR loop's content query ``Q`` and ``temperature``."""

    KERNELS = (1, 3, 5, 7)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = cfg.ffn_hidden_dim
        vocab, latent = cfg.content_vocab_size, cfg.content_latent_dim
        self.tau = cfg.gumbel_tau
        self.word_embeddings = nn.Parameter(torch.rand(vocab, latent))
        self.agg = nn.ModuleList(
            nn.Sequential(nn.Conv1d(c, c, k, stride=k), nn.BatchNorm1d(c)) for k in self.KERNELS
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
        codebook draw; drawn from ``generator`` when not given."""
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
        if gumbel is None:
            gumbel = gumbel_noise(flat.shape, generator, flat.device)
        z = torch.softmax((flat + gumbel.to(flat.dtype)) / self.tau, dim=-1)
        value = (z @ self.word_embeddings).reshape(w.shape[0], min_t, -1)
        return key, value, torch.softmax(flat, dim=-1)


class Postnet(nn.Module):
    """5-conv residual mel refiner with PSine activations, eval mode;
    (B, n_mels, M) -> (B, n_mels, M)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n, k, emb = cfg.postnet_n_convolutions, cfg.postnet_kernel_size, cfg.postnet_embedding_dim
        chans = [cfg.n_mels] + [emb] * (n - 1) + [cfg.n_mels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(ConvNorm(chans[j], chans[j + 1], k), nn.BatchNorm1d(chans[j + 1]))
            for j in range(n)
        )
        self.sin_activation = nn.ModuleList(PSine(emb) for _ in range(n - 1))

    def forward(self, x):
        for i, act in enumerate(self.sin_activation):
            h = act(self.convolutions[i](x), channel_dim=1)
            x = h + x if i != 0 else h
        return self.convolutions[-1](x)


class Decoder(nn.Module):
    """Free-running decoder: encoder features (B, T, E) + face embedding
    (B, 256) -> mels, gate logits, attention, lengths."""

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
        # loop itself is kernels.ar_decode
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

    def forward(self, encoder_outputs, face_features, gumbel=None, generator=None) -> dict:
        cfg = self.cfg
        M = cfg.max_decoder_steps
        B = encoder_outputs.shape[0]
        enc = self.encode(encoder_outputs, face_features, gumbel, generator)
        bos = self.BOS.reshape(1, -1).expand(B, -1)
        weight_dtype = self.fc_out.linear_layer.weight.dtype
        mels, stops, attn = ar_decode(cfg, self.ar_params(), enc, bos, M, weight_dtype=weight_dtype)

        outputs = mels.permute(1, 2, 0)  # (B, n_mels, M) f32
        gate = stops.permute(1, 0, 2)    # (B, M, 1)
        post = self.postnet(outputs.to(weight_dtype)).float() + outputs
        fired = torch.sigmoid(gate[..., 0]) > cfg.gate_threshold
        first = torch.argmax(fired.to(torch.int32), dim=1) + 1
        lengths = torch.where(fired.any(dim=1), first, torch.full_like(first, M))
        return {
            "mel": outputs, "mel_postnet": post, "gate": gate,
            "attention": attn.permute(1, 0, 2), "content_dist": enc["content_dist"],
            "face_features": face_features, "lengths": lengths,
        }
