"""Shared set-up of the PyTorch port's parity tests.

The JAX package's parameters are not initialised (a JAX init of the small
full model costs most of a minute on one CPU core): ``jax.eval_shape``
gives the tree's shapes, and seeded numpy values fill it. The same arrays
go to the JAX module and, through ``lip2speech_torch.weights.from_flax``,
to the port.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu import config as jcfg
from lip2speech_torch import config as tcfg

# for jax.jit: XLA's backend (LLVM) optimisation level 0. A test's JAX graph
# then compiles in about half the time on a CPU (its draws in a quarter),
# and computes the same function: the draws come out bit-identical.
FAST_COMPILE = {"xla_backend_optimization_level": 0}

# the small decoder of tests/test_pallas_decoder.py, with the 0.5x trunk
SMALL = dict(
    ffn_hidden_dim=128,
    content_vocab_size=33,
    content_latent_dim=64,
    max_decoder_steps=16,
    postnet_embedding_dim=64,
    shufflenet_width=0.5,
)


def small_configs(**overrides):
    """(JAX ModelConfig, port ModelConfig) with the same fields."""
    kw = dict(SMALL, **overrides)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _leaf_value(path: tuple[str, ...], shape, rng: np.random.RandomState) -> np.ndarray:
    name = path[-1]
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name in ("mean", "bias") or name.endswith("_bias"):
        return 0.1 * rng.randn(*shape)
    if name in ("scale", "w", "alpha", "temperature", "content_temperature") or name.endswith("psine_w"):
        return rng.uniform(0.5, 1.5, shape)
    if name == "word_embeddings":
        return rng.uniform(0.0, 1.0, shape)
    if name == "BOS":
        return rng.randn(*shape)
    if name.endswith("_b") or name == "b":  # LSTM bias
        return 0.1 * rng.randn(*shape)
    # kernels: (..., in, out) for dense, conv and LSTM matrices
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return rng.randn(*shape) / np.sqrt(fan_in)


def fill_tree(shapes, seed: int) -> dict:
    """Seeded numpy values (f32) for a tree of ``jax.ShapeDtypeStruct``."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        leaves.append(_leaf_value(keys, tuple(leaf.shape), rng).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def lip2speech_variables(jc, face_net: bool = True, seed: int = 0) -> dict:
    """Seeded variables of the JAX ``Lip2Speech(jc)`` (with the face net, or
    initialised on a ``speaker_embedding``), as plain dicts."""
    from lip2speech_tpu.models.lip2speech import Lip2Speech

    model = Lip2Speech(jc)
    B, T = 2, 14
    video = jnp.zeros((B, T, 48, 48, 3))
    faces = jnp.zeros((B, 2, 80, 80, 3)) if face_net else None
    spk = None if face_net else jnp.zeros((B, jc.face_embedding_dim))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, video, faces, None, 1.0, spk,
        {"gumbel": jax.random.PRNGKey(1)}, train=False))
    return to_plain(fill_tree(shapes, seed))


def to_plain(tree) -> dict:
    """Nested mappings (flax FrozenDict included) -> plain dicts."""
    if hasattr(tree, "items"):
        return {k: to_plain(v) for k, v in tree.items()}
    return tree


def t(x) -> torch.Tensor:
    """numpy / JAX array -> f32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


STEP_KEY_NAMES = ["gumbel", "teacher", "dropout", "postnet_dropout", "encoder_dropout"]
# the adversarial step splits its key seven ways (adversarial.py:170-173)
ADV_STEP_KEY_NAMES = STEP_KEY_NAMES + ["patch_g", "patch_d"]


def jax_step_keys(rng, step: int, names=STEP_KEY_NAMES) -> dict:
    """The per-step keys of the JAX train step (train_step.py:209-211), or,
    with ``ADV_STEP_KEY_NAMES``, of the adversarial step: the step's key
    split ``len(names)`` ways."""
    return dict(zip(names, jax.random.split(jax.random.fold_in(rng, step), len(names))))


def content_slots(T: int) -> int:
    """Slots of the content codebook for T frames: the shortest of the
    strided aggregation scales (a scale longer than T gives one frame)."""
    return min(T // k if T >= k else 1 for k in (1, 3, 5, 7))


def jax_draws(jc, rngs: dict, B: int, T: int, S: int, M: int, video_dim: int | None = None) -> dict:
    """The random draws the JAX forward makes from ``rngs``, as the port's
    ``draws`` (torch tensors; keep masks are bool):

    - gumbel (B*S, vocab): ContentEncoder (decoder.py:218);
    - teacher (M,): uniform (decoder.py:469);
    - prenet (M,B,F/2), attention (M,B,T), rnn (M,B,F): the scan splits the
      dropout key into M step keys, each into three (decoder.py:256, 474);
    - postnet: one (B, C, M) mask per conv, from fold_in(key, i) on the
      channels-last (B, M, C) shape (decoder.py:116-123);
    - encoder (B,T,C_video): the encoder-feature mask (lip2speech.py:61).
    """
    rates = (jc.prenet_dropout, jc.attention_dropout, jc.decoder_rnn_dropout,
             jc.postnet_dropout, jc.encoder_feature_dropout)
    chans = (jc.postnet_embedding_dim,) * (jc.postnet_n_convolutions - 1) + (jc.n_mels,)
    out = _jax_draw_arrays(jc.ffn_hidden_dim, jc.content_vocab_size, rates, chans, rngs,
                           B, T, S, M, video_dim)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in out.items() if k != "postnet"}
    if "postnet" in out:
        draws["postnet"] = [torch.from_numpy(np.array(m).transpose(0, 2, 1).copy())
                            for m in out["postnet"]]
    return draws


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 5, 6, 7, 8, 9),
                   compiler_options=FAST_COMPILE)
def _jax_draw_arrays(F, vocab, rates, chans, rngs, B, T, S, M, video_dim):
    p_prenet, p_attention, p_rnn, p_postnet, p_encoder = rates
    out = {
        "gumbel": jax.random.gumbel(rngs["gumbel"], (B * S, vocab), np.float32),
        "teacher": jax.random.uniform(rngs["teacher"], (M,)),
    }

    def step(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.bernoulli(k1, 1.0 - p_prenet, (B, F // 2)),
                jax.random.bernoulli(k2, 1.0 - p_attention, (B, T)),
                jax.random.bernoulli(k3, 1.0 - p_rnn, (B, F)))

    if "dropout" in rngs:
        masks = jax.vmap(step)(jax.random.split(rngs["dropout"], M))
        out.update(zip(("prenet", "attention", "rnn"), masks))
    if "postnet_dropout" in rngs:
        out["postnet"] = [jax.random.bernoulli(jax.random.fold_in(rngs["postnet_dropout"], i),
                                               1.0 - p_postnet, (B, M, c))
                          for i, c in enumerate(chans)]
    if "encoder_dropout" in rngs and video_dim is not None:
        out["encoder"] = jax.random.bernoulli(rngs["encoder_dropout"], 1.0 - p_encoder,
                                              (B, T, video_dim))
    return out


def grads_by_torch_name(grads: dict, new_stats: dict, tc) -> dict:
    """JAX gradients (a params tree) and new batch statistics -> one dict
    under the port's names, through ``weights.from_flax``. The folded LSTM
    bias's gradient belongs to both ``bias_ih`` and ``bias_hh``."""
    from lip2speech_torch import weights

    sd = weights.from_flax({"params": to_plain(grads), "batch_stats": to_plain(new_stats)}, tc)
    for k in list(sd):
        if ".bias_hh_" in k:
            sd[k] = sd[k.replace(".bias_hh_", ".bias_ih_")]
    return sd


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (1 where want is all zeros)."""
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def rel_l2(got: torch.Tensor, want) -> float:
    """Relative L2 distance of ``got`` from ``want`` (an array or tensor),
    in float64."""
    want = torch.from_numpy(np.array(want, dtype=np.float64))  # a copy: JAX arrays are read-only
    return float((got.double() - want).norm() / (want.norm() or 1.0))


def change_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(share of ``want``'s entries larger than 1e-3 of its largest whose
    sign ``got`` shares, relative L2 of the difference) of two parameter
    changes or gradients."""
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    big = want.abs() > 1e-3 * float(want.abs().max())
    sign = float((torch.sign(got[big]) == torch.sign(want[big])).double().mean()) if big.any() else 1.0
    return sign, float((got - want).norm() / (want.norm() or 1.0))


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests: test processes run side by
    side, and small ops spread over every core's thread are many times
    slower when the cores are shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
