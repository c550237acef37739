"""Shared set-up of the PyTorch port's parity tests.

The JAX package's parameters are not initialised (a JAX init of the small
full model costs most of a minute on one CPU core): ``jax.eval_shape``
gives the tree's shapes, and seeded numpy values fill it. The same arrays
go to the JAX module and, through ``lip2speech_torch.weights.from_flax``,
to the port.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from lip2speech_tpu import config as jcfg
from lip2speech_torch import config as tcfg

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


def to_plain(tree) -> dict:
    """Nested mappings (flax FrozenDict included) -> plain dicts."""
    if hasattr(tree, "items"):
        return {k: to_plain(v) for k, v in tree.items()}
    return tree


def t(x) -> torch.Tensor:
    """numpy / JAX array -> f32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))

