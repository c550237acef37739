"""The AR-decode kernel's plain version against the Pallas TPU kernel.

``ar_decode_reference`` computes what ``lip2speech_torch/csrc/ar_decode.cu``
computes; here it is held against ``pallas_ar_decode`` in interpret mode
(f32 weights, 8 steps: interpret mode costs seconds per step on a CPU) on
the AR inputs the JAX ``Decoder`` hands the kernel. The CUDA kernel itself
runs only on a card: tests/test_torch_ar_decode_cuda.py holds it against
this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.models.decoder import Decoder as JDecoder
from lip2speech_tpu.ops.pallas_decoder import pallas_ar_decode
from lip2speech_torch.kernels import ar_decode as ar
from torch_port_common import fill_tree, small_configs, t, to_plain

PALLAS_STEPS = 8


@pytest.fixture(scope="module")
def ar_inputs():
    """(JAX config, port config, JAX p/enc/bos, the same as torch tensors)."""
    jc, tc = small_configs()
    B, T = 3, 11
    rng = np.random.RandomState(5)
    enc_in = (rng.randn(B, T, jc.encoder_embedding_dim) * 0.3).astype(np.float32)
    face = (rng.randn(B, jc.face_embedding_dim) * 0.3).astype(np.float32)
    model = JDecoder(jc)
    rngs = {"gumbel": jax.random.PRNGKey(7)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, enc_in, face, None, 1.0, rngs, train=False))
    v = to_plain(fill_tree(shapes, 5))
    out = model.apply(v, jnp.asarray(enc_in), jnp.asarray(face), None, 1.0, rngs, train=False,
                      return_ar_inputs=True)
    j = out["ar_inputs"]
    p_t = jax.tree_util.tree_map(t, to_plain(j["p"]))
    enc_t = {k: t(x) for k, x in j["enc"].items()}
    return jc, tc, j, p_t, enc_t, t(j["bos"])


def test_plain_version_matches_pallas_kernel_interpret(ar_inputs):
    jc, tc, j, p_t, enc_t, bos_t = ar_inputs
    want = pallas_ar_decode(jc, j["p"], j["enc"], j["bos"], n_steps=PALLAS_STEPS,
                            weight_dtype=jnp.float32, interpret=True)
    got = ar.ar_decode_reference(tc, p_t, enc_t, bos_t, PALLAS_STEPS, weight_dtype=torch.float32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        # f32 on both sides; only the summation order differs (as
        # tests/test_pallas_decoder.py holds the kernel to the scan)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=1e-3)


def test_cpu_tensors_take_the_plain_version(ar_inputs):
    _, tc, _, p_t, enc_t, bos_t = ar_inputs
    before = ar.launches
    got = ar.ar_decode(tc, p_t, enc_t, bos_t, 4, weight_dtype=torch.bfloat16)
    want = ar.ar_decode_reference(tc, p_t, enc_t, bos_t, 4, weight_dtype=torch.bfloat16)
    assert ar.launches == before  # no kernel launch on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_rounds_every_product_input(ar_inputs):
    """bf16 weights change the result only by the rounding of each product's
    inputs: a 4-step run stays within a few bf16 steps of the f32 run."""
    _, tc, _, p_t, enc_t, bos_t = ar_inputs
    f32 = ar.ar_decode_reference(tc, p_t, enc_t, bos_t, 4, weight_dtype=torch.float32)
    bf = ar.ar_decode_reference(tc, p_t, enc_t, bos_t, 4, weight_dtype=torch.bfloat16)
    diff = float((f32[0] - bf[0]).abs().max())
    assert 0.0 < diff < 0.1 * float(f32[0].abs().max())


def test_cuda_wrapper_rejects_cpu_tensors(ar_inputs):
    _, tc, _, p_t, enc_t, bos_t = ar_inputs
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ar.ar_decode_cuda(tc, p_t, enc_t, bos_t, 4)


@pytest.mark.parametrize("F", [128, 512])
def test_lstm_column_order_groups_the_four_gates_of_8_units(F):
    order = ar.lstm_column_order(F)
    assert sorted(order.tolist()) == list(range(4 * F))
    tiles = order.reshape(-1, 4, 8)  # (tile, gate, unit)
    gate = tiles // F
    unit = tiles % F
    assert torch.equal(gate, torch.arange(4)[None, :, None].expand_as(gate))
    assert torch.equal(unit, unit[:, :1, :].expand_as(unit))  # same units across gates
    assert torch.equal(unit[:, 0, :].reshape(-1), torch.arange(F))


def test_decode_positions_match_the_jax_table():
    from lip2speech_tpu.models.layers import positional_encoding

    _, tc = small_configs()
    got = ar.decode_positions(tc, 20, "cpu").numpy()
    want = np.asarray(positional_encoding(max(tc.max_decoder_steps, 20), tc.ffn_hidden_dim)[:20])
    np.testing.assert_array_equal(got, want)
