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
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
    order = ar.lstm_column_order(F, 8)
    assert sorted(order.tolist()) == list(range(4 * F))
    tiles = order.reshape(-1, 4, 8)  # (tile, gate, unit)
    gate = tiles // F
    unit = tiles % F
    assert torch.equal(gate, torch.arange(4)[None, :, None].expand_as(gate))
    assert torch.equal(unit, unit[:, :1, :].expand_as(unit))  # same units across gates
    assert torch.equal(unit[:, 0, :].reshape(-1), torch.arange(F))


@pytest.mark.parametrize("F", [128, 512])
def test_lstm_column_order_of_single_units_is_unit_major(F):
    """The kernel's order: column 4 u + g is gate g of hidden unit u."""
    order = ar.lstm_column_order(F, 1)
    u = torch.arange(F)[:, None]
    g = torch.arange(4)[None, :]
    assert torch.equal(order, (g * F + u).reshape(-1))


def test_decode_positions_match_the_jax_table():
    from lip2speech_tpu.models.layers import positional_encoding

    _, tc = small_configs()
    got = ar.decode_positions(tc, 20, "cpu").numpy()
    want = np.asarray(positional_encoding(max(tc.max_decoder_steps, 20), tc.ffn_hidden_dim)[:20])
    np.testing.assert_array_equal(got, want)


def random_ar_params(cfg, seed: int) -> dict:
    """AR parameters in the JAX layout (dense kernels (in, out), one LSTM
    bias), seeded numpy values."""
    rng = np.random.RandomState(seed)
    F, L, NM = cfg.ffn_hidden_dim, cfg.content_latent_dim, cfg.n_mels
    H = F // 2

    def a(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def dense(n_in, n_out):
        return {"kernel": a(n_in, n_out), "bias": a(n_out)}

    return {
        "prenet0": dense(NM, H), "prenet0_w": a(H), "prenet1": dense(H, H), "prenet1_w": a(H),
        "Q": dense(2 * F, F), "Q_w": a(F), "attention_proj": dense(F, H),
        "content_Q": dense(2 * F, L), "content_temp": a(1), "temperature": a(1),
        "lstm0": {"wx": a(F, 4 * F), "wh": a(F, 4 * F), "b": a(4 * F)},
        "lstm1": {"wx": a(F, 4 * F), "wh": a(F, 4 * F), "b": a(4 * F)},
        "fc_out": dense(F, NM), "stop": dense(2 * F, 1),
    }


def port_config(F: int):
    from lip2speech_torch.config import ModelConfig

    return ModelConfig(ffn_hidden_dim=F, content_latent_dim=F // 2)


@pytest.mark.parametrize("n_blocks", [7, 132])
@pytest.mark.parametrize("F", [128, 512])
def test_pack_owns_every_column_exactly_once(F, n_blocks):
    cfg = port_config(F)
    pack = ar.pack_ar_weights(cfg, random_ar_params(cfg, F), torch.bfloat16, n_blocks)
    table, meta = pack["table"], pack["meta"]
    assert tuple(table.shape) == (n_blocks, ar.TABLE_COLS)
    for m in range(len(ar.MATRICES)):
        ncols, width = int(meta[m, 4]), int(meta[m, 2])
        owned = torch.zeros(ncols // width, dtype=torch.int64)
        for b in range(n_blocks):
            u0, nu = int(table[b, 2 + 3 * m]), int(table[b, 3 + 3 * m])
            owned[u0:u0 + nu] += 1
        assert bool((owned == 1).all()), ar.MATRICES[m]
    if n_blocks == 132 and F == 512:
        # the resident slices fit a block's shared memory with room for staging
        assert pack["w_elems"] * 2 <= 96 * 1024


def unpack(cfg, pack: dict) -> dict[str, torch.Tensor]:
    """The JAX-layout weights back from a pack, read from its table and meta
    alone (an independent reading of the layout the kernel uses)."""
    F, NM = cfg.ffn_hidden_dim, cfg.n_mels
    w, table, meta, vec = pack["w"], pack["table"], pack["meta"], pack["vec"]
    mats = []
    for m in range(len(ar.MATRICES)):
        K, ldw, width, off, ncols = (int(x) for x in meta[m])
        W = torch.full((K, ncols), float("nan"), dtype=w.dtype)
        for b in range(table.shape[0]):
            u0, nu, at = (int(x) for x in table[b, 2 + 3 * m:5 + 3 * m])
            start = int(table[b, 0]) + at
            sl = w[start:start + nu * width * ldw].reshape(nu * width, ldw)
            assert bool((sl[:, K:] == 0).all())
            W[:, u0 * width:(u0 + nu) * width] = sl[:, :K].t()
        mats.append((W, vec[off:off + ncols], vec[off + ncols:off + 2 * ncols]))
    (qo, qo_b, qo_s), (cq, cq_b, _), (p0, p0_b, p0_s), (pp, pp_b, pp_s) = mats[:4]
    assert bool((qo[:F, F:] == 0).all()) and bool((p0[NM:] == 0).all())
    assert bool((pp[:F, 1::2] == 0).all()) and bool((pp[F:, 0::2] == 0).all())
    out = {
        "Q.kernel": qo[:, :F], "Q.bias": qo_b[:F], "Q_w": qo_s[:F],
        "fc_out.kernel": qo[F:, F:F + NM], "fc_out.bias": qo_b[F:F + NM],
        "stop.kernel": torch.cat([qo[F:, F + NM], vec[ar.VEC_HEAD:ar.VEC_HEAD + F].to(w.dtype)])[:, None],
        "stop.bias": vec[2:3], "content_Q.kernel": cq, "content_Q.bias": cq_b,
        "prenet0.kernel": p0[:NM], "prenet0.bias": p0_b, "prenet0_w": p0_s,
        "attention_proj.kernel": pp[:F, 0::2], "attention_proj.bias": pp_b[0::2],
        "prenet1.kernel": pp[F:, 1::2], "prenet1.bias": pp_b[1::2], "prenet1_w": pp_s[1::2],
        "temperature": vec[0:1], "content_temp": vec[1:2],
    }
    for name, (W, bias, _) in zip(("lstm0", "lstm1"), mats[4:]):
        # packed column 4 u + g is gate g of unit u; JAX's column is g F + u
        W = W.reshape(2 * F, F, 4).permute(0, 2, 1).reshape(2 * F, 4 * F)
        out[f"{name}.wx"], out[f"{name}.wh"] = W[:F], W[F:]
        out[f"{name}.b"] = bias.reshape(F, 4).t().reshape(-1)
    return out


@pytest.mark.parametrize("n_blocks", [7, 132])
@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_unpacking_returns_the_jax_layout_weights(ar_inputs, weight_dtype, n_blocks):
    _, tc, _, p_t, _, _ = ar_inputs
    got = unpack(tc, ar.pack_ar_weights(tc, p_t, weight_dtype, n_blocks))
    want = {**ar._weights(p_t), "temperature": p_t["temperature"], "content_temp": p_t["content_temp"]}
    assert set(got) == set(want)
    for name, x in want.items():
        x = x.reshape(got[name].shape)
        if name in ("temperature", "content_temp"):  # used as they are, not rounded
            expect = x.float()
        elif got[name].dtype == weight_dtype:  # matrices, stored in the weight type
            expect = x.to(weight_dtype)
        else:  # biases and scales: f32 values rounded to the weight type
            expect = x.to(weight_dtype).float()
        assert got[name].dtype == expect.dtype and torch.equal(got[name], expect), name


def test_packs_are_cached_until_a_weight_changes():
    cfg = port_config(128)
    p = random_ar_params(cfg, 3)
    before = ar.packs
    first = ar.packed_weights(cfg, p, torch.bfloat16, 7)
    assert ar.packed_weights(cfg, p, torch.bfloat16, 7) is first
    assert ar.packs == before + 1
    p["Q"]["kernel"][0, 0] += 1.0  # written in place: a new version
    edited = ar.packed_weights(cfg, p, torch.bfloat16, 7)
    assert ar.packs == before + 2 and not torch.equal(edited["w"], first["w"])
    p["fc_out"]["bias"] = p["fc_out"]["bias"] + 1.0  # replaced by a new tensor
    assert ar.packed_weights(cfg, p, torch.bfloat16, 7) is not edited
    assert ar.packs == before + 3


def test_decoder_keeps_its_lstm_bias_between_calls():
    from lip2speech_torch.models.decoder import Decoder

    _, tc = small_configs()
    dec = Decoder(tc)
    with torch.no_grad():
        b = dec.ar_params()["lstm0"]["b"]
        assert dec.ar_params()["lstm0"]["b"] is b
        dec.decoder_rnn.bias_ih_l0.add_(1.0)
        b2 = dec.ar_params()["lstm0"]["b"]
    assert b2 is not b
    assert torch.equal(b2, dec.decoder_rnn.bias_ih_l0 + dec.decoder_rnn.bias_hh_l0)
