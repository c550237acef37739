"""The port's teacher-forced decoder, in train mode, against the JAX ``Decoder``.

Both sides get the same seeded weights (through ``weights.from_flax``), the
same encoder features, mel targets and the same random draws (the port is
handed what the JAX forward draws from its keys, ``jax_draws``), and run in
f32. The JAX side is ``jax.value_and_grad`` of ``lip2speech_loss`` over the
decoder's parameters, jitted; the port's side is autograd through its step
loop. Compared: the outputs, the loss dict, every gradient (as max error
over the tensor's max) and the new BatchNorm statistics.

B=2, M=12 steps, T=14 frames (14 rather than 8 so that the content codebook
has two slots and its attention a gradient), tf_ratio 0.5 and 1.0, and one
case where ``scan_grad_clip`` and ``content_grad_clip`` are small enough to
bite (shown by its gradients differing from the unclipped case's).

Tolerances: outputs atol 2e-4 / rtol 1e-3 as tests/test_torch_decoder.py
(f32, only the summation order differs, carried through 12 steps); losses
rtol 1e-5; gradients within 1e-3 of the tensor's max plus 3e-5 (the
backward through 12 recurrent steps and train-mode BatchNorm reorders more
f32 sums than the forward; the largest error measured was ~2e-4 of the
max. The 3e-5 floor is for the conv biases in front of a train-mode
BatchNorm: their exact gradient is 0, so both sides hold rounding residue,
up to 2e-5 here, against gradients of up to ~5); new statistics atol 1e-5 / rtol 1e-5 (a mean over
the batch of BatchNorm inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu.models.decoder import Decoder as JDecoder
from lip2speech_tpu.train.losses import lip2speech_loss as j_loss
from lip2speech_torch import weights
from lip2speech_torch.models.decoder import Decoder
from lip2speech_torch.train.losses import lip2speech_loss
from lip2speech_torch.train.train_step import batch_norms
from torch_port_common import (FAST_COMPILE, fill_tree, grads_by_torch_name, jax_draws,
                               rel_err, small_configs, t, to_plain)
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, M = 2, 14, 12
OUT_TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_TOL, GRAD_FLOOR = 1e-3, 3e-5
CLIPS = dict(scan_grad_clip=0.02, content_grad_clip=0.002)
CASES = {"tf0.5": 0.5, "tf1.0": 1.0, "clipped": 0.5}


def _jax_fn(jc):
    model = JDecoder(jc)

    def run(params, stats, enc_in, face, mels, gate, tf_ratio, rngs):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, enc_in, face, mels,
                                   tf_ratio, rngs, train=True, mutable=["batch_stats"])
            losses = j_loss(out, mels, gate)
            return losses["total"], (losses, out, upd["batch_stats"])

        (_, (losses, out, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return losses, out, grads, new_stats

    return model, run


@pytest.fixture(scope="module")
def runs():
    """Per case: (JAX losses, outputs, grads by torch name; port losses,
    outputs, grads, new stats by torch name)."""
    rng = np.random.RandomState(0)
    enc_in = (rng.randn(B, T, 1024) * 0.3).astype(np.float32)
    face = (rng.randn(B, 256) * 0.3).astype(np.float32)
    mels = (rng.randn(B, 80, M) - 4.0).astype(np.float32)
    gate = np.zeros((B, M), np.float32)
    gate[0, 7:], gate[1, -1] = 1.0, 1.0
    rngs = dict(zip(["gumbel", "teacher", "dropout", "postnet_dropout"],
                    jax.random.split(jax.random.PRNGKey(3), 4)))
    jc0, _ = small_configs()
    model0, _ = _jax_fn(jc0)
    shapes = jax.eval_shape(lambda: model0.init(
        {"params": jax.random.PRNGKey(0)}, enc_in, face, mels, 0.5, rngs, train=False))
    v = to_plain(fill_tree(shapes, 1))
    fns = {}
    result = {}
    for case, tf in CASES.items():
        extra = CLIPS if case == "clipped" else {}
        jc, tc = small_configs(**extra)
        args = (v["params"], v["batch_stats"], enc_in, face, mels, gate, jnp.float32(tf), rngs)
        if bool(extra) not in fns:
            fns[bool(extra)] = jax.jit(_jax_fn(jc)[1], compiler_options=FAST_COMPILE)
        jl, jo, jg, js = fns[bool(extra)](*args)
        S = jo["content_dist"].shape[0] // B
        want_g = grads_by_torch_name({"decoder": jg}, {"decoder": js}, tc)

        dec = Decoder(tc)
        sd = weights.from_flax({"params": {"decoder": v["params"]},
                                "batch_stats": {"decoder": v["batch_stats"]}}, tc)
        dec.load_state_dict({k[len("decoder."):]: x for k, x in sd.items()}, strict=True)
        dec.train()
        out = dec(t(enc_in), t(face), mels=t(mels), tf_ratio=tf,
                  draws=jax_draws(jc, rngs, B, T, S, M))
        losses = lip2speech_loss(out, t(mels), t(gate))
        named = dict(dec.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(losses["total"], list(named.values()),
                                                   allow_unused=True)))
        stats = {}
        for name, m in batch_norms(dec).items():
            stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = m.new_stats
        result[case] = (jl, jo, {k[len("decoder."):]: x for k, x in want_g.items()},
                        losses, out, grads, stats)
    return result


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_and_losses_match_jax(runs, case):
    jl, jo, _, losses, out, _, _ = runs[case]
    for name in ("mel", "mel_postnet", "gate", "attention", "content_dist"):
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(jo[name]), **OUT_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(jo["lengths"]))
    assert set(losses) == set(jl)
    for name, x in jl.items():
        np.testing.assert_allclose(float(losses[name].detach()), float(x), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad(runs, case):
    _, _, want, _, _, grads, _ = runs[case]
    params = {k for k in want if "running_" not in k}
    assert params == set(grads)
    bad = {k: rel_err(grads[k], want[k]) for k in params
           if float((grads[k] - want[k]).abs().max())
           > GRAD_TOL * float(want[k].abs().max()) + GRAD_FLOOR}
    assert not bad, bad


@pytest.mark.parametrize("case", list(CASES))
def test_new_batch_stats_match_flax(runs, case):
    _, _, want, _, _, _, stats = runs[case]
    assert set(stats) == {k for k in want if "running_" in k}
    for k, x in stats.items():
        np.testing.assert_allclose(x.numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_the_clips_bite(runs):
    """The clipped case's gradients differ from the unclipped ones on the
    same weights and draws (so the parity above covers the clips)."""
    g0, g1 = runs["tf0.5"][5], runs["clipped"][5]
    assert rel_err(g1["decoder_rnn.weight_hh_l0"], g0["decoder_rnn.weight_hh_l0"]) > 0.1
    assert rel_err(g1["content.location_fc.4.weight"], g0["content.location_fc.4.weight"]) > 0.1
