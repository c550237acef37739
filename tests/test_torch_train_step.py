"""Three of the port's train steps against three JAX train steps.

The small model of tests/test_train_step.py:34-53 (F=128, ShuffleNet 0.5,
video 32x32, an external speaker embedding instead of the face net), f32,
B=2, T=8 frames, M=12 mel frames, tf_ratio 0.5, seeded weights through
``weights.from_flax``. Each step hands the port the draws the JAX step
makes from ``fold_in(rng, step)`` (``jax_draws``). The JAX step is the body
of ``train_step`` split into its two halves, each jitted: ``loss_and_grad``
(so its gradients can be compared), then ``guard_batch_stats`` (eager)
and ``tx.update`` and ``optax.apply_updates``. The
optimizer (``make_optimizer``) runs on each top-level subtree raveled into
one vector: every stage of its chain is elementwise or a global norm, so
this is the same function, and it compiles in seconds where the 300-leaf
tree takes minutes on a CPU.

Tolerances, with reasons:
- the first step's gradients within 3e-3 of the tensor's max plus 2e-5:
  the decoder's tolerance (tests/test_torch_train_decoder.py), wider for
  the content codebook's k=7 scale, which at T=8 gives one frame a clip,
  so its train-mode BatchNorm normalises B=2 values and its backward
  divides by their spread (1.9e-3 of the max measured), and a floor for
  the gradients that are 0 up to rounding. Later steps' gradients are not
  compared: the parameters differ by then (below), and at those points the
  encoder's f32 gradient differs from its own f64 gradient by up to 6% of
  the tensor's max (measured on the port), so no tighter check holds;
- losses rtol 1e-5 (atol 1e-6: the KLD is a small difference of logs) at
  the first step; 2e-3 (atol 1e-3) at later steps, whose parameters
  differ by up to 2 * lr a step (1e-3 of the total measured);
- parameters after three steps atol 2 * lr * steps = 6e-4: AMSGrad divides
  by the root of the second moment, so an entry whose gradient is near
  zero (where the two f32 gradients differ most, relatively) can move its
  parameter by up to lr a step on one side and not the other (3.3e-4
  measured). The LSTM's ``bias_hh`` stays 0: the port trains the folded
  bias in ``bias_ih``, as the JAX package trains its one bias;
- BatchNorm statistics after three steps within 5e-2 of the tensor's
  max: each step's batch statistics come from activations of parameters
  that differ as above (3.2e-2 measured, on a postnet mean);
- each parameter's change over the three steps, against JAX's change:
  where JAX moved an entry by more than lr / 2, the same sign on at least
  80% of those entries (89% measured at the worst, on a 24-channel
  BatchNorm scale of the encoder), and the whole change within 0.5 in L2
  norm relative to JAX's (0.38 measured at the worst, on the encoder's
  small BatchNorm tensors, whose gradients are the rounding-sensitive ones
  above; 0.19 at the worst in the decoder). An update that is not applied
  scores 0% and 1.0, one of the wrong sign 0% and 2.0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lip2speech_tpu import config as jconfig
from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
from lip2speech_tpu.train.train_step import TrainState as JTrainState
from lip2speech_tpu.train.train_step import guard_batch_stats as j_guard_batch_stats
from lip2speech_tpu.train.train_step import loss_and_grad as j_loss_and_grad
from lip2speech_tpu.train.train_step import make_optimizer as j_make_optimizer
from lip2speech_torch import config as tconfig
from lip2speech_torch import weights
from lip2speech_torch.models.lip2speech import Lip2Speech
from lip2speech_torch.models.shufflenet import WIDTH_CHANNELS
from lip2speech_torch.train.train_step import create_train_state, loss_and_grad, train_step
from torch_port_common import (FAST_COMPILE, content_slots, fill_tree, grads_by_torch_name,
                               jax_draws, jax_step_keys, rel_err, small_configs, to_plain)
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, M, HW = 2, 8, 12, 32
STEPS = 3
TF = 0.5
GRAD_TOL, GRAD_FLOOR = 3e-3, 2e-5
STATS_TOL = 5e-2
SIGN_AGREE, DELTA_TOL = 0.8, 0.5


def _batch():
    rng = np.random.RandomState(4)
    gate = np.zeros((B, M), np.float32)
    gate[:, -1] = 1.0
    return {
        "video": (rng.randn(B, T, HW, HW, 3) * 0.1).astype(np.float32),
        "speaker_embedding": (rng.randn(B, 256) * 0.1).astype(np.float32),
        "mel": (rng.randn(B, 80, M) - 5.0).astype(np.float32),
        "gate": gate,
        "mel_mask": np.ones((B, M), bool),
    }


@pytest.fixture(scope="module")
def runs():
    """Per step: (JAX losses, JAX grads + new stats by torch name, the
    port's grads by name (first step only), the port's metrics); then the
    JAX parameters and statistics after the steps, the port's state and
    config."""
    jc, tc = small_configs()
    jcfg = jconfig.Config(model=jc, train=jconfig.TrainConfig(bf16=False))
    tcfg = tconfig.Config(model=tc, train=tconfig.TrainConfig(bf16=False))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JLip2Speech(jc)
    rng = jax.random.PRNGKey(42)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jbatch["video"], None, jbatch["mel"], TF,
        jbatch["speaker_embedding"], jax_step_keys(rng, 0), train=False))
    variables = to_plain(fill_tree(shapes, 2))
    params, stats = variables["params"], variables["batch_stats"]
    leaf_shapes = {k: [np.shape(x) for x in jax.tree.leaves(v)] for k, v in params.items()}
    treedefs = {k: jax.tree.structure(v) for k, v in params.items()}

    def flat(tree):  # on the host: raveling 300 leaves inside jit compiles for long
        return {k: np.concatenate([np.ravel(x) for x in jax.tree.leaves(v)]) for k, v in tree.items()}

    def unflat(vecs):
        out = {}
        for k, vec in vecs.items():
            sizes = [int(np.prod(s)) for s in leaf_shapes[k]]
            parts = np.split(np.asarray(vec), np.cumsum(sizes)[:-1])
            out[k] = jax.tree.unflatten(treedefs[k],
                                        [x.reshape(s) for x, s in zip(parts, leaf_shapes[k])])
        return out

    tx = j_make_optimizer(jcfg, flat(params))
    opt_state = tx.init(flat(params))
    # at XLA's default optimisation level: compiled faster (FAST_COMPILE), its
    # rounding moves a few of the encoder's ReLU inputs across 0 (see the
    # gradient tolerance above)
    grad_fn = jax.jit(lambda s, b, r: j_loss_and_grad(s, b, jnp.float32(TF), r, jcfg, model))

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def update(g, o, p):
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o

    port = Lip2Speech(tc, face_net=False)
    start = weights.from_flax(variables, tc)
    port.load_state_dict(start, strict=True)
    pstate = create_train_state(tcfg, port)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    steps = []
    for i in range(STEPS):
        jl, js, jg = grad_fn(JTrainState(jnp.int32(i), params, stats, None), jbatch, rng)
        draws = jax_draws(jc, jax_step_keys(rng, i), B, T, content_slots(T), M,
                          WIDTH_CHANNELS[0.5][-1])
        pg = {}
        if i == 0:  # later steps' gradients are not compared (see the docstring)
            _, _, pg = loss_and_grad(pstate, pbatch, TF, tcfg, draws)
            pg = dict(zip(pstate.opt.names, pg))
        metrics = train_step(pstate, pbatch, TF, tcfg, draws)
        steps.append((jl, grads_by_torch_name(jg, js, tc), pg, metrics))
        stats = j_guard_batch_stats(jcfg, jg, js, stats)  # eager: jitted, it compiles for long
        new, opt_state = update(flat(jg), opt_state, flat(params))
        params = unflat(new)
    return steps, (params, stats), pstate, tc, start


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(runs, step):
    jl, _, _, metrics = runs[0][step]
    rtol, atol = (1e-5, 1e-6) if step == 0 else (2e-3, 1e-3)
    for name, x in jl.items():
        np.testing.assert_allclose(float(metrics[name]), float(x), rtol=rtol, atol=atol,
                                   err_msg=name)
    assert int(metrics["notfinite_count"]) == 0


def test_first_step_gradients_match_jax(runs):
    _, want, grads, metrics = runs[0][0]
    assert set(grads) == {k for k in want if "running_" not in k and ".bias_hh_" not in k}
    bad = {k: rel_err(g, want[k]) for k, g in grads.items()
           if float((g - want[k]).abs().max()) > GRAD_TOL * float(want[k].abs().max()) + GRAD_FLOOR}
    assert not bad, bad
    norm = np.sqrt(sum(float((want[k].double() ** 2).sum()) for k in grads))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=GRAD_TOL)


def test_parameters_and_batch_stats_after_three_steps(runs):
    _, (params, stats), pstate, tc, _ = runs
    want = weights.from_flax({"params": to_plain(params), "batch_stats": to_plain(stats)}, tc)
    got = pstate.model.state_dict()
    assert pstate.step == STEPS
    lr = 1e-4
    for k, w in want.items():
        g = got[k]
        if ".bias_hh_" in k:  # folded into bias_ih, as the JAX package trains it
            assert not g.any(), k
        elif "running_" in k:
            assert rel_err(g, w) <= STATS_TOL, (k, rel_err(g, w))
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2 * lr * STEPS, rtol=0, err_msg=k)


def test_parameter_changes_match_jax(runs):
    """The update itself, which the atol above cannot see (three AMSGrad
    steps move an entry by at most about 2 * lr * steps): each parameter's
    change over the three steps against JAX's change, on the tensors where
    JAX moved some entry by more than lr / 2 (every matrix that has a
    gradient; the rest are biases in front of a train-mode BatchNorm,
    whose gradient is 0 up to rounding). A no-op update or a sign flip fails both checks."""
    _, (params, stats), pstate, tc, start = runs
    want = weights.from_flax({"params": to_plain(params), "batch_stats": to_plain(stats)}, tc)
    got = pstate.model.state_dict()
    lr = 1e-4
    checked = set()
    for k, w in want.items():
        if "running_" in k or ".bias_hh_" in k:
            continue
        dj, dp = (w - start[k]).double(), (got[k] - start[k]).double()
        moved = dj.abs() > lr / 2
        if not moved.any():
            continue
        checked.add(k)
        agree = float((torch.sign(dp[moved]) == torch.sign(dj[moved])).double().mean())
        assert agree >= SIGN_AGREE, (k, agree)
        assert float((dp - dj).norm() / dj.norm()) <= DELTA_TOL, (k, float((dp - dj).norm() / dj.norm()))
    # at T=8 the content codebook has one slot, so its attention's K and Q get no gradient
    no_grad = ("decoder.content.K.", "decoder.content.Q.")
    assert {k for k, w in want.items() if w.ndim >= 2 and not k.startswith(no_grad)} <= checked


def test_face_net_gets_no_gradient_and_does_not_move():
    """Torch only: with faces, the face net runs in eval mode under no_grad;
    its parameters are not optimised and its parameters and buffers stay
    bit-identical through a step."""
    _, tc = small_configs()
    cfg = tconfig.Config(model=tc, train=tconfig.TrainConfig(bf16=False))
    model = Lip2Speech(tc)
    state = create_train_state(cfg, model)
    assert not any(n.startswith("vgg_face.") for n in state.opt.names)
    before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("vgg_face.")}
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items() if k != "speaker_embedding"}
    batch["faces"] = torch.rand(B, 2, 80, 80, 3, generator=g) * 2 - 1
    model.train()
    assert not model.vgg_face.training
    out = model(batch["video"], batch["faces"], mels=batch["mel"], tf_ratio=TF, generator=g)
    assert not out["speaker_embedding"].requires_grad and out["mel"].requires_grad
    metrics = train_step(state, batch, TF, cfg)
    assert np.isfinite(float(metrics["total"]))
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
