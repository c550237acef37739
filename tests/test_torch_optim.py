"""The port's optimizer against the JAX package's optax chain.

``lip2speech_torch.train.optim.AMSGrad`` against ``make_optimizer``
(``lip2speech_tpu/train/train_step.py:148-176``) on a random tree with an
encoder, a decoder and a frozen ``vgg_face`` subtree, over five steps: two
ordinary steps, one with a NaN gradient (skipped), one whose norm is above
``reject_grad_norm_above`` (skipped), and one after them. Parameters and the
AMSGrad moments are compared after every step: the parameters at 1e-7
(f32 values near 1: one unit in the last place, as the bias corrections'
powers and the global norm's summation order may differ by one rounding),
the moments within 1e-6 of their largest entry (the clipped gradient
carries the norm's rounding into every entry, and an entry of a moment
near 0 keeps it as a larger relative error), the skip counters exactly. A last test shows that ``torch.optim.AdamW(amsgrad=True)``, which
keeps the max of the raw second moments, is another optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lip2speech_tpu import config as jconfig
from lip2speech_tpu.train.train_step import make_optimizer as j_make_optimizer
from lip2speech_torch import config as tconfig
from lip2speech_torch.train.optim import AMSGrad
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = {"encoder": {"a": (3, 4), "b": (5,)}, "decoder": {"c": (2, 3, 3), "d": (7,)},
          "vgg_face": {"e": (4,)}}
LR = 1e-2
REJECT = 50.0


def _tree(fn):
    return {top: {k: fn(top, k, s) for k, s in leaves.items()} for top, leaves in SHAPES.items()}


def _grads(step: int, rng: np.random.RandomState):
    """Step 2 holds a NaN, step 3 has a norm above REJECT; the others are
    ordinary, with a shrinking scale so that AMSGrad's max matters."""
    scale = {0: 2.0, 1: 0.5, 2: 1.0, 3: 100.0, 4: 0.05}[step]
    g = _tree(lambda top, k, s: (rng.randn(*s) * scale).astype(np.float32))
    if step == 2:
        g["decoder"]["c"][1, 2, 0] = np.nan
    return g


def _amsgrad_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAmsgradState))
        if isinstance(s, optax.ScaleByAmsgradState)]
    assert len(found) == 1
    return found[0]


def _find(opt_state, field):
    if hasattr(opt_state, field):
        return getattr(opt_state, field)
    for s in opt_state if isinstance(opt_state, tuple) else ():
        got = _find(s, field)
        if got is not None:
            return got
    return None


@pytest.fixture(scope="module")
def trajectory():
    rng = np.random.RandomState(0)
    init = _tree(lambda top, k, s: rng.uniform(0.5, 1.5, s).astype(np.float32))
    jcfg = jconfig.Config(train=jconfig.TrainConfig(learning_rate=LR, weight_decay=1e-2,
                                                    reject_grad_norm_above=REJECT))
    tcfg = tconfig.TrainConfig(learning_rate=LR, weight_decay=1e-2, reject_grad_norm_above=REJECT)
    tx = j_make_optimizer(jcfg, init)
    opt_state = tx.init(init)
    params = init
    update = jax.jit(tx.update)
    named = [(f"{top}.{k}", torch.nn.Parameter(torch.from_numpy(v.copy())))
             for top, leaves in init.items() for k, v in leaves.items()]
    opt = AMSGrad(tcfg, named)
    out = []
    for step in range(5):
        g = _grads(step, rng)
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        info = opt.step([torch.from_numpy(g[n.split(".")[0]][n.split(".")[1]]) for n in opt.names])
        snap = {k: getattr(opt, k).clone() for k in ("mu", "nu", "nu_max", "count",
                                                     "notfinite_count", "total_notfinite")}
        out.append((jax.tree.map(np.asarray, params), opt_state,
                    {n: p.detach().clone() for n, p in named}, snap, info))
    return init, out, opt.names


@pytest.mark.parametrize("step", range(5))
def test_parameters_and_moments_match_optax(trajectory, step):
    _, out, names = trajectory
    params, opt_state, got, snap, _ = out[step]
    for name, p in got.items():
        top, k = name.split(".")
        np.testing.assert_allclose(p.numpy(), params[top][k], rtol=0, atol=1e-7, err_msg=name)
    state = _amsgrad_state(opt_state)
    for field in ("mu", "nu", "nu_max"):
        want = np.concatenate([np.ravel(getattr(state, field)[n.split(".")[0]][n.split(".")[1]])
                               for n in names])
        np.testing.assert_allclose(snap[field].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=field)
    assert int(snap["count"]) == int(state.count)
    assert int(snap["notfinite_count"]) == int(_find(opt_state, "notfinite_count"))
    assert int(snap["total_notfinite"]) == int(_find(opt_state, "total_notfinite"))


def test_skips_and_the_frozen_subtree(trajectory):
    init, out, names = trajectory
    assert [bool(o[4]["ok"]) for o in out] == [True, True, False, False, True]
    assert [int(o[3]["count"]) for o in out] == [1, 2, 2, 2, 3]
    assert [int(o[3]["notfinite_count"]) for o in out] == [0, 0, 1, 2, 0]
    assert int(out[-1][3]["total_notfinite"]) == 2
    for a, b in ((1, 2), (1, 3)):  # the skipped steps move nothing
        for name in out[a][2]:
            assert torch.equal(out[a][2][name], out[b][2][name]), name
        for field in ("mu", "nu", "nu_max"):
            assert torch.equal(out[a][3][field], out[b][3][field]), field
    assert torch.equal(out[-1][2]["vgg_face.e"], torch.from_numpy(init["vgg_face"]["e"]))
    assert "vgg_face.e" not in names


def test_stock_adamw_amsgrad_is_another_optimizer():
    """On gradients that shrink, AdamW(amsgrad=True) (max of the raw second
    moments) and optax's scale_by_amsgrad (max of the bias-corrected ones)
    part; the port follows optax."""
    rng = np.random.RandomState(1)
    init = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    grads = [(rng.randn(64) * s).astype(np.float32) for s in (3.0, 1.0, 0.3, 0.1, 0.03)]
    tx = optax.chain(optax.scale_by_amsgrad(), optax.scale(-LR))
    state, want = tx.init(jnp.asarray(init)), jnp.asarray(init)
    tcfg = tconfig.TrainConfig(learning_rate=LR, weight_decay=0.0, grad_clip=1e9)
    ours = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = AMSGrad(tcfg, [("decoder.w", ours)])
    stock = torch.nn.Parameter(torch.from_numpy(init.copy()))
    adamw = torch.optim.AdamW([stock], lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                              amsgrad=True)
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state)
        want = optax.apply_updates(want, u)
        opt.step([torch.from_numpy(g)])
        stock.grad = torch.from_numpy(g)
        adamw.step()
    ours_err = float(np.abs(ours.detach().numpy() - np.asarray(want)).max())
    stock_err = float(np.abs(stock.detach().numpy() - np.asarray(want)).max())
    assert ours_err <= 1e-7
    assert stock_err > 1e-3, stock_err
