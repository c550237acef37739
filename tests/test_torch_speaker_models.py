"""The speaker-pretraining models, losses and optimizers of the port
against the JAX package, on the CPU (the training step and the CLIs are in
``tests/test_torch_speaker_train.py``).

- ``FaceDecoder`` (train mode with the JAX keep mask and eval mode, with its
  new BatchNorm statistics), ``SpeakerDecoder``, the four losses: within
  1e-5 relative L2 of JAX in f32 (``REL``);
- the 2x bilinear upsampling against ``jax.image.resize``: equal within
  1e-6 of the largest value, edges included (the same taps; ``RESIZE``);
- the three optimizers against ``make_speaker_optimizer`` over 3 updates,
  with a clipped face gradient and ``t`` clamped at 100: within 1e-6 of the
  largest parameter (``OPT``);
- the face net in train mode at B=4, 80x80 (every stride still leaves a
  pixel), on the dropout mask JAX drew (captured from its ``Dropout``),
  JAX in f64: the port's f32 embedding and new running statistics within
  1e-4 relative L2 (``FACE_REL``), its f64 ones within 1e-9 (``F64``); the
  f64 gradients of a fixed projection of the embedding by sign and L2, as
  ``PERF.md`` holds the critic's parameters: the same sign on ``SIGN`` of
  the entries larger than 1e-3 of the largest, the whole within ``F64``
  relative L2; the eval-mode output equal to the bit to the stock
  ``nn.BatchNorm`` net's. Not B=2: there the last stages' BatchNorms
  normalise 2 values a channel (a 1x1 map), and the port's own f32 forward
  is 3.8e-3 off its f64 forward (1.1e-5 at B=4), so no f32 run can agree
  with JAX's to 1e-4;
- ``weights.speaker_training_from_flax`` loads the JAX tree (the real face
  net, the decoder, ``t`` and the voice encoder) with ``strict=True``.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lip2speech_tpu.config import Config as JConfig
from lip2speech_tpu.models.face import FaceRecognizer as JFaceRecognizer
from lip2speech_tpu.speaker import losses as jlosses
from lip2speech_tpu.speaker import train_loop as jloop
from lip2speech_tpu.speaker.models import FaceDecoder as JFaceDecoder
from lip2speech_tpu.speaker.models import SpeakerDecoder as JSpeakerDecoder
from lip2speech_tpu.speaker.models import SpeakerEncoder as JSpeakerEncoder
from lip2speech_torch import weights
from lip2speech_torch.config import Config
from lip2speech_torch.models.face import FaceRecognizer
from lip2speech_torch.models.layers import BatchNorm2d
from lip2speech_torch.speaker import losses, train_loop
from lip2speech_torch.speaker.models import FaceDecoder, SpeakerDecoder, upsample2x
from torch_port_common import FAST_COMPILE, change_agreement, fill_tree, rel_l2, t, to_plain
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
RESIZE = 1e-6
OPT = 1e-6
FACE_REL = 1e-4
SIGN = 0.999
FACE_B = 4
F64 = 1e-9



def _decoder_tree(seed):
    m = JFaceDecoder()
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((2, 256)), train=False))
    return m, to_plain(fill_tree(shapes, seed))


def test_upsample2x_equals_jax_bilinear_resize():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 10, 14, 3), "bilinear"))
    got = upsample2x(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= RESIZE * np.abs(want).max()
    # the edges: the first output row/column is the first input's
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_face_decoder_matches_jax(train):
    m, v = _decoder_tree(1)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 256).astype(np.float32)
    key = jax.random.PRNGKey(7)
    if train:
        apply = jax.jit(lambda v, x: m.apply(v, x, train=True, dropout_key=key,
                                             mutable=["batch_stats"]),
                        compiler_options=FAST_COMPILE)
        want, upd = apply(v, x)
        keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.7, (3, 12800))))
    else:
        want = jax.jit(lambda v, x: m.apply(v, x, train=False), compiler_options=FAST_COMPILE)(v, x)
        keep = None
    port = FaceDecoder()
    port.load_state_dict(weights.named_from_flax(v["params"], v["batch_stats"],
                                                 weights.FACE_DECODER_RENAME), strict=True)
    port.train(train)
    got = port(t(x), keep)
    assert got.shape == (3, 160, 160, 3)
    assert rel_l2(got.detach(), want) <= REL
    if train:
        from lip2speech_torch.train.train_step import batch_norms

        stats = {}
        for name, mod in batch_norms(port).items():
            stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = mod.new_stats
        want_sd = weights.named_from_flax({}, to_plain(upd["batch_stats"]),
                                          weights.FACE_DECODER_RENAME)
        assert set(stats) == set(want_sd)
        for k, w in want_sd.items():
            assert rel_l2(stats[k], w) <= REL, k


def test_conv_block_groups():
    """3072 -> 256 is a grouped conv of 256 groups of 12, not a depthwise one."""
    dec = FaceDecoder()
    assert dec.blocks[0].dw.groups == 256 and dec.blocks[0].dw.weight.shape == (256, 12, 3, 3)
    assert [b.dw.groups for b in dec.blocks] == [256, 128, 64, 64]


def test_speaker_decoder_matches_jax():
    m = JSpeakerDecoder()
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((2, 256))))
    v = to_plain(fill_tree(shapes, 3))
    x = np.random.RandomState(4).randn(2, 256).astype(np.float32)
    want = jax.jit(m.apply, compiler_options=FAST_COMPILE)(v, x)
    port = SpeakerDecoder()
    port.load_state_dict(weights.speaker_from_flax(v["params"]), strict=True)
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (2, 201, 40)
    assert rel_l2(got, want) <= REL


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    speech, face = rng.randn(6, 256).astype(np.float32), rng.randn(6, 256).astype(np.float32)
    for temp in (3.0, 250.0):  # 250 is clamped at 100
        want = jlosses.contrastive_loss(speech, face, jnp.float32(temp))
        got = losses.contrastive_loss(t(speech), t(face), torch.tensor(temp))
        for k in ("l2_loss", "c_loss"):
            assert rel_l2(got[k], want[k]) <= REL, (k, temp)
    a, b = rng.randn(2, 8, 8, 3).astype(np.float32), rng.randn(2, 8, 8, 3).astype(np.float32)
    assert rel_l2(losses.reconstruction_loss(t(a), t(b))["rec_loss"],
                  jlosses.reconstruction_loss(a, b)["rec_loss"]) <= REL
    f, g = rng.randn(2, 4, 5).astype(np.float32), rng.randn(2, 4, 5).astype(np.float32)
    assert rel_l2(losses.gram_matrix(t(f)), jlosses.gram_matrix(f)) <= REL
    assert rel_l2(losses.style_loss(t(f), t(g)), jlosses.style_loss(f, g)) <= REL


class _Groups:
    """A stand-in holding three parameter groups, as ``SpeakerTraining``."""

    def __init__(self, tree):
        self.t = torch.nn.Parameter(torch.tensor(float(tree["t"])))
        self.params = {k: [torch.nn.Parameter(t(v)) for v in tree[k].values()]
                       for k in ("face", "decoder")}

    def group(self, name):
        return [self.t] if name == "t" else self.params[name]


def test_optimizers_match_optax():
    rng = np.random.RandomState(6)
    tree = {"face": {"a": rng.randn(4, 3), "b": rng.randn(5)},
            "decoder": {"c": rng.randn(3, 2), "d": rng.randn(2)}, "t": np.float32(99.9995)}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    tx = jloop.make_speaker_optimizer(steps_per_epoch=1)  # a 100-step cosine
    opt_state, params = tx.init(tree), tree
    port = _Groups(tree)
    popt = train_loop.SpeakerOptimizer(port, steps_per_epoch=1)
    for step in range(3):
        scale = 40.0 if step == 1 else 1.0  # step 1's face gradient is clipped
        grads = jax.tree.map(lambda x: np.asarray(rng.randn(*x.shape) * scale, np.float32), tree)
        grads["t"] = np.float32(-0.5)  # pushes t past 100
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params["t"] = jnp.clip(params["t"], max=100.0)
        norm = popt.step({k: [t(v) for v in grads[k].values()] for k in ("face", "decoder")}
                         | {"t": [torch.tensor(float(grads["t"]))]})
        assert abs(float(norm) - float(optax.global_norm(grads["face"]))) <= 1e-5 * float(norm)
        for k in ("face", "decoder"):
            for got, want in zip(port.params[k], params[k].values()):
                assert float((got.detach() - t(want)).abs().max()) <= OPT * float(np.abs(want).max())
        assert abs(float(port.t.detach()) - float(params["t"])) <= OPT * 100
    assert float(port.t.detach()) == 100.0


class _StockFace(FaceRecognizer):
    """The face net with torch's own BatchNorm modules, as before it trained."""

    def __init__(self):
        super().__init__()
        for mod in list(self.modules()):
            for name, child in list(mod.named_children()):
                if isinstance(child, BatchNorm2d):
                    setattr(mod, name, torch.nn.BatchNorm2d(child.num_features, eps=1e-3))
        self.resnet.last_bn = torch.nn.BatchNorm1d(512, eps=1e-3)


@pytest.fixture(scope="module")
def face_nets():
    """The JAX face net's tree at 80x80 and the port's net on it."""
    m = JFaceRecognizer()
    x = jnp.zeros((FACE_B, 80, 80, 3))
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x, train=False))
    v = to_plain(fill_tree(shapes, 8))
    port = FaceRecognizer()
    sd = weights.speaker_training_from_flax({"face": v["params"], "decoder": {}, "t": 1.0},
                                            {"face": v["batch_stats"], "decoder": {}})
    port.load_state_dict({k[5:]: w for k, w in sd.items() if k.startswith("face.")}, strict=True)
    return m, v, port


def test_face_net_eval_is_unchanged_to_the_bit(face_nets):
    _, _, port = face_nets
    stock = _StockFace()
    stock.load_state_dict(port.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 3, 80, 80).astype(np.float32))
    port.eval(), stock.eval()
    with torch.no_grad():
        assert torch.equal(port(x), stock(x))
        assert torch.equal(port.inference(x), stock.inference(x))


def test_face_net_train_mode_matches_jax(face_nets):
    """JAX runs in f64 (its train-mode gradients in f32 move with the ReLU
    kinks its convolutions put on the other side: 2.2e-2 relative L2 from
    the port's f32 gradients, against 1.5e-4 between the port's f32 and
    f64 ones). The port's f32 forward is held against it at ``FACE_REL``,
    its f64 forward and gradients at ``F64``."""
    m, v, port = face_nets
    rng = np.random.RandomState(10)
    x = rng.randn(FACE_B, 80, 80, 3)
    proj = rng.randn(FACE_B, 256)
    with jax.enable_x64(True):
        params, stats = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     (v["params"], v["batch_stats"]))

        @jax.jit  # f64 convolutions run ~13x slower at FAST_COMPILE
        def run(params, stats, x):
            def loss(params):
                out, upd = m.apply({"params": params, "batch_stats": stats}, x, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(11)},
                                   mutable=["batch_stats", "intermediates"],
                                   capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
                return jnp.sum(out * proj), (out, upd)

            (_, (out, upd)), grads = jax.value_and_grad(loss, has_aux=True)(params)
            return out, upd["batch_stats"], grads, jax.tree.leaves(upd["intermediates"])[0]

        want, want_stats, want_grads, drop = jax.tree.map(np.asarray, run(params, stats, x))
    keep = torch.from_numpy(drop != 0)
    assert keep.shape == (FACE_B, 1792) and 0.2 < float(keep.float().mean()) < 0.6
    want_sd = weights.speaker_training_from_flax(
        {"face": to_plain(want_grads), "decoder": {}, "t": 0.0},
        {"face": to_plain(want_stats), "decoder": {}})
    for dtype, tol in ((torch.float32, FACE_REL), (torch.float64, F64)):
        net = copy.deepcopy(port).to(dtype).train()
        got = net(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2), keep)
        (got * torch.from_numpy(proj).to(dtype)).sum().backward()
        assert rel_l2(got.detach(), want) <= tol, dtype
        mods, grads = dict(net.named_modules()), dict(net.named_parameters())
        for k, w in want_sd.items():
            name = k[len("face."):]
            if name.endswith(("running_mean", "running_var")):
                mod_name, leaf = name.rsplit(".", 1)
                assert rel_l2(mods[mod_name].new_stats[leaf == "running_var"], w) <= tol, name
        if dtype == torch.float64:
            names = [k[len("face."):] for k in want_sd if k[len("face."):] in grads]
            sign, delta = change_agreement(
                torch.cat([grads[n].grad.reshape(-1) for n in names]),
                torch.cat([want_sd["face." + n].reshape(-1) for n in names]))
            assert len(names) == len(grads) and sign >= SIGN and delta <= F64, (sign, delta)


def test_speaker_training_from_flax_loads_strict(face_nets):
    """The face net's tree is the one made at 80x80: its shapes do not
    depend on the input size."""
    _, fv, _ = face_nets
    dec, spk = JFaceDecoder(), JSpeakerEncoder(JConfig().model)
    shapes = jax.eval_shape(lambda: (
        dec.init(jax.random.PRNGKey(0), jnp.zeros((1, 256)), train=False),
        spk.init(jax.random.PRNGKey(0), jnp.zeros((1, 32000)))))
    dv, sv = to_plain(fill_tree(shapes, 14))
    sd = weights.speaker_training_from_flax(
        {"face": fv["params"], "decoder": dv["params"], "t": np.float32(2.5)},
        {"face": fv["batch_stats"], "decoder": dv["batch_stats"]}, sv["params"])
    model = train_loop.SpeakerTraining(Config())
    model.load_state_dict(sd, strict=True)
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(sd) and float(model.t.detach()) == 2.5
    w = fv["params"]["resnet"]["repeat_2_4"]["conv2d"]["kernel"]
    assert torch.equal(model.face.resnet.repeat_2[4].conv2d.weight, t(w.transpose(3, 2, 0, 1)))
    assert torch.equal(model.decoder.blocks[1].dw.weight,
                       t(dv["params"]["ConvBlock_1"]["dw"]["kernel"].transpose(3, 2, 0, 1)))
    assert torch.equal(model.decoder.up[3].bias, t(dv["params"]["Conv_3"]["bias"]))


