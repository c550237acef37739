"""The port's public surface against the JAX package's.

- The config dataclasses of both packages: every section's fields, defaults
  and types, ``Config.replace``, ``default_config`` and
  ``config_with_overrides`` (``mesh.*``, ``train.*`` and bad paths), also
  through the CLIs' ``--override``. The port's ``vocoder`` section (the mel
  -> waveform stage, ``tests/test_torch_vocoder.py``) has no JAX
  counterpart: the sections are compared without it.
- ``ops.image.resize_bilinear`` against the JAX package's (``jax.image.resize``
  with its antialiasing) within ``RESIZE_TOL`` on [0, 1] data, and an axis
  that keeps its size bit for bit.
- ``ops.stft``: ``stft`` with a window and ``center=False``, ``spectrogram``
  at powers 2, 1 and 0.5 and the complex ``istft`` against the JAX package's
  within ``STFT_REL`` of the largest value. The port's ``stft`` is a DFT
  matmul where JAX's is an ``rfft``; measured: stft <= 4.5e-07, istft <=
  2.4e-07, spectrogram <= 1.2e-06 of the largest value.
- ``models.get_network`` against the JAX package's (its strict load of
  ``weights.from_flax`` is in ``test_torch_weights.py``).
- A guard of the public surface: both packages parsed with ``ast`` (no
  import), one case per JAX module, every public top-level name and every
  package ``__init__`` export of the JAX package has a counterpart in the
  port, under its own name, under a renamed backend (``RENAMED_MODULES``,
  ``RENAMED``) or in ``JAX_ONLY`` with its reason.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lip2speech_tpu import config as jcfg
from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
from lip2speech_tpu.models.lip2speech import get_network as jax_get_network
from lip2speech_tpu.ops import image as jimage
from lip2speech_tpu.ops import stft as jstft
from lip2speech_torch import Config, default_config
from lip2speech_torch import config as tcfg
from lip2speech_torch.cli import common as cli_common
from lip2speech_torch.models import Lip2Speech, get_network
from lip2speech_torch.ops import image, stft
from torch_port_common import FAST_COMPILE, small_configs
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "lip2speech_tpu")
PORT_PKG = os.path.join(ROOT, "lip2speech_torch")

# absolute error on [0, 1] data (uint8 input: on its values / 255)
RESIZE_TOL = 1e-5
# largest error over the largest magnitude of the JAX result
STFT_REL = 1e-5
# istft(stft(x)) against x, unit-variance noise (measured 1.2e-06)
ROUND_TRIP_TOL = 1e-5

SECTIONS = ("audio", "model", "data", "train", "mesh")
PORT_ONLY_SECTIONS = ("vocoder",)


def shared(cfg) -> dict:
    """``dataclasses.asdict`` of a port Config without its port-only sections."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in PORT_ONLY_SECTIONS}


# -- config ------------------------------------------------------------------


def _default(f: dataclasses.Field):
    return f.default_factory() if f.default is dataclasses.MISSING else f.default


@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_fields_defaults_and_types(section):
    jcls = type(getattr(jcfg.Config(), section))
    tcls = type(getattr(tcfg.Config(), section))
    assert jcls.__name__ == tcls.__name__
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert typing.get_type_hints(tcls) == typing.get_type_hints(jcls)
    for a, b in zip(jf, tf):
        assert type(_default(b)) is type(_default(a)) and _default(b) == _default(a), b.name
    assert tcls.__dataclass_params__.frozen and jcls.__dataclass_params__.frozen


def test_config_sections_replace_and_default_config():
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == list(SECTIONS + PORT_ONLY_SECTIONS)
    assert [f.name for f in dataclasses.fields(jcfg.Config)] == list(SECTIONS)
    assert Config().vocoder.kind == "griffin_lim"
    assert default_config() == Config() and isinstance(default_config(), Config)
    mesh = tcfg.MeshConfig(model_parallel=2)
    got, want = Config().replace(mesh=mesh), jcfg.Config().replace(mesh=jcfg.MeshConfig(model_parallel=2))
    assert got.mesh == mesh and got.train == Config().train
    assert shared(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("overrides", [
    ("mesh.model_parallel=2",),
    ("mesh.data_parallel=4", "mesh.data_axis=batch", "mesh.model_axis='tp'"),
    ("train.learning_rate=3e-4", "train.bf16=False", "model.ffn_hidden_dim=256"),
    ("train.adversarial=True", "mesh.model_parallel=1", "data.max_video_frames=50"),
])
def test_config_with_overrides_as_jax(overrides):
    got = tcfg.config_with_overrides(*overrides)
    want = jcfg.config_with_overrides(*overrides)
    assert shared(got) == dataclasses.asdict(want)
    assert got != Config()


@pytest.mark.parametrize("bad", ["nope.x=1", "mesh=2", "mesh.nope=1", "train.not_a_field=3"])
def test_config_with_overrides_rejects_bad_paths_as_jax(bad):
    with pytest.raises(Exception) as want:
        jcfg.config_with_overrides(bad)
    with pytest.raises(want.type) as got:
        tcfg.config_with_overrides(bad)
    assert str(got.value) == str(want.value)


def test_cli_override_of_mesh():
    """The CLIs' common arguments and config (``cli/common.py``), which
    exited on ``--override mesh.*`` before the port had the section."""
    args = cli_common.add_common_args(argparse.ArgumentParser()).parse_args(
        ["--root", "unused", "--device", "cpu", "--override", "mesh.model_parallel=1",
         "--override", "mesh.data_parallel=2"])
    cfg = cli_common.common_config(args)
    assert (cfg.mesh.model_parallel, cfg.mesh.data_parallel) == (1, 2)
    want = jcfg.config_with_overrides("mesh.model_parallel=1", "mesh.data_parallel=2")
    assert shared(cfg) == dataclasses.asdict(want)


# -- resize_bilinear -----------------------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((2, 96, 96, 3), (40, 40)),     # down 96 -> 40
    ((2, 96, 96, 3), (88, 88)),     # down 96 -> 88
    ((2, 96, 96, 3), (160, 160)),   # up 96 -> 160
    ((2, 96, 96, 3), (96, 50)),     # one axis unchanged
    ((96, 96, 3), (40, 88)),        # no leading dims
    ((2, 3, 96, 96, 3), (88, 160)),  # two leading dims
], ids=["down40", "down88", "up160", "one_axis", "no_lead", "two_lead"])
def test_resize_bilinear_as_jax(shape, size):
    x = np.random.RandomState(sum(shape) + sum(size)).rand(*shape).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), *size))
    got = image.resize_bilinear(torch.from_numpy(x), *size)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= RESIZE_TOL


def test_resize_bilinear_uint8_as_jax():
    x = np.random.RandomState(3).randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), 40, 88))
    got = image.resize_bilinear(torch.from_numpy(x), 40, 88)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) / 255.0 <= RESIZE_TOL


def test_resize_bilinear_keeps_an_unchanged_axis_bit_for_bit():
    """JAX skips an axis that keeps its size; the port's filter there is the
    identity, so the result equals a resize of the other axis alone."""
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 96, 80, 3).astype(np.float32))
    assert torch.equal(image.resize_bilinear(x, 96, 80), x)
    rows = image.resize_bilinear(x.reshape(-1, 1, 80, 3), 1, 50).reshape(2, 96, 50, 3)
    assert torch.equal(image.resize_bilinear(x, 96, 50), rows)
    cols = image.resize_bilinear(x.transpose(1, 2).reshape(-1, 1, 96, 3), 1, 40)
    assert torch.equal(image.resize_bilinear(x, 40, 80), cols.reshape(2, 80, 40, 3).transpose(1, 2))
    # bf16 is resized in f32 and rounded back
    half = image.resize_bilinear(x.bfloat16(), 40, 80)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, image.resize_bilinear(x.bfloat16().float(), 40, 80).bfloat16())


# -- stft / spectrogram / istft --------------------------------------------------


def _signal(seed: int = 0, n: int = 4000) -> np.ndarray:
    return np.random.RandomState(seed).randn(2, n).astype(np.float32)


def _jit(fn, *static):
    """``fn`` of the JAX package, compiled once for its static arguments."""
    return jax.jit(fn, static_argnums=static, compiler_options=FAST_COMPILE)


# JAX's stft, spectrogram and istft; static: n_fft, hop, win_length, center
# (and power, length)
jax_stft = _jit(jstft.stft, 1, 2, 3, 5)
jax_spectrogram = _jit(jstft.spectrogram, 1, 2, 3, 4, 5)
jax_istft = _jit(jstft.istft, 1, 2, 3, 5, 6)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("center", [True, False])
def test_stft_with_window_as_jax(center):
    x = _signal(1)
    w = np.random.RandomState(2).uniform(0.2, 1.0, 400).astype(np.float32)
    want = jax_stft(x, 512, 100, 400, w, center)
    got = stft.stft(torch.from_numpy(x), 512, 100, 400, torch.from_numpy(w), center)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= STFT_REL


@pytest.mark.parametrize("power", [2.0, 1.0, 0.5])
def test_spectrogram_power_as_jax(power):
    x = _signal(3)
    want = jax_spectrogram(x, 400, 160, None, power, False)
    got = stft.spectrogram(torch.from_numpy(x), 400, 160, None, power, False)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= STFT_REL


def test_stft_and_spectrogram_defaults_unchanged():
    """The defaults give the DFT matmul's result bit for bit, as before the
    window, center and power arguments."""
    x = torch.from_numpy(_signal(4))
    re, im = stft.stft_matmul(x, 512, 128)
    assert torch.equal(stft.spectrogram(x, 512, 128), re * re + im * im)
    assert torch.equal(stft.stft(x, 512, 128), torch.complex(re, im))


@pytest.mark.parametrize("hop,win,center,length", [
    (128, None, True, None),   # hop divides n_fft: shifted adds
    (100, 400, True, 3900),    # generic overlap-add, padded window, cut to length
    (128, 400, False, None),
], ids=["hop128", "hop100_len", "uncentered"])
def test_istft_as_jax(hop, win, center, length):
    x = _signal(5)
    w = np.random.RandomState(6).uniform(0.2, 1.0, win or 512).astype(np.float32)
    spec = np.array(jax_stft(x, 512, hop, win, w, center))
    want = jax_istft(spec, 512, hop, win, w, center, length)
    got = stft.istft(torch.from_numpy(spec), 512, hop, win, torch.from_numpy(w), center, length)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= STFT_REL


def test_istft_inverts_stft():
    x = torch.from_numpy(_signal(7))
    y = stft.istft(stft.stft(x, 512, 128), 512, 128, length=x.shape[-1])
    assert float((y - x).abs().max()) <= ROUND_TRIP_TOL


# -- get_network -----------------------------------------------------------------


def test_get_network_as_jax():
    """``get_network`` builds the network that ``Lip2Speech`` builds: the same
    parameters and buffers, the face net, eval mode. Its strict load of a
    JAX model's ``weights.from_flax`` is held in ``test_torch_weights.py``
    (small and default configs), where the JAX model is already traced."""
    jc, tc = small_configs()
    jnet = jax_get_network(jc)
    assert isinstance(jnet, JLip2Speech) and jnet.cfg == jc
    net = get_network(tc)
    assert isinstance(net, Lip2Speech) and net.cfg == tc
    assert net.vgg_face is not None and not net.training
    want = {k: v.shape for k, v in Lip2Speech(tc).state_dict().items()}
    assert {k: v.shape for k, v in net.state_dict().items()} == want


# -- the public surface ------------------------------------------------------------

# JAX module -> the port modules that hold its names (a renamed backend)
RENAMED_MODULES = {
    "detect/onnx_jax.py": ("detect/onnx_torch.py",),
    "detect/openvino_jax.py": ("detect/openvino_torch.py",),
    "ops/pallas_decoder.py": ("kernels/ar_decode.py",),  # the kernel itself: csrc/ar_decode.cu
    "parallel/mesh.py": ("parallel/dist.py", "parallel/tensor.py"),
    "train/checkpoint.py": ("train/checkpoint.py", "weights.py"),
}

# (JAX module, name) -> "port module:name" of its counterpart under another name
RENAMED = {
    ("detect/__init__.py", "nms_jax"): "detect/__init__.py:nms_torch",
    ("detect/face_detector.py", "nms_jax"): "detect/face_detector.py:nms_torch",
    ("models/decoder.py", "adaptive_avg_pool"): "models/decoder.py:adaptive_avg_pool_matrix",
    ("models/layers.py", "positional_encoding"): "models/layers.py:sinusoid_table",
    ("ops/estoi.py", "estoi_batch_jax"): "ops/estoi.py:estoi_batch",
    ("ops/estoi.py", "stoi_batch_jax"): "ops/estoi.py:stoi_batch",
    ("ops/pallas_decoder.py", "pallas_ar_decode"): "kernels/ar_decode.py:ar_decode",
    ("parallel/__init__.py", "auto_mesh"): "parallel/dist.py:init_from_env",
    ("parallel/__init__.py", "create_mesh"): "parallel/dist.py:join_grid",
    ("parallel/__init__.py", "distribute_batch"): "parallel/dist.py:local_rows",
    ("parallel/__init__.py", "shard_train_state"): "parallel/tensor.py:shard_",
    ("parallel/__init__.py", "shard_like"): "parallel/tensor.py:load_full_state_dict_",
    ("parallel/mesh.py", "auto_mesh"): "parallel/dist.py:init_from_env",
    ("parallel/mesh.py", "create_mesh"): "parallel/dist.py:join_grid",
    ("parallel/mesh.py", "distribute_batch"): "parallel/dist.py:local_rows",
    ("parallel/mesh.py", "shard_train_state"): "parallel/tensor.py:shard_",
    ("parallel/mesh.py", "shard_like"): "parallel/tensor.py:load_full_state_dict_",
    ("parallel/mesh.py", "opt_state_shardings"): "parallel/tensor.py:shard_flat",
    ("speaker/__init__.py", "make_speaker_optimizer"): "speaker/train_loop.py:SpeakerOptimizer",
    ("speaker/train_loop.py", "make_speaker_optimizer"): "speaker/train_loop.py:SpeakerOptimizer",
    ("train/__init__.py", "make_optimizer"): "train/optim.py:AMSGrad",
    ("train/__init__.py", "trainable_mask"): "train/optim.py:is_trainable",
    ("train/train_step.py", "make_optimizer"): "train/optim.py:AMSGrad",
    ("train/train_step.py", "trainable_mask"): "train/optim.py:is_trainable",
    ("train/train_step.py", "TRAINABLE_TOP"): "train/optim.py:TRAINABLE_TOP",
    ("train/checkpoint.py", "flax_to_torch"): "weights.py:from_flax",
}

_STEP = "a make_* factory of a jitted step; the port calls its step directly"
_FLAX = "a flax layer or initialiser; torch.nn holds the port's"
_OPTAX = "an optax transform; the port's apply_update skips such an update itself"
_SHARDING = "a jax.sharding placement; each rank of the port holds its own rows and shards"
_MODULE = "*"  # the whole module

# (JAX module, name or _MODULE) -> why the port has no counterpart
JAX_ONLY = {
    ("cli/common.py", "init_variables"):
        "initialises flax variables; the port's modules own their parameters (init_random_)",
    ("detect/face_detector.py", "REFERENCE_MODEL_DIR"):
        "the reference repository's detector directory, absent; both read the repo's weights",
    ("models/layers.py", "GAIN"): _FLAX,
    ("models/layers.py", "LSTM"): _FLAX,
    ("models/layers.py", "MLP"): _FLAX,
    ("models/layers.py", "PReLU"): _FLAX,
    ("models/layers.py", "batch_norm"): _FLAX,
    ("models/layers.py", "xavier_uniform_gain"): _FLAX,
    ("models/video.py", "sqrt_fan_init"): _FLAX,
    ("models/video.py", "fold_time_taps"):
        "folds the Conv3d's time taps into a 2D conv for the TPU; the port runs the Conv3d",
    ("native/__init__.py", _MODULE):
        "libjpeg through ctypes, from which the JAX reader falls back to cv2; the port uses cv2",
    ("parallel/__init__.py", "batch_sharding"): _SHARDING,
    ("parallel/__init__.py", "replicated"): _SHARDING,
    ("parallel/__init__.py", "shard_pytree"): _SHARDING,
    ("parallel/mesh.py", "batch_sharding"): _SHARDING,
    ("parallel/mesh.py", "replicated"): _SHARDING,
    ("parallel/mesh.py", "shard_pytree"): _SHARDING,
    ("speaker/__init__.py", "make_speaker_train_step"): _STEP,
    ("speaker/train_loop.py", "make_speaker_train_step"): _STEP,
    ("train/__init__.py", "make_train_step"): _STEP,
    ("train/train_step.py", "make_train_step"): _STEP,
    ("train/adversarial.py", "make_adversarial_train_step"): _STEP,
    ("train/adversarial.py", "make_critic_step"): _STEP,
    ("train/train_step.py", "SkipIfNotFiniteState"): _OPTAX,
    ("train/train_step.py", "skip_if_not_finite"): _OPTAX,
    ("train/train_step.py", "reject_above_norm"): _OPTAX,
    ("train/checkpoint.py", "torch_to_flax"): "writes a flax tree; the port holds no flax trees",
    ("utils/compile_cache.py", _MODULE): "XLA's persistent compilation cache; the port compiles no XLA",
}

JAX_MODULES = sorted(os.path.relpath(os.path.join(d, f), JAX_PKG)
                     for d, _, files in os.walk(JAX_PKG) for f in files if f.endswith(".py"))


def _bound_names(path: str, jax_public: bool = False) -> set[str]:
    """Top-level names a module binds: its definitions, assignments and
    imports. With ``jax_public`` (a JAX module's public surface) private
    names and imports do not count, except a package ``__init__``'s imports
    from its own package, which it exports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    exports = os.path.basename(path) == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and (
                not jax_public or exports and (node.module or "").startswith("lip2speech_tpu")):
            out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import) and not jax_public:
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if jax_public else out


def _port_names(rel: str) -> set[str]:
    path = os.path.join(PORT_PKG, rel)
    return _bound_names(path) if os.path.exists(path) else set()


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_surface_has_a_port_counterpart(rel):
    public = _bound_names(os.path.join(JAX_PKG, rel), jax_public=True)
    mapped = {n: v for (m, n), v in RENAMED.items() if m == rel}
    only = {n: why for (m, n), why in JAX_ONLY.items() if m == rel}
    assert all(why for why in only.values())
    if _MODULE in only:
        assert not os.path.exists(os.path.join(PORT_PKG, rel)), f"{rel} is ported: drop it from JAX_ONLY"
        return
    # every entry of the map and the allow-list names a public name of this module
    assert set(mapped) | set(only) <= public, sorted((set(mapped) | set(only)) - public)
    targets = RENAMED_MODULES.get(rel, (rel,))
    assert all(os.path.exists(os.path.join(PORT_PKG, t)) for t in targets), targets
    port = set().union(*(_port_names(t) for t in targets))
    missing = []
    for name in sorted(public):
        if name in mapped:
            where, _, new = mapped[name].partition(":")
            if new not in _port_names(where):
                missing.append(f"{name} -> {mapped[name]}")
        elif name in only:
            assert name not in port, f"{rel}:{name} is in the port: drop it from JAX_ONLY"
        elif name not in port:
            missing.append(name)
    assert not missing, f"{rel}: no counterpart in {targets} for {missing}"
