"""The port's weight bridge against the JAX package's converter.

``lip2speech_torch.weights.from_flax`` must give exactly what
``lip2speech_tpu.train.checkpoint.flax_to_torch`` gives (same keys, bitwise
equal arrays), and the port's ``Lip2Speech`` (built by ``get_network``)
must load it with ``strict=True`` on the small and the default configs. The port imports
nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lip2speech_tpu.config import ModelConfig as JModelConfig
from lip2speech_tpu.train.checkpoint import flax_to_torch
from lip2speech_torch import weights
from lip2speech_torch.config import ModelConfig
from lip2speech_torch.models.layers import FlaxRuleBatchNorm
from lip2speech_torch.models.lip2speech import Lip2Speech, get_network
from torch_port_common import lip2speech_variables, small_configs
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("size", ["small", "default"])
def test_from_flax_equals_flax_to_torch_and_loads_strict(size):
    jc, tc = small_configs() if size == "small" else (JModelConfig(), ModelConfig())
    tree = lip2speech_variables(jc)
    want = flax_to_torch(tree, jc)
    got = weights.from_flax(tree, tc)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert np.array_equal(g, v), k  # a layout move, so bitwise

    model = get_network(tc)
    assert isinstance(model, Lip2Speech)
    model.load_state_dict(got, strict=True)
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(want)
    # spot-check the reference names the issue lists
    for k in ("decoder.decoder_rnn.weight_ih_l0", "encoder.trunk.0.3.banch2.0.weight",
              "vgg_face.resnet.repeat_2.4.conv2d.weight"):
        assert torch.equal(model.state_dict()[k], got[k])
    # the face net's BatchNorms train by flax's rule (speaker pretraining)
    # and load under the same names; in Lip2Speech it stays in eval mode
    norms = [m for m in model.vgg_face.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(norms) > 100 and all(isinstance(m, FlaxRuleBatchNorm) for m in norms)
    assert torch.equal(model.vgg_face.resnet.last_bn.running_var, got["vgg_face.resnet.last_bn.running_var"])
    model.train()
    assert not any(m.training for m in model.vgg_face.modules())


def test_from_flax_without_face_net():
    """A model run with an external speaker embedding has no vgg_face:
    flax_to_torch raises, from_flax leaves the face net out."""
    jc, tc = small_configs()
    tree = lip2speech_variables(jc, face_net=False)
    assert "vgg_face" not in tree["params"]
    with pytest.raises(KeyError):
        flax_to_torch(tree, jc)
    sd = weights.from_flax(tree, tc)
    assert not any(k.startswith("vgg_face.") for k in sd)
    model = Lip2Speech(tc, face_net=False)
    model.load_state_dict(sd, strict=True)


def test_load_reference_pth_splits_speaker_encoder(tmp_path):
    jc, tc = small_configs()
    sd = weights.from_flax(lip2speech_variables(jc), tc)
    speaker = {"speaker_encoder.lstm.weight_ih_l0": torch.ones(4, 2)}
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {**sd, **speaker}}, path)
    main, spk = weights.load_reference_pth(str(path))
    assert set(spk) == {"lstm.weight_ih_l0"}
    assert set(main) == set(sd)
    Lip2Speech(tc).load_state_dict(main, strict=True)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import lip2speech_torch\n"
        "assert 'torch' not in sys.modules, 'importing the package alone loads torch'\n"
        "import lip2speech_torch.kernels.ar_decode  # first: the models package imports it\n"
        "import lip2speech_torch.models, lip2speech_torch.ops, lip2speech_torch.eval\n"
        "import lip2speech_torch.train, lip2speech_torch.parallel\n"
        "import lip2speech_torch.cli.synthesize, lip2speech_torch.eval.long_video\n"
        "import lip2speech_torch.kernels.ar_decode, lip2speech_torch.weights\n"
        "import lip2speech_torch.train.checkpoint, lip2speech_torch.train.losses\n"
        "import lip2speech_torch.train.optim, lip2speech_torch.train.train_step\n"
        "import lip2speech_torch.data.collate, lip2speech_torch.data\n"
        "import lip2speech_torch.cli.train, lip2speech_torch.cli.evaluate\n"
        "import lip2speech_torch.eval.evaluate, lip2speech_torch.eval.metrics\n"
        "import lip2speech_torch.ops.estoi\n"
        "import lip2speech_torch.models.discriminator, lip2speech_torch.models.speaker\n"
        "import lip2speech_torch.train.adversarial, lip2speech_torch.cli.demo\n"
        "import lip2speech_torch.speaker, lip2speech_torch.speaker.dataset\n"
        "import lip2speech_torch.speaker.losses, lip2speech_torch.speaker.models\n"
        "import lip2speech_torch.speaker.train_loop, lip2speech_torch.data.face_align\n"
        "import lip2speech_torch.data.wild, lip2speech_torch.data.streaming\n"
        "import lip2speech_torch.models.audio_extras\n"
        "import lip2speech_torch.cli.speaker_train, lip2speech_torch.cli.speaker_test\n"
        "import lip2speech_torch.detect, lip2speech_torch.detect.artifacts\n"
        "import lip2speech_torch.detect.onnx_reader, lip2speech_torch.detect.onnx_torch\n"
        "import lip2speech_torch.detect.openvino_torch, lip2speech_torch.detect.face_detector\n"
        "import lip2speech_torch.prep, lip2speech_torch.prep.common\n"
        "import lip2speech_torch.prep.resample, lip2speech_torch.prep.face_extractor\n"
        "import lip2speech_torch.prep.lrw_preprocess, lip2speech_torch.prep.wild_preprocess\n"
        "import lip2speech_torch.prep.speaker_preprocess, lip2speech_torch.prep.detector_demo\n"
        "import lip2speech_torch.prep.avspeech_acquire, lip2speech_torch.prep.wild_downloader\n"
        "import lip2speech_torch.utils, lip2speech_torch.utils.logger\n"
        "import lip2speech_torch.utils.devtime\n"
        "import lip2speech_torch.parallel, lip2speech_torch.parallel.dist\n"
        "import lip2speech_torch.parallel.tensor, lip2speech_torch.ops.image\n"
        "import lip2speech_torch.models.layers, lip2speech_torch.models.decoder\n"
        "import lip2speech_torch.ops.griffin_lim, lip2speech_torch.train.logging_utils\n"
        "import lip2speech_torch.data.loader, lip2speech_torch.cli.common\n"
        "import lip2speech_torch.models.vocoder\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lip2speech_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
