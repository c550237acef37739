"""The cell ``lrw_bigvgan.offline_b256`` and the data-parallel training loop
on the CPU at a small size, and their comparisons.

- A sound tiny run of each is correct (the data-parallel one as four gloo
  ranks in processes of their own) and a traced one carries the per-layer
  metrics that the CPU can read. The data-parallel loop runs as the cell
  ``lrw.train_dp4`` would: ``lrw``'s configuration with the traffic file
  ``train_dp4`` and the limits ``lrw.train_dp4``, which BENCHMARK.json does
  not list yet.
- The vocoder cell's ``correct`` fails an altered generator signal: a
  linear one at every activation, and faults of SnakeBeta's sine term in
  the last stage alone. The control (the reference, Lip2Speech and
  BigVGAN, with float8 operands in the program's place) fails
  ``vocoder_rel`` alone.
- The counts of ``harness/vocoder_flops.py`` against the published
  arithmetic, and its convolutions against torch's own counter.
- On the card (``cuda``): the control at the vocoder cell's own size.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import run
from port_bench.harness import runtime, spec, vocoder_flops
from port_bench.harness.compare import verdict
from port_bench.loops import infer_vocoder
from port_bench.tests.tiny import cell_limits, tiny_cell

CPU = torch.device("cpu")
VOCODER, DP = "lrw_bigvgan.offline_b256", "lrw.train_dp4"
TINY_VOCODER = dict(upsample_initial_channel=128)  # two channels in the last stage


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(name: str, precision: str = "float32"):
    if name == DP:
        return dp_cell(precision)
    cell = tiny_cell(name, precision=precision, limits=cell_limits(name))
    cell.config["vocoder"].update(TINY_VOCODER)
    return cell


def dp_cell(precision: str):
    """``lrw.train_b64`` at the tiny size with ``train_dp4``'s traffic and
    ``lrw.train_dp4``'s limits, two rows a rank."""
    cell = tiny_cell("lrw.train_b64", precision=precision, limits=cell_limits(DP))
    with open(os.path.join(spec.BENCH_DIR, "traffic", "train_dp4.json")) as f:
        traffic = dict(json.load(f), precision=precision)
    traffic.update({k: v for k, v in cell.traffic.items() if k in traffic and k != "batch"}, batch=8)
    cell.name, cell.chips, cell.traffic = DP, 4, traffic
    return cell


def tiny_run(name: str, trace: bool = False):
    return run.run_cell(small_cell(name), 2**31 + 91, 0.3, trace, CPU, time.time())


@pytest.mark.parametrize("name", [VOCODER, DP])
def test_a_sound_tiny_run_is_correct(name):
    rec, metrics, device, _ = tiny_run(name, trace=True)
    assert rec.correct and rec.failed == 0 and rec.attempted >= 1, rec.checks
    want = {VOCODER: {"mfu.bigvgan", "device_idle.offline"},
            DP: {"backward_host_ms.train", "device_idle.train", "launches_per_step.train"}}[name]
    assert want <= set(metrics)


def last_stage(real, fault):
    """SnakeBeta's forward with ``fault`` in the last stage's channels alone."""
    last = TINY_VOCODER["upsample_initial_channel"] >> 6

    def forward(self, x):
        if self.alpha.shape[0] != last:
            return real(self, x)
        alpha, beta = fault(self.alpha, self.beta)
        return x + (1.0 / (beta[None, :, None].exp() + 1e-9)) * torch.sin(x * alpha[None, :, None].exp()).pow(2)

    return forward


ALTERED = {
    "every_activation_scaled": lambda real: lambda self, x: 1.02 * real(self, x),
    "last_stage_channels_rolled": lambda real: last_stage(real, lambda a, b: (a.roll(1), b.roll(1))),
    "last_stage_beta_sign": lambda real: last_stage(real, lambda a, b: (a, -b)),
}


@pytest.mark.parametrize("fault", sorted(ALTERED))
def test_an_altered_signal_fails(monkeypatch, fault):
    from lip2speech_torch.models.vocoder import SnakeBeta

    monkeypatch.setattr(SnakeBeta, "forward", ALTERED[fault](SnakeBeta.forward))
    rec, *_ = tiny_run(VOCODER)
    assert not rec.correct and rec.checks["vocoder_rel"]["value"] > rec.checks["vocoder_rel"]["limit"]


def test_the_control_fails_vocoder_rel():
    cell = small_cell(VOCODER, precision="bfloat16")
    readings, _ = infer_vocoder.control(cell, 31, CPU)
    assert readings["vocoder_rel"] > cell.limits["vocoder_rel"], readings
    assert not verdict(readings, cell.limits)[0]


def test_the_counts_match_the_published_arithmetic():
    conf = spec.load_cell(VOCODER).config
    v = conf["vocoder"]
    assert abs(vocoder_flops.vocoder_flops(v, 80, 1, 1) / 1.80e9 - 1) < 0.005
    assert vocoder_flops.activation_elements(v, 1, 1) == 614_400
    ops, nbytes = vocoder_flops.activation_work(v, 256, 80, 2)
    assert nbytes == 4 * 614_400 * 80 * 256 and ops == 58 * 614_400 * 80 * 256


def test_the_conv_count_is_torchs():
    """The closed form against FlopCounterMode over the published layers
    as torch's own convolution modules, on the meta device."""
    from lip2speech_torch.config import VocoderConfig
    from lip2speech_torch.models.vocoder import BigVGAN

    v = VocoderConfig(kind="bigvgan", upsample_initial_channel=128)
    with torch.device("meta"):
        gen = BigVGAN(v)
        x = torch.empty(2, 80, 5)
    for m in gen.modules():  # count the generator's own convolutions alone
        if hasattr(m, "up_filter"):
            m.forward = lambda x: x
    with FlopCounterMode(display=False) as c, torch.no_grad():
        gen.signal(x)
    vd = json.loads(json.dumps(v.__dict__))
    assert c.get_total_flops() == vocoder_flops.vocoder_flops(vd, 80, 2, 5)


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    cell = spec.load_cell(VOCODER)
    runtime.require_chips(cell.chips)
    for seed in (101, 102, 103):
        readings, _ = infer_vocoder.control(cell, seed, torch.device("cuda", 0))
        assert readings["vocoder_rel"] > cell.limits["vocoder_rel"], readings


def test_at_most_one_cell_in_four_asks_for_four_chips():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_the_new_loops_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.loops.infer_vocoder, port_bench.loops.train_dp, port_bench.harness.vocoder_flops\n"
            "import lip2speech_torch.models.vocoder\n"
            "from port_bench.harness.runtime import forbidden_modules; print(forbidden_modules())") % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_new_cells_limits_copy_the_old_ones():
    def limits(name):
        with open(os.path.join(spec.BENCH_DIR, "limits", f"{name}.json")) as f:
            return json.load(f)

    assert limits(DP) == limits("lrw.train_b64")
    old = limits("lrw.offline_b256")
    assert {k: v for k, v in limits(VOCODER).items() if k != "vocoder_rel"} == {
        k: v for k, v in old.items() if k != "wav_sc_gap"}
