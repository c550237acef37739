"""The port's spans (``lip2speech_torch/utils/trace.py``) on the CPU: off,
under ``torch.profiler`` and inside a recording, on a tiny model through
the AR kernel's plain path."""

import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lip2speech_torch.config import Config, ModelConfig, TrainConfig
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.ops.griffin_lim import mel_to_audio
from lip2speech_torch.train.train_step import create_train_state, train_step
from lip2speech_torch.utils import trace
from torch_port_common import SMALL
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, M = 2, 12, 8
CFG = Config(model=ModelConfig(**SMALL), train=TrainConfig(bf16=False))

# each span the path opens, once, by its enclosing span (None: outermost);
# the video encoder and mel_to_audio open none
INFER = {
    "model.forward": None, "model.face_net": "model.forward", "decoder.encode": "model.forward",
    "decoder.ar_decode": "model.forward", "decoder.postnet": "model.forward",
}
TRAIN = {
    "train.forward": None, "model.forward": "train.forward", "model.face_net": "model.forward",
    "decoder.encode": "model.forward", "decoder.teacher_forced": "model.forward",
    "decoder.postnet": "model.forward", "train.loss": None, "train.backward": None,
    "train.optimizer": None, "train.grad_all_reduce": "train.optimizer", "train.batch_stats": None,
}


def _inputs(gen):
    video = torch.randn(B, T, 48, 48, 3, generator=gen)
    faces = torch.randn(B, 2, 80, 80, 3, generator=gen)
    return video, faces


def run_infer():
    gen = torch.Generator().manual_seed(0)
    model = init_random_(Lip2Speech(CFG.model), gen)
    video, faces = _inputs(gen)
    out = model(video, faces, generator=gen)
    mel_to_audio(out["mel_postnet"][..., :M], CFG.audio, n_iter=2, nnls_iters=2, generator=gen)


def run_train():
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(CFG, init_random_(Lip2Speech(CFG.model), gen))
    video, faces = _inputs(gen)
    batch = {"video": video, "faces": faces, "mel": torch.randn(B, 80, M, generator=gen),
             "gate": torch.zeros(B, M), "mel_mask": torch.ones(B, M, dtype=torch.bool)}
    train_step(state, batch, 0.5, CFG)


def profiler_ranges(prof) -> list[tuple[str, int, int]]:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def enclosing(ranges, i) -> str | None:
    """The name of the innermost range that holds range ``i``."""
    _, s, t = ranges[i]
    holders = [(s0, n) for j, (n, s0, t0) in enumerate(ranges) if j != i and s0 <= s and t <= t0]
    return max(holders)[1] if holders else None


def peak_bytes(fn) -> int:
    names = ["model.forward"] * 1000
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for name in names:
            fn(name)
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_off_a_span_is_the_shared_null_context(monkeypatch):
    def never(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(trace, "record_function", never)
    monkeypatch.setattr(torch.cuda, "synchronize", never)
    assert trace.span("model.forward") is trace.NULL
    # the most memory held while 1000 spans are made, against a loop that makes none
    assert peak_bytes(trace.span) == peak_bytes(lambda name: None)

    # a recording holds the spans of the thread that opened it, and no other's
    with trace.recording() as rec:
        worker = threading.Thread(target=lambda: trace.span("data.prepare_batch").__enter__())
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive() and rec.spans == [] and rec.dropped == 0
    assert trace.span("model.forward") is trace.NULL


@pytest.mark.parametrize("path", ["infer", "train"])
def test_spans_under_the_profiler_and_in_a_recording(path):
    want = INFER if path == "infer" else TRAIN
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as rec:
        (run_infer if path == "infer" else run_train)()
    ranges = profiler_ranges(prof)
    assert sorted(n for n, _, _ in ranges) == sorted(want)
    assert {n: enclosing(ranges, i) for i, (n, _, _) in enumerate(ranges)} == want

    # the recording: the same spans and parents, each closed inside its parent, none dropped
    assert sorted(name for name, _, _, _ in rec.spans) == sorted(want) and rec.dropped == 0
    for name, start, end, parent in rec.spans:
        outer = rec.spans[parent] if parent >= 0 else None
        assert (outer[0] if outer else None) == want[name]
        assert end is not None and end >= start
        assert outer is None or outer[1] <= start and end <= outer[2]
    assert set(rec.self_ms()) == set(want) and min(rec.self_ms().values()) >= 0


def test_self_time_calls_and_the_bound():
    with trace.recording() as rec:
        # a unit of 10 ms holding a 3 ms and a 4 ms child; the 4 ms child holds 1 ms
        rec.spans = [("unit", 0, 10_000_000, -1), ("a", 1_000_000, 4_000_000, 0),
                     ("b", 5_000_000, 9_000_000, 0), ("a", 6_000_000, 7_000_000, 2)]
        assert rec.self_ms() == pytest.approx({"unit": 3.0, "a": 4.0, "b": 3.0})
        rec.spans, rec.limit = rec.spans[:3], 4
        with trace.span("c"), trace.span("d"):
            pass
    assert [s[0] for s in rec.spans] == ["unit", "a", "b", "c"] and rec.dropped == 1
    assert rec.spans[3][3] == -1
    rec.clear()
    assert rec.spans == [] and rec.dropped == 0 and rec.self_ms() == {}
    with trace.recording() as rec, trace.span("c"), pytest.raises(RuntimeError):
        rec.clear()  # not with a span open
