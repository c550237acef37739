"""Spans at the port's layer boundaries, and a host-clock record of them.

``span(name)`` marks one layer's work. With no profiler recording and no
``recording()`` open it returns one shared null context: no
``record_function``, no allocation, no wait for the device; its cost is one
read of the profiler's flag. Under ``torch.profiler`` (the benchmark's
traced window, ``cli/train --profile_step``) it opens
``record_function(name)``, which the profiler stamps on the clock of the
device's activity, so the trace can name an idle gap by the program's
innermost span. Inside ``recording()`` it also appends the span to the
recording. No span reads a device value: a span's time is the host's.

The open recording is a module global, as the profiler's own state is: a
span deep in the model cannot be handed one, and only the thread that
opened a recording records into it.

The names are the port's layers: ``model.forward``, ``model.face_net``,
``decoder.encode``, ``decoder.ar_decode``, ``decoder.postnet``,
``decoder.teacher_forced``, ``data.prepare_batch``, ``train.*``,
``adversarial.*`` and the BigVGAN vocoder's ``vocoder.forward``,
``vocoder.upsample``, ``vocoder.amp`` and ``vocoder.activation``. The
profiler gives a kernel to the innermost range open at its launch, and
stamps each range on the device from its first own kernel to its last: a
span opened inside another range takes that range's device time from it,
and a range whose own kernels bracket another's also spans those. The
video encoder and ``mel_to_audio`` open no span: their callers' ranges time
each as a whole.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

NULL = contextlib.nullcontext()
LIMIT = 1 << 16  # spans a recording keeps: ~5000 train steps, or ~13000 requests

_recording: Recording | None = None


class Recording:
    """The spans of one recording, as ``(name, start_ns, end_ns, parent)``:
    start and end from ``time.perf_counter_ns``, ``parent`` the index of
    the enclosing span (-1 for none). A span still open has ``end_ns``
    None. At most ``limit`` spans are kept; ``dropped`` counts the spans
    left out."""

    def __init__(self):
        self.limit = LIMIT
        self.spans: list[tuple] = []
        self.dropped = 0
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._thread = threading.get_ident()

    def _enter(self, name: str) -> int:
        if len(self.spans) >= self.limit:
            self.dropped += 1
            return -1
        i = len(self.spans)
        self.spans.append((name, time.perf_counter_ns(), None, self._open[-1] if self._open else -1))
        self._open.append(i)
        return i

    def _exit(self, i: int) -> None:
        if i < 0:
            return
        end = time.perf_counter_ns()
        self._open.pop()
        name, start, _, parent = self.spans[i]
        self.spans[i] = (name, start, end, parent)

    def clear(self) -> None:
        """Forgets every span and the count dropped; no span may be open."""
        if self._open:
            raise RuntimeError("a recording is cleared with spans still open")
        self.spans.clear()
        self.dropped = 0

    def self_ms(self) -> dict[str, float]:
        """Each name's host self time in ms: its closed spans' durations
        less the part their child spans cover."""
        own = [0 if end is None else end - start for _, start, end, _ in self.spans]
        child = [0] * len(self.spans)
        for i, (_, _, end, parent) in enumerate(self.spans):
            if parent >= 0 and end is not None:
                child[parent] += own[i]
        out: dict[str, float] = {}
        for i, (name, _, end, _) in enumerate(self.spans):
            if end is not None:
                out[name] = out.get(name, 0.0) + (own[i] - child[i]) / 1e6
        return out


class _Span:
    """A span inside a recording, under the profiler too when it runs."""

    __slots__ = ("rec", "name", "index", "rf")

    def __init__(self, rec: Recording, name: str, profiling: bool):
        self.rec, self.name = rec, name
        self.rf = record_function(name) if profiling else None

    def __enter__(self):
        self.index = self.rec._enter(self.name)
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._exit(self.index)
        return False


def span(name: str):
    """A context manager around one layer's work (see the module docstring)."""
    rec = _recording
    profiling = _autograd_profiler._is_profiler_enabled
    if rec is not None and rec._thread == threading.get_ident():
        return _Span(rec, name, profiling)
    return record_function(name) if profiling else NULL


@contextlib.contextmanager
def recording():
    """Records every span this thread opens inside the block; yields the
    ``Recording``. A recording opened inside another stands in for it until
    it closes."""
    global _recording
    rec = Recording()
    outer, _recording = _recording, rec
    try:
        yield rec
    finally:
        _recording = outer
