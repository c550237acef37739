"""The benchmark's spans and the reading of the profiler's trace.

Spans are ``record_function`` ranges that the benchmark's own code opens
around the calls into each layer, and forward hooks on the program's
modules that open one around each module call; they are live only inside
the traced window. The profiler records the host's ranges and the device's
operations on one clock; ``summarize`` reduces them to what the per-layer
metrics read: the device's busy time over the window, its operations by
name, its idle gaps by the host range they fall in, the device time of the
operations inside each range, and the count of kernels. ``host_timed``
times a program function that opens one of the program's ranges by the
host's clock alone, outside the profiler, which slows the host.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time

import torch
from torch.profiler import record_function

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list          # [name, seconds], most time first
    idle_gaps: list           # [host range, seconds], most time first
    range_device_s: dict      # range name -> device seconds of the operations inside it
    kernel_s: dict            # kernel name -> device seconds
    kernel_calls: dict        # kernel name -> launches


class Tracer:
    def __init__(self):
        self.active = False
        self.summary: Summary | None = None
        self._handles = []

    def span(self, name: str):
        return record_function(name) if self.active else contextlib.nullcontext()

    def hook(self, module: torch.nn.Module, name: str):
        """A range named ``name`` around every call of ``module`` while the
        traced window is open."""
        stack = []

        def pre(mod, args):
            if self.active:
                rf = record_function(name)
                rf.__enter__()
                stack.append(rf)

        def post(mod, args, out):
            if stack:
                stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    @contextlib.contextmanager
    def window(self, dev: torch.device):
        """Profile the block, which ends with the device idle."""
        from torch.profiler import ProfilerActivity, profile

        cuda = dev.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        if cuda:
            torch.cuda.synchronize(dev)
        with profile(activities=activities) as prof:
            self.active = True
            try:
                with record_function(WINDOW):
                    yield
                    if cuda:
                        torch.cuda.synchronize(dev)
            finally:
                self.active = False
        for h in self._handles:
            h.remove()
        self._handles = []
        self.summary = summarize(prof.profiler.kineto_results.events())


@contextlib.contextmanager
def host_timed(out: dict, spans: dict):
    """Inside the block, each call of a program function that opens a span
    (``spans``: span name -> (module, function)) appends its host seconds to
    ``out[span name]``. A function the program no longer has is left out."""
    patched = []
    for span, (mod_name, fn_name) in spans.items():
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name, None)
        if real is None:
            continue
        calls = out.setdefault(span, [])

        def timed(*args, _real=real, _calls=calls, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kw)
            finally:
                _calls.append(time.perf_counter() - t0)

        setattr(mod, fn_name, timed)
        patched.append((mod, fn_name, real))
    try:
        yield
    finally:
        for mod, fn_name, real in patched:
            setattr(mod, fn_name, real)


def _kind(e) -> str:
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return "gpu_user_annotation" if e.device_type() == torch.autograd.DeviceType.CUDA else "user_annotation"
    return "kernel" if e.device_type() == torch.autograd.DeviceType.CUDA else "cpu_op"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(ops, merged) -> int:
    """ns of ``ops`` (start, end) inside the union ``merged``."""
    starts = [a for a, _ in merged]
    total = 0
    for a, b in ops:
        i = bisect.bisect_right(starts, a) - 1
        i = max(i, 0)
        while i < len(merged) and merged[i][0] < b:
            lo, hi = max(a, merged[i][0]), min(b, merged[i][1])
            total += max(0, hi - lo)
            i += 1
    return total


def summarize(events) -> Summary:
    dev, ann, host = [], {}, []
    for e in events:
        kind = _kind(e)
        s = e.start_ns()
        t = s + e.duration_ns()
        if kind in DEVICE_KINDS:
            dev.append((s, t, e.name(), kind))
        elif kind == "gpu_user_annotation":
            ann.setdefault(e.name(), []).append((s, t))
        elif kind == "user_annotation":
            host.append((s, t, e.name()))
    win = [(s, t) for s, t, n in host if n == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0]
    dev = [(max(s, w0), min(t, w1), n, k) for s, t, n, k in dev if t > w0 and s < w1]
    busy = _merge([(s, t) for s, t, _, _ in dev])
    busy_ns = sum(b - a for a, b in busy)

    by_name, kernel_s, kernel_calls = {}, {}, {}
    for s, t, n, k in dev:
        by_name[n] = by_name.get(n, 0) + (t - s)
        if k == "kernel":
            kernel_s[n] = kernel_s.get(n, 0) + (t - s) / 1e9
            kernel_calls[n] = kernel_calls.get(n, 0) + 1
    device_ops = sorted(([n[:160], v / 1e9] for n, v in by_name.items()), key=lambda x: -x[1])[:10]

    # idle gaps, named by the innermost host range open where each begins
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    ranges = sorted((s, -t, n) for s, t, n in host if n != WINDOW)
    idle, stack, r = {}, [], 0
    for a, b in gaps:
        while r < len(ranges) and ranges[r][0] <= a:
            stack.append((-ranges[r][1], ranges[r][2]))
            r += 1
        stack = [x for x in stack if x[0] >= a]
        name = stack[-1][1] if stack else "outside any range"
        idle[name] = idle.get(name, 0) + (b - a) / 1e9
    idle_gaps = sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])[:10]

    ops = [(s, t) for s, t, _, _ in dev]
    range_device_s = {n: _overlap(ops, _merge(iv)) / 1e9 for n, iv in ann.items()}
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, kernels=sum(kernel_calls.values()),
                   device_ops=device_ops, idle_gaps=idle_gaps, range_device_s=range_device_s,
                   kernel_s=kernel_s, kernel_calls=kernel_calls)
