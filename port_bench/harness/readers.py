"""The reductions that the metric files (``metrics/<name>.py``) apply to a
run's record. Each returns None where the run has nothing to read, and the
metric is then left out of the result line."""

from __future__ import annotations

import numpy as np

from port_bench.harness import flops

AR_KERNEL = "ar_decode_kernel"


def rate(rec, kind: str):
    """Clips whose work completed, over all the window."""
    if rec.kind != kind or rec.window_s <= 0:
        return None
    return rec.clips_ok / rec.window_s


def latency_ms(rec, q: float):
    """The q-th percentile of every request's time from issue to its
    waveform on the host."""
    if rec.kind != "infer" or not rec.units:
        return None
    return float(np.percentile(rec.latencies_ms, q))


def mfu(rec, kind: str):
    """Operations of a unit (the benchmark's count from the cell's shapes)
    over its mean wall time in the untraced window, against the chip's
    peak in the traffic's precision, in %."""
    if rec.kind != kind or not rec.units:
        return None
    t, conf = rec.cell.traffic, rec.cell.config
    if kind == "infer":
        ops = flops.infer_flops(conf, t["batch"], t["mel_prefix"], t["gl_iters"])
    else:
        ops = flops.train_flops(conf, t["batch"], t["tf_ratio"])
    per_unit_s = rec.window_s / len(rec.units)
    return 100.0 * ops / per_unit_s / flops.PEAK_FLOPS[t["precision"]]


def ar_decode_roofline(rec):
    """The AR kernel's least time (its operations and bytes at the cell's
    B, T, S, M and weight type) over its mean time in the trace, in %."""
    tr = rec.trace
    if tr is None:
        return None
    names = [n for n in tr.kernel_calls if AR_KERNEL in n]
    calls = sum(tr.kernel_calls[n] for n in names)
    if not calls:
        return None
    t, conf = rec.cell.traffic, rec.cell.config
    T = conf["data"]["max_video_frames"]
    weight_bytes = 2 if t["precision"] == "bfloat16" else 4
    ops, nbytes = flops.ar_decode_work(conf["model"], t["batch"], T, flops.codebook_slots(T),
                                       conf["model"]["max_decoder_steps"], weight_bytes)
    least = flops.least_seconds(ops, nbytes, t["precision"])
    return 100.0 * least / (sum(tr.kernel_s[n] for n in names) / calls)


def range_device_ms(rec, *names: str):
    """Device ms a unit of the operations inside the named ranges."""
    tr = rec.trace
    if tr is None or not any(n in tr.range_device_s for n in names):
        return None
    return 1e3 * sum(tr.range_device_s.get(n, 0.0) for n in names) / rec.trace_units


def span_host_ms(rec, name: str):
    """Host ms a call of the named program span, timed by the host's clock
    around each call in the measured window (no profiler running)."""
    calls = rec.host_spans.get(name)
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)


def kernels_per_unit(rec):
    tr = rec.trace
    if tr is None or not rec.trace_units:
        return None
    return tr.kernels / rec.trace_units


def device_idle(rec):
    """The share of the measured window's time with no operation on the
    device, in %: one minus the device's busy time a unit, read from the
    trace, over the wall time a unit of the measured (untraced) window. The
    profiler stretches the host's time, not the device's, so the traced
    window's own idle share (``device.busy_s`` over ``device.window_s``)
    reads higher where the host bounds the unit."""
    tr = rec.trace
    if tr is None or not rec.trace_units or not rec.units or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s / rec.trace_units) / (rec.window_s / len(rec.units)))
