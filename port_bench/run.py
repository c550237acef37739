#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lip2speech_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from ``BENCHMARK.json`` (its configuration, traffic mix,
limits and metrics, each a file of its own under ``port_bench/``), makes
the weights and inputs from the seed, warms up every shape the window uses,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics read from a traced window after the measured
one), ``device``, ``breakdown`` (traced runs) and ``checks``. Exits with a
non-zero code, printing no result, without enough CUDA devices or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache the program or its libraries keep lives inside the checkout, at a fixed path
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
os.environ["USE_FLAX"] = "0"

from port_bench.harness.runtime import process_start  # noqa: E402

T_START = process_start()

import argparse  # noqa: E402

import torch  # noqa: E402

from port_bench.harness import runtime, spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(rec, entries: list, required: bool) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(rec)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} has no value in this run")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float):
    """The cell's loop, then its metrics: (record, metrics, device, breakdown)."""
    loop = spec.loop_module(cell.traffic["kind"])
    rec = loop.run(cell, seed, seconds, trace, dev, t_start)
    if trace:
        metrics = metrics_of(rec, cell.per_layer, required=False)
    else:
        metrics = metrics_of(rec, cell.end_to_end, required=True)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    breakdown = None
    if trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        breakdown = {"device_ops": rec.trace.device_ops, "idle_gaps": rec.trace.idle_gaps}
    return rec, metrics, device, breakdown


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    runtime.require_chips(cell.chips)
    rec, metrics, device, breakdown = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                               torch.device("cuda", 0), T_START)
    found = runtime.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    runtime.emit(rec, metrics, device, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
