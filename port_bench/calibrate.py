#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults fp8,half_batch] [--witness-seeds 1,2,3] \
        [--f32-seeds 1,2] --seconds 3

For each of ``--seeds`` it runs the cell as a benchmark run does (a short
window at the cell's own load) and prints what each compared number read;
for each of ``--control-seeds`` it puts the reference, computed in float8
(one step below the serving type, bf16; forward and backward), in the
program's place at the cell's own size and prints what the same
comparison reads. A training cell also reads the fault of half the batch
left out (the mean taken over the rest), planted in the reference put in
the program's place. Two witnesses read a training cell's gaps from
elsewhere: ``--witness-seeds`` puts the reference under the program's
bf16 policy (every result and every gradient rounded to bf16, the loss in
f32) in the program's place, and ``--f32-seeds`` runs the program's own
steps in f32 (TF32 off). ``PERF.md`` records the readings and the limits
set from them. The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import copy  # noqa: E402
import statistics  # noqa: E402

import torch  # noqa: E402

from port_bench import run  # noqa: E402
from port_bench.harness import runtime, spec  # noqa: E402
from port_bench.harness.spec import port_config  # noqa: E402
from port_bench.harness.tracing import Tracer  # noqa: E402
from port_bench.loops import infer_closed, train_staged  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def control_infer(cell, seed: int, dev) -> dict:
    pool = infer_closed.make_pool(cell.config, cell.traffic, seed, dev)
    items = [(p, None, None) for p in range(min(cell.traffic["check_requests"], len(pool)))]
    served = infer_closed.control_outputs(cell.config, cell.traffic, seed, dev, pool, items)
    readings, rows = infer_closed.check(cell.config, cell.traffic, seed, dev, pool, served)
    return readings, {"rows": {k: v.tolist() for k, v in rows.items()}}


def control_train(cell, seed: int, dev, fault: str) -> dict:
    t = cell.traffic
    pool = train_staged.make_pool(cell.config, t, seed, dev)
    ref = train_staged.reference_steps(cell.config, t, seed, dev, pool)
    if fault in ("fp8", "bf16"):
        served = train_staged.reference_steps(cell.config, t, seed, dev, pool, fault)
    else:  # half of the batch left out, the mean taken over the rest
        half = t["batch"] // 2

        def cut(entry):
            draws = dict(entry["draws"])
            for k in ("prenet", "attention", "rnn"):
                draws[k] = draws[k][:, :half]
            draws["postnet"] = [x[:half] for x in draws["postnet"]]
            draws["encoder"] = draws["encoder"][:half]
            S = draws["gumbel"].shape[0] // t["batch"]
            draws["gumbel"] = draws["gumbel"][:half * S]
            return {"raw": {k: v[:half] for k, v in entry["raw"].items()}, "draws": draws}

        served = train_staged.reference_steps(cell.config, t, seed, dev, [cut(e) for e in pool])
    return train_staged.readings_of(served, ref), {"leaves": {"program": served, "reference": ref}}


def program_f32(cell, seed: int, dev) -> tuple[dict, dict]:
    """The program's first steps with its bf16 policy off, on the cell's
    batches, against the reference (``main`` turns TF32 off)."""
    conf = copy.deepcopy(cell.config)
    conf["train"]["bf16"] = False
    t = cell.traffic
    pool = train_staged.make_pool(conf, t, seed, dev)
    state = train_staged.build_state(port_config(conf), conf, seed, dev)
    first = train_staged.first_steps(state, port_config(conf), pool, dev, t, Tracer())
    del state
    ref = train_staged.reference_steps(conf, t, seed, dev, pool)
    return train_staged.readings_of(first, ref), {"leaves": {"program": first, "reference": ref}}


def grad_ratios(leaves: dict) -> dict:
    """The raw first gradient's norm, served over the reference's: the
    median leaf of each module (the first two parts of a leaf's name), and
    the whole gradient's."""
    prog, ref = leaves["program"]["grad"], leaves["reference"]["grad"]
    groups = {}
    for n in train_staged.moving(leaves["reference"]):
        groups.setdefault(".".join(n.split(".")[:2]), []).append(prog[n] / ref[n])
    out = {k: statistics.median(v) for k, v in sorted(groups.items())}
    out["global"] = (sum(v * v for v in prog.values()) / sum(v * v for v in ref.values())) ** 0.5
    return out


def controls_and_witnesses(cell, args, dev, record):
    """Each control seed's (and a training cell's witness seeds') readings,
    through ``record``."""
    kind = cell.traffic["kind"]
    for s in args.control_seeds:
        faults = ["fp8"] if kind == "infer_closed" else [f for f in args.faults.split(",") if f]
        for fault in faults:
            t0 = time.time()
            if kind == "infer_closed":
                readings, raw = control_infer(cell, s, dev)
            else:
                readings, raw = control_train(cell, s, dev, fault)
            line = {"control_seed": s, "fault": fault, "readings": readings, "s": time.time() - t0}
            if "leaves" in raw:
                line["grad_ratios"] = grad_ratios(raw["leaves"])
            record(line, raw)
            torch.cuda.empty_cache()
    for name, chosen in (("bf16_reference", args.witness_seeds), ("program_f32", args.f32_seeds)):
        for s in chosen:
            t0 = time.time()
            if name == "bf16_reference":
                readings, raw = control_train(cell, s, dev, "bf16")
            else:
                readings, raw = program_f32(cell, s, dev)
            record({"witness_seed": s, "witness": name, "readings": readings,
                    "diagnostics": train_staged.diagnostics(raw["leaves"]["program"], raw["leaves"]["reference"]),
                    "grad_ratios": grad_ratios(raw["leaves"]), "s": time.time() - t0}, raw)
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="fp8,half_batch",
                   help="what a training cell's control seeds read (fp8, half_batch)")
    p.add_argument("--witness-seeds", type=seeds, default=[],
                   help="the reference under the bf16 policy against the reference (training cells)")
    p.add_argument("--f32-seeds", type=seeds, default=[],
                   help="the program's steps in f32 against the reference (training cells)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", help="a file for every row's or leaf's readings (JSON lines)")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    runtime.require_chips(cell.chips)
    dev = torch.device("cuda", 0)
    print(f"card: {runtime.power_limit()}", flush=True)
    out = open(args.out, "a") if args.out else None

    def record(line: dict, raw: dict):
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps({**line, **raw}) + "\n")
            out.flush()

    for s in args.seeds:
        t0 = time.time()
        rec, metrics, device, _ = run.run_cell(cell, s, args.seconds, False, dev, time.time())
        record({"program_seed": s, "correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
                "readings": {k: c["value"] for k, c in rec.checks.items()},
                "metrics": {k: m["value"] for k, m in metrics.items()},
                "memory_peak_bytes": device["memory_peak_bytes"], "s": time.time() - t0,
                **({"grad_ratios": grad_ratios(rec.extra["leaves"])} if "leaves" in rec.extra else {})},
               rec.extra)
        torch.cuda.empty_cache()
    with runtime.no_tf32():  # the controls and witnesses compute as the reference does
        controls_and_witnesses(cell, args, dev, record)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
