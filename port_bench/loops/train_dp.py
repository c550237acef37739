"""Training with data parallelism: one train step after another on
``ranks`` processes, one a card, joined by NCCL (gloo on the CPU).

The process that runs the cell is rank 0 on ``cuda:0``; it starts the
other ranks (this module run by the same Python, handed its arguments
pickled on its standard input) on ``cuda:1`` and up, and
each joins the group at ``tcp://127.0.0.1:<a free port>`` through
``parallel.dist.join_grid``. Every rank makes ``train_staged``'s global
pool and state from the seed (checked the same on every rank), keeps its
data index's rows of each batch and of each per-row draw (16 of a global
64 on four ranks), and runs ``prepare_batch`` and the port's
``train_step`` under ``dp``: the BatchNorm moments and the gradients are
summed over the group. A small gloo group carries rank 0's decision to
take one more step, so every rank runs the same steps without a wait for
the device. Rank 0 alone is timed, traced and checked; a step counts the
global batch. The traffic file gives the global batch, the ranks, and
what ``train_staged``'s gives.

``correct``: after set-up's first steps, rank 0's state (the first
moment, the parameters' change, the BatchNorm statistics') against the
reference's steps on the whole global batch in one process
(``train_staged.check``), at ``lrw.train_b64``'s limits.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from port_bench.harness import compare
from port_bench.harness.runtime import Record, sync
from port_bench.harness.spec import ROOT, port_config
from port_bench.harness.tracing import Tracer, host_timed
from port_bench.loops.train_staged import (HOST_SPANS, MOMENT_B1, _leaf_norms, build_state, check,
                                           diagnostics, make_pool, step_failed, trained_stats)

KIND = "train"
TIMEOUT = datetime.timedelta(seconds=300)


def local_entry(entry: dict, dp) -> dict:
    """A pool entry's rows of ``dp``'s data index: the host batch and every
    per-row draw (batch-major; the loop's masks carry the batch on dim 1)."""
    from lip2speech_torch.parallel.dist import local_rows

    r, n = dp.data_index, dp.n_data
    d = entry["draws"]
    draws = {k: local_rows(d[k], r, n, dim=1) for k in ("prenet", "attention", "rnn")}
    draws.update(gumbel=local_rows(d["gumbel"], r, n), teacher=d["teacher"],
                 postnet=[local_rows(x, r, n) for x in d["postnet"]], encoder=local_rows(d["encoder"], r, n))
    return {"raw": {k: local_rows(v, r, n) for k, v in entry["raw"].items()}, "draws": draws}


def program_step(state, cfg, entry: dict, dev, tf_ratio: float, tracer: Tracer, dp) -> dict:
    """One step of this rank through the port: its rows to the card,
    prepared there, and the train step under ``dp``."""
    from lip2speech_torch.data.collate import prepare_batch, to_device
    from lip2speech_torch.train.train_step import train_step

    with tracer.span("bench.prepare"):
        batch = prepare_batch(to_device(entry["raw"], dev), cfg.audio, cfg.data)
    with tracer.span("bench.train_step"):
        return train_step(state, batch, tf_ratio, cfg, draws=entry["draws"], dp=dp)


def first_steps(state, cfg, pool, dev, t: dict, tracer: Tracer, dp) -> dict:
    """``train_staged.first_steps`` under ``dp``: the first moment and the
    reported norm are the global batch's, the same on every rank."""
    names = list(state.opt.names)
    params = dict(state.model.named_parameters())
    stats = trained_stats(state.model)
    p0 = {n: params[n].detach().clone() for n in names}
    s0 = {k: v.clone() for k, v in stats.items()}
    first = {"losses": [], "failed": []}
    for i in range(t["check_steps"]):
        m = program_step(state, cfg, pool[i], dev, t["tf_ratio"], tracer, dp)
        first["losses"].append(float(m["total"]))
        first["failed"].append(step_failed(m))
        if i == 0:
            scale = max(1.0, float(m["grad_norm"]) / cfg.train.grad_clip)
            flat = state.opt.mu / (1 - MOMENT_B1) * scale
            first["grad"] = _leaf_norms(dict(zip(names, flat.split([params[n].numel() for n in names]))))
    first["change"] = _leaf_norms({n: params[n].detach() - p0[n] for n in names})
    first["stats"] = _leaf_norms({k: stats[k] - s0[k] for k in stats})
    return first


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(dev_type: str, rank: int) -> torch.device:
    if dev_type != "cuda":
        return torch.device(dev_type)
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    return dev


def run_rank(cell, seed: int, seconds: float, trace: bool, rank: int, port: int, dev_type: str,
             t_start: float = 0.0):
    """One rank's run; rank 0 returns the run's record, checked."""
    from lip2speech_torch.parallel.dist import join_grid, same_on_all_ranks

    t, conf = cell.traffic, cell.config
    cfg = port_config(conf)
    if cfg.train.bf16 != (t["precision"] == "bfloat16"):
        raise ValueError("the traffic's precision and the configuration's bf16 policy disagree")
    world = t["ranks"]
    dev = rank_device(dev_type, rank)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        dp = join_grid(rank, world, dev, backend)
        ctl = dist.new_group(backend="gloo", timeout=TIMEOUT)
        state = build_state(cfg, conf, seed, dev)
        pool = make_pool(conf, t, seed, dev)
        if not same_on_all_ranks(list(state.model.state_dict().values()), dp):
            raise RuntimeError("the ranks made different weights from one seed")
        local = [local_entry(e, dp) for e in pool]
        tracer = Tracer()
        first = first_steps(state, cfg, local, dev, t, tracer, dp)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = Record(kind=KIND, cell=cell)
        rec.setup_s = time.time() - t_start
        go = torch.ones(1, dtype=torch.int32)
        outs = []
        timed = host_timed(rec.host_spans, HOST_SPANS) if trace and rank == 0 else contextlib.nullcontext()
        with timed:
            t0 = time.perf_counter()
            i = t["check_steps"]
            while True:
                if rank == 0:
                    go[0] = int(time.perf_counter() - t0 < seconds)
                dist.broadcast(go, 0, group=ctl)
                if not go[0]:
                    break
                start = time.perf_counter() - t0
                outs.append((start, program_step(state, cfg, local[i % len(local)], dev, t["tf_ratio"], tracer, dp)))
                i += 1
            sync(dev)
            end = time.perf_counter() - t0
        rec.units = [(s, end, t["batch"], not step_failed(m)) for s, m in outs]
        rec.window_s = end
        if trace:
            window = tracer.window(dev) if rank == 0 else contextlib.nullcontext()
            with window:
                for j in range(t["trace_units"]):
                    program_step(state, cfg, local[(i + j) % len(local)], dev, t["tf_ratio"], tracer, dp)
                sync(dev)
            rec.trace, rec.trace_units = tracer.summary, t["trace_units"]
        if dev.type == "cuda":
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        dist.barrier(group=ctl)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, ref = check(conf, t, seed, dev, pool, first)
    rec.correct, rec.checks = compare.verdict(readings, cell.limits)
    rec.correct = rec.correct and rec.failed == 0 and not any(first["failed"])
    rec.extra["leaves"] = {"program": first, "reference": ref}
    rec.extra["diagnostics"] = diagnostics(first, ref)
    return rec


def start_rank(*args) -> subprocess.Popen:
    """Rank ``args[4]`` of ``run_rank(*args)`` in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-m", "port_bench.loops.train_dp"], stdin=subprocess.PIPE,
                            cwd=ROOT, env=env)
    proc.stdin.write(pickle.dumps(args))
    proc.stdin.close()
    return proc


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> Record:
    ranks = cell.traffic["ranks"]
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, {torch.cuda.device_count()} are visible")
    port = free_port()
    procs = [start_rank(cell, seed, seconds, trace, r, port, dev.type) for r in range(1, ranks)]
    try:
        rec = run_rank(cell, seed, seconds, trace, 0, port, dev.type, t_start)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            try:
                p.wait(timeout=TIMEOUT.total_seconds())
            except subprocess.TimeoutExpired:
                p.kill()
    failed = [r for r, p in enumerate(procs, 1) if p.wait() != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} exited with an error")
    return rec


if __name__ == "__main__":
    rank_args = pickle.load(sys.stdin.buffer)
    if rank_args[-1] == "cpu":
        torch.set_num_threads(1)
    run_rank(*rank_args)
