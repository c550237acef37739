"""The benchmark's harness on the CPU: the files each cell finds by name,
the contract's keys, the result line of a tiny run, and the check for
JAX in the process.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import ast
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from port_bench import run
from port_bench.harness import runtime, spec
from port_bench.tests.tiny import cell_limits, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bench() -> dict:
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in bench()["workloads"]]


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in b["workloads"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"} for m in b["end_to_end"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
               for m in b["per_layer"])
    assert all(0 < len(x["why"]) <= 200 for k in ("configs", "workloads") for x in b[k])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0 < m["bound"] <= 0.25 for m in b["end_to_end"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert {(w["config"], w["traffic"]) for w in b["workloads"]}.__len__() == len(b["workloads"])
    assert all(w["chips"] == 1 for w in b["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    b = bench()
    cell = spec.load_cell(name)
    work = {w["name"]: w for w in b["workloads"]}[name]
    conf = {c["name"]: c for c in b["configs"]}[work["config"]]
    assert conf["file"].startswith("port_bench/configs/") and cell.config["name"] == conf["name"]
    assert cell.config["reduced"] == conf["reduced"] == []
    spec.port_config(cell.config)  # every key is a field of the port's Config
    spec.loop_module(cell.traffic["kind"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {name} does not report"
    assert set(cell.limits) and all(v is not None for v in cell.limits.values())


def test_each_config_file_is_used_once():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def _result_line(name: str, trace: bool) -> tuple[dict, str]:
    cell = tiny_cell(name, limits=cell_limits(name))
    rec, metrics, device, breakdown = run.run_cell(cell, 2**31 + 77, 0.5, trace, torch.device("cpu"), time.time())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out):
        sys_stderr, sys.stderr = sys.stderr, err
        try:
            runtime.emit(rec, metrics, device, breakdown)
        finally:
            sys.stderr = sys_stderr
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("name", ["lrw.offline_b256", "lrw.train_b64"])
def test_tiny_run_prints_the_contract_line(name):
    line, err = _result_line(name, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {m["name"] for m in spec.load_cell(name).end_to_end} == set(line["metrics"])
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(x.startswith("check ") and "limit" in x for x in last)


def test_tiny_traced_run_carries_breakdown():
    line, _ = _result_line("lrw.offline_b256", trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.offline" in line["metrics"]


def test_tiny_traced_train_run_times_the_backward_by_the_host_clock():
    ts = importlib.import_module("lip2speech_torch.train.train_step")  # the package exports a function of that name
    real = ts.backward
    line, _ = _result_line("lrw.train_b64", trace=True)
    assert ts.backward is real  # the timer is taken off after the window
    assert line["metrics"]["backward_host_ms.train"]["value"] > 0
    assert 0 <= line["metrics"]["device_idle.train"]["value"] <= 100


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("lip2speech_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(runtime.forbidden_modules()) & {"lip2speech_torch_extra", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "lip2speech_tpu.models", sys)
    assert {"jax", "lip2speech_tpu"} <= set(runtime.forbidden_modules())


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.run, port_bench.calibrate, port_bench.loops.infer_closed, "
            "port_bench.loops.train_staged, port_bench.harness.readers\n"
            "import lip2speech_torch.models.lip2speech, lip2speech_torch.train.train_step\n"
            "from port_bench.harness.runtime import forbidden_modules; print(forbidden_modules())") % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for fname in os.listdir(ref_dir):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("lip2speech_torch", *runtime.FORBIDDEN), (fname, m)


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
                          "lrw.offline_b256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
