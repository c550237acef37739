"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix. The configuration's file
(``configs/<config>.json``) holds the port's ``Config`` sections as they are
run; the traffic mix is ``traffic/<traffic>.json``; the limits of the
comparison that decides ``correct`` are ``limits/<cell>.json``; each metric
is read by ``metrics/<metric>.py``. Nothing here knows any cell by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file: sections audio, model, data, train
    traffic: dict       # the traffic file
    limits: dict        # check name -> limit
    end_to_end: list    # the cell's end-to-end metric entries of BENCHMARK.json
    per_layer: list     # the cell's per-layer metric entries


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: str | None = None) -> Cell:
    bench = _read(bench_file or os.path.join(ROOT, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read(os.path.join(ROOT, conf["file"])),
        traffic=_read(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        limits=_read(os.path.join(BENCH_DIR, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def port_config(conf: dict):
    """The port's ``Config`` built from a configuration file's sections."""
    from lip2speech_torch.config import AudioConfig, Config, DataConfig, ModelConfig, TrainConfig

    def section(cls, key):
        values = {k: tuple(v) if isinstance(v, list) else v for k, v in conf[key].items()}
        return cls(**values)

    return Config(audio=section(AudioConfig, "audio"), model=section(ModelConfig, "model"),
                  data=section(DataConfig, "data"), train=section(TrainConfig, "train"))


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read`` function."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_module(kind: str):
    """``loops/<kind>.py``: the loop that drives a traffic mix's kind."""
    return importlib.import_module(f"port_bench.loops.{kind}")
