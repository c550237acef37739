"""A cell at a size the CPU runs in seconds, for the benchmark's tests."""

from __future__ import annotations

import copy
import json
import os

from port_bench.harness import spec

TINY_MODEL = dict(max_decoder_steps=24, ffn_hidden_dim=64, content_latent_dim=32, postnet_embedding_dim=64,
                  shufflenet_width=0.5)
TINY_DATA = dict(max_video_frames=8, max_mel_frames=16, max_audio_samples=15 * 256)
TINY_TRAFFIC = dict(batch=2, pool=4, mel_prefix=16, gl_iters=4, check_requests=2, check_rows=2, trace_units=1)


def tiny_cell(name: str, precision: str = "float32", limits: dict | None = None) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json at the tiny size."""
    cell = spec.load_cell(name)
    conf = copy.deepcopy(cell.config)
    conf["model"].update(TINY_MODEL)
    conf["data"].update(TINY_DATA)
    conf["train"]["bf16"] = precision == "bfloat16"
    traffic = dict(cell.traffic, precision=precision)
    traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
    cell.config, cell.traffic = conf, traffic
    if limits is not None:
        cell.limits = limits
    return cell


def cell_limits(name: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, "limits", f"{name}.json")) as f:
        return json.load(f)
