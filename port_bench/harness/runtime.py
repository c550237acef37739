"""What every run does around its loop: the chip check, the record of a
run, the check for JAX in the process, and the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lip2speech_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Record:
    """One run's measurements, as the metric readers see them."""

    kind: str                       # the loop's kind
    cell: object                    # spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    units: list = dataclasses.field(default_factory=list)   # (start s, end s, clips, ok) in the window
    memory_peak_bytes: int = 0
    correct: bool = False
    checks: dict = dataclasses.field(default_factory=dict)
    trace: object = None            # tracing.Summary of the traced window
    trace_units: int = 0            # units inside the traced window
    host_spans: dict = dataclasses.field(default_factory=dict)  # span -> host s of each call (traced runs)
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.units)

    @property
    def failed(self) -> int:
        return sum(1 for u in self.units if not u[3])

    @property
    def clips_ok(self) -> int:
        return sum(u[2] for u in self.units if u[3])

    @property
    def latencies_ms(self) -> list[float]:
        return [(u[1] - u[0]) * 1e3 for u in self.units]


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def no_tf32():
    """A block whose f32 products and convolutions run in full f32, as the
    plain reference states them."""
    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def require_chips(chips: int):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def emit(rec: Record, metrics: dict, device: dict, breakdown: dict | None):
    """The comparisons on the last lines of stderr, then the result line."""
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in rec.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = rec.checks
    print(json.dumps(line), flush=True)
