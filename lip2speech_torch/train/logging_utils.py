"""Training observability.

Counterpart of ``lip2speech_tpu/train/logging_utils.py``:

- scalars appended as JSON lines (``metrics.jsonl``) with the wall time
  since the logger started and since the previous record (``step_time``);
- TensorBoard event files through ``torch.utils.tensorboard`` when it
  imports;
- console lines with an ETA;
- per-layer parameter histograms at eval ticks (summary statistics in
  ``histograms.jsonl``, full histograms in TensorBoard);
- mel, attention and gate PNGs drawn with cv2, which the data path already
  needs (no plotting library is required);
- ``profile_steps``: a ``torch.profiler`` capture around chosen steps.

A logger made with ``enabled=False`` (a data-parallel rank other than 0)
writes and prints nothing.
"""

from __future__ import annotations

import json
import os
import time

import cv2
import numpy as np
import torch


def _make_tb_writer(run_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(run_dir, "tb"))


class MetricLogger:
    def __init__(self, run_dir: str, tensorboard: bool = True, enabled: bool = True):
        self.run_dir = run_dir
        self.enabled = enabled
        if enabled:
            os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self.tb = _make_tb_writer(run_dir) if tensorboard and enabled else None
        self._t0 = time.time()
        self._last = self._t0

    def scalars(self, step: int, values: dict, prefix: str = "") -> dict:
        now = time.time()
        rec = {"step": step, "time": now - self._t0, "step_time": now - self._last,
               **{f"{prefix}{k}": float(v) for k, v in values.items()}}
        self._last = now
        if not self.enabled:
            return rec
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}{k}", float(v), step)
        return rec

    def histograms(self, step: int, named_params, named_grads=None) -> dict:
        """Per-layer statistics of ``named_params`` (and ``named_grads``),
        each an iterable of (name, tensor) or a dict, as one line of
        ``histograms.jsonl``; full histograms of the finite values in
        TensorBoard."""
        if not self.enabled:
            return {}
        tensors = {}
        for tag, named in (("param", named_params), ("grad", named_grads)):
            if named is None:
                continue
            items = named.items() if isinstance(named, dict) else named
            for name, x in items:
                tensors[f"{tag}/{name}"] = x.detach().double().cpu().numpy()
        stats = {}
        for name, a in tensors.items():
            a = a.ravel()
            finite = a[np.isfinite(a)]
            stats[name] = {"mean": float(a.mean()), "std": float(a.std()), "min": float(a.min()),
                           "max": float(a.max()), "rms": float(np.sqrt(np.mean(a * a))),
                           "nonfinite": int(a.size - finite.size)}
            # TensorBoard's histogram raises without a finite value
            if self.tb is not None and finite.size:
                self.tb.add_histogram(name, finite, step)
        with open(os.path.join(self.run_dir, "histograms.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, "layers": stats}) + "\n")
        return stats

    def console(self, step: int, values: dict, total_steps: int | None = None):
        if not self.enabled:
            return
        msg = f"[{step}] " + " ".join(f"{k}={float(v):.4f}" for k, v in values.items())
        if total_steps:
            rate = step / max(time.time() - self._t0, 1e-9)
            msg += f" eta={(total_steps - step) / max(rate, 1e-9) / 3600:.1f}h"
        print(msg, flush=True)

    def images(self, step: int, mel_pred=None, mel_target=None, attention=None, gate=None):
        """PNGs of a predicted and a target mel (n_mels, M), an attention map
        (M, T), each as a heat map with row 0 at the bottom, and a gate
        curve (M,); arrays or tensors. Files are ``<name>_<step>.png``."""
        if not self.enabled:
            return

        def arr(x):
            return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        def unit(a):
            a = a.astype(np.float32)
            return (a - a.min()) / max(float(a.max() - a.min()), 1e-9)

        def save(a, name):
            a = unit(a)
            img = cv2.applyColorMap((a[::-1] * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)
            scale = max(1, 640 // img.shape[1]), max(1, 240 // img.shape[0])
            img = cv2.resize(img, (img.shape[1] * scale[0], img.shape[0] * scale[1]),
                             interpolation=cv2.INTER_NEAREST)
            cv2.imwrite(os.path.join(self.run_dir, f"{name}_{step}.png"), img)
            if self.tb is not None:
                self.tb.add_image(name, a[None], step)

        if mel_pred is not None:
            save(arr(mel_pred), "mel_predicted")
        if mel_target is not None:
            save(arr(mel_target), "mel_target")
        if attention is not None:
            save(arr(attention), "alignment")
        if gate is not None:
            g = unit(arr(gate).reshape(-1))
            h, w = 160, 640
            img = np.full((h, w, 3), 255, np.uint8)
            x = np.linspace(0, w - 1, len(g)) if len(g) > 1 else np.zeros(1)
            pts = np.stack([x, (h - 1) * (1.0 - g)], axis=1).round().astype(np.int32)
            cv2.polylines(img, [pts[:, None, :]], False, (180, 80, 0), 1)
            cv2.imwrite(os.path.join(self.run_dir, f"gate_{step}.png"), img)

    def close(self):
        if self.tb is not None:
            self.tb.close()


def profile_steps():
    """A ``torch.profiler.profile`` context over the card's kernels, or the
    host's ops where there is no card; the profile is the context's value
    (``key_averages()`` for the table, ``export_chrome_trace`` for the
    timeline). Host ops are not recorded beside the card's kernels: with a
    loader's threads running, recording them stretches the step."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
