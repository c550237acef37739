"""Quality-metric registry.

Counterpart of ``lip2speech_tpu/eval/metrics.py``. ESTOI and STOI are the
port's own (``ops/estoi``). PESQ resolves to the ``pesq`` wheel when it
imports and raises :class:`MetricUnavailable` with the install command
otherwise. ``word_error_rate`` is an edit-distance WER; ``make_transcriber``
turns a local CTC ASR checkpoint into the transcripts WER needs, importing
``transformers`` only when called.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Sequence

import numpy as np


class MetricUnavailable(RuntimeError):
    """A metric whose implementation is not installed here; the message
    carries the command that installs it."""


_INSTALL = {
    "pesq": "pip install pesq  # ITU-T P.862 reference wrapper",
    "pystoi": "pip install pystoi==0.3.3  # the reference's pinned version",
    "asr": ("download a CTC ASR checkpoint (e.g. facebook/wav2vec2-base-960h) "
            "and set LIP2SPEECH_ASR_MODEL=/path/to/it"),
}


def _has(mod: str) -> bool:
    return importlib.util.find_spec(mod) is not None


def _asr_model_path(model_path: str | None = None) -> str | None:
    p = model_path or os.environ.get("LIP2SPEECH_ASR_MODEL")
    return p if p and os.path.exists(p) else None


def registry(asr_model_path: str | None = None) -> dict[str, dict]:
    """Each metric's status: {name: {available, via, note}}."""
    asr = _asr_model_path(asr_model_path)
    native = {"available": True, "via": "lip2speech_torch.ops.estoi", "note": None}
    return {
        "estoi": dict(native),
        "stoi": dict(native),
        "pesq": {
            "available": _has("pesq"),
            "via": "pesq wheel (ITU-T P.862)" if _has("pesq") else None,
            "note": None if _has("pesq") else f"awaiting wheel: {_INSTALL['pesq']}",
        },
        "wer": {
            "available": asr is not None,
            "via": f"edit-distance WER + local ASR at {asr}" if asr else None,
            "note": None if asr else ("word_error_rate() is built in; transcription is "
                                      f"awaiting weights: {_INSTALL['asr']}"),
        },
    }


def compute_pesq(clean: np.ndarray, pred: np.ndarray, fs: int = 16000) -> float:
    """PESQ through the ``pesq`` wheel: wide-band at 16 kHz, else narrow-band."""
    try:
        from pesq import pesq as _pesq
    except ImportError as e:
        raise MetricUnavailable(f"PESQ needs the ITU reference wrapper: {_INSTALL['pesq']}") from e
    mode = "wb" if fs == 16000 else "nb"
    return float(_pesq(fs, np.asarray(clean, np.float64), np.asarray(pred, np.float64), mode))


def get_waveform_metric(name: str) -> Callable[[np.ndarray, np.ndarray, int], float]:
    """``f(clean, pred, fs) -> float`` for 'estoi' | 'stoi' | 'pesq'; raises
    :class:`MetricUnavailable` when the metric's implementation is absent."""
    if name in ("estoi", "stoi"):
        from lip2speech_torch.ops import estoi as estoi_ops

        return getattr(estoi_ops, name)
    if name == "pesq":
        if not _has("pesq"):
            raise MetricUnavailable(f"PESQ is awaiting its wheel: {_INSTALL['pesq']}")
        return compute_pesq
    raise KeyError(f"unknown waveform metric {name!r}")


def _tokens(x: str | Sequence[str]) -> list[str]:
    return x.split() if isinstance(x, str) else list(x)


def word_error_rate(reference: str | Sequence[str], hypothesis: str | Sequence[str]) -> float:
    """Levenshtein WER: (S + D + I) / reference words. An empty reference
    scores 0 for an empty hypothesis, else one error per inserted word."""
    ref, hyp = _tokens(reference), _tokens(hypothesis)
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1] / len(ref)


def make_transcriber(model_path: str | None = None, fs: int = 16000) -> Callable[[np.ndarray], str]:
    """A local HuggingFace CTC ASR checkpoint (``model_path`` or
    ``$LIP2SPEECH_ASR_MODEL``) as ``wav -> text``."""
    path = _asr_model_path(model_path)
    if path is None:
        raise MetricUnavailable(f"WER transcription is {_INSTALL['asr']}")
    import torch
    from transformers import AutoModelForCTC, AutoProcessor

    processor = AutoProcessor.from_pretrained(path)
    model = AutoModelForCTC.from_pretrained(path).eval()

    def transcribe(wav: np.ndarray) -> str:
        inputs = processor(np.asarray(wav, np.float32), sampling_rate=fs, return_tensors="pt")
        with torch.no_grad():
            logits = model(inputs.input_values).logits
        return processor.batch_decode(logits.argmax(dim=-1))[0].strip()

    return transcribe
