"""Per-model file logger.

Counterpart of ``lip2speech_tpu/utils/logger.py``: each model gets a
directory keyed by the md5 of its architecture repr; the logger appends to
the newest ``.log`` there (or creates a dated one) and on creation dumps
the model's defining source, so every run records the architecture it
trained.
"""

from __future__ import annotations

import hashlib
import inspect
import logging
import os
import time


def model_hash(model) -> str:
    return hashlib.md5(repr(model).encode()).hexdigest()


def setup_logger(model, base_dir: str = "savedmodels") -> tuple[logging.Logger, str]:
    """Returns (logger, model_dir)."""
    mdir = os.path.join(base_dir, model_hash(model))
    os.makedirs(mdir, exist_ok=True)

    logs = sorted(
        (f for f in os.listdir(mdir) if f.endswith(".log")),
        key=lambda f: os.path.getmtime(os.path.join(mdir, f)),
    )
    fresh = not logs
    logfile = os.path.join(
        mdir, logs[-1] if logs else time.strftime("%Y-%m-%d-%H-%M-%S.log")
    )

    logger = logging.getLogger(f"lip2speech.{model_hash(model)[:8]}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())

    if fresh:
        try:
            src = inspect.getsource(type(model))
        except (OSError, TypeError):
            src = repr(model)
        logger.info("MODEL SOURCE:\n%s", src)
    return logger, mdir
