"""Thread-safe random generator for datasets.

Counterpart of ``lip2speech_tpu/data/rng.py``. ``Loader`` maps
``dataset.__getitem__`` over a thread pool, so a dataset's
``np.random.Generator`` is drawn from by many threads at once, and numpy's
``Generator`` is not thread-safe: concurrent draws race on its state.
``LockedRng`` serialises every method call on the wrapped generator. Which
clip gets which draw still depends on thread timing when more than one
worker runs; a run that must be reproducible uses one worker.
"""

from __future__ import annotations

import threading

import numpy as np


class LockedRng:
    """Proxy around ``np.random.Generator`` that guards every call."""

    def __init__(self, gen: np.random.Generator | None = None):
        self._gen = gen if gen is not None else np.random.default_rng(0)
        self._lock = threading.Lock()

    def __getattr__(self, name: str):
        attr = getattr(self._gen, name)
        if not callable(attr):
            return attr

        def locked(*args, **kwargs):
            with self._lock:
                return attr(*args, **kwargs)

        return locked
