"""Seeds for the parts of one run, all derived from ``--seed``."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, part: str) -> int:
    """A 63-bit seed for ``part`` (weights, inputs, draws, sample) of the
    run with ``seed``; any whole number of any size is a seed."""
    words = [int(w) for w in np.frombuffer(int(seed).to_bytes(16, "little", signed=True), np.uint32)]
    ss = np.random.SeedSequence(words + [zlib.crc32(part.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def rng(seed: int, part: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, part))
