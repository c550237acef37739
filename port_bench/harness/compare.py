"""The numbers that decide ``correct``, and the verdict against the limits.

Each number is a gap between what the program produced and what the plain
reference computes from the same inputs, per row (clip) or per leaf
(parameter tensor), reduced as the loop says. A cell's limits
(``limits/<cell>.json``) were set from readings of sound runs and of the
control (``PERF.md``); a number with no limit fails.
"""

from __future__ import annotations

import statistics


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. ``prog`` and ``ref`` map leaf names to norms."""
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {value, limit}})."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:  # a NaN reading fails
            ok = False
    return ok, checks
