"""Set-up: process start to the first timed unit, s (host clock)."""


def read(rec):
    return rec.setup_s
