"""The anti-aliased activations' least time a request over their device ms,
%. The least time is the larger of their operations over the chip's peak
and their bytes over its memory bandwidth, each activation's input read
once and its output written once in the serving type
(``harness/vocoder_flops.activation_work``); the bytes bound it."""

from port_bench.harness import flops, readers, vocoder_flops


def read(rec):
    ms = readers.range_device_ms(rec, "vocoder.activation")
    if not ms or "vocoder" not in rec.cell.config:
        return None
    t = rec.cell.traffic
    elem_bytes = 2 if t["precision"] == "bfloat16" else 4
    ops, nbytes = vocoder_flops.activation_work(rec.cell.config["vocoder"], t["batch"], t["mel_prefix"],
                                                elem_bytes)
    return 100.0 * flops.least_seconds(ops, nbytes, t["precision"]) / (ms / 1e3)
