"""Operations of a B=256 request (the Lip2Speech forward and the BigVGAN
generator's convolutions, ``harness/vocoder_flops.py``) over its mean wall
time in the untraced window, % of the chip's peak in the serving type."""

from port_bench.harness import flops, vocoder_flops


def read(rec):
    if rec.kind != "infer" or not rec.units or "vocoder" not in rec.cell.config:
        return None
    t = rec.cell.traffic
    ops = vocoder_flops.request_flops(rec.cell.config, t["batch"], t["mel_prefix"])
    return 100.0 * ops / (rec.window_s / len(rec.units)) / flops.PEAK_FLOPS[t["precision"]]
