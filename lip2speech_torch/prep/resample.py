"""Rewrite any non-16 kHz wav in place at 16 kHz.

Counterpart of ``lip2speech_tpu/prep/resample.py``: scipy polyphase
resampling of every ``.wav`` under a root, read with the port's
``data.wild.load_wav``. Host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from lip2speech_torch.data.wild import load_wav

TARGET_SR = 16000


def convert_sampling_rate(root: str, target_sr: int = TARGET_SR) -> int:
    converted = 0
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".wav"):
                continue
            path = os.path.join(dirpath, fn)
            sr, data = load_wav(path)
            if sr == target_sr:
                continue
            g = np.gcd(int(sr), target_sr)
            out = resample_poly(data, target_sr // g, sr // g)
            wavfile.write(path, target_sr, out.astype(np.float32))
            converted += 1
    return converted


def main(argv=None):
    p = argparse.ArgumentParser("resample wavs to 16 kHz")
    p.add_argument("--root", required=True)
    args = p.parse_args(argv)
    print(f"converted {convert_sampling_rate(args.root)} files")


if __name__ == "__main__":
    main()
