"""Long-video synthesis CLI on the PyTorch port: silent video of any length
-> chunked batched decode -> one Griffin-Lim pass -> waveform.

Input: ``--frames_npz``, an .npz with ``mouth`` (T, 96, 96, 3) uint8
mouth-ROI frames at 25 fps and ``faces`` (n_crops, 160, 160, 3) uint8
identity crops; or ``--from_lrw``, an LRW-format root whose first
``--n_clips`` test clips are concatenated into one long video (with the
face crops of the first). Weights: a reference ``.pth`` (``--model_path``)
or random weights made from ``--seed``.

Usage: python -m lip2speech_torch.cli.synthesize --frames_npz clip.npz --out out.wav
       python -m lip2speech_torch.cli.synthesize --from_lrw <root> --n_clips 4 --out out.wav
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lip2speech_torch import weights
from lip2speech_torch.config import Config, config_with_overrides
from lip2speech_torch.data import LRW
from lip2speech_torch.eval.long_video import synthesize_long_video
from lip2speech_torch.models.layers import resolve_device
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.ops import image as image_ops


def parse_args(argv=None):
    p = argparse.ArgumentParser("lip2speech_torch synthesize (long video)")
    p.add_argument("--frames_npz", default=None)
    p.add_argument("--from_lrw", default=None, help="LRW root; concatenates its test clips")
    p.add_argument("--n_clips", type=int, default=4, help="clips to concatenate with --from_lrw")
    p.add_argument("--model_path", default=None, help="reference .pth; random weights if absent")
    p.add_argument("--out", default="synth.wav")
    p.add_argument("--gl_iters", type=int, default=32)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--override", action="append", default=[])
    return p.parse_args(argv)


def load_model(cfg: Config, model_path: str | None, device: torch.device,
               generator: torch.Generator) -> Lip2Speech:
    """The f32 model on ``device``: reference ``.pth`` weights when given
    (the speaker encoder's part is not used here), else random weights from
    ``generator``."""
    model = Lip2Speech(cfg.model)
    if model_path:
        if not model_path.endswith(".pth"):
            raise FileNotFoundError(f"model_path {model_path!r} is not a .pth file")
        state, _ = weights.load_reference_pth(model_path)
        model.load_state_dict(state, strict=True)
    else:
        init_random_(model, generator)
    return model.to(device)


def load_frames(args, cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """(mouth (T, 96, 96, 3), faces (n_crops, 160, 160, 3)), uint8."""
    if args.frames_npz:
        data = np.load(args.frames_npz)
        return data["mouth"], data["faces"]
    if args.from_lrw:
        ds = LRW(args.from_lrw, mode="test", cfg=cfg.data)
        samples = [ds[i % len(ds)] for i in range(args.n_clips)]
        return np.concatenate([s["mouth"] for s in samples], axis=0), samples[0]["faces"]
    raise SystemExit("need --frames_npz or --from_lrw")


def main(argv=None) -> np.ndarray:
    """Writes ``--out``; returns the waveform."""
    args = parse_args(argv)
    cfg = config_with_overrides(*args.override)
    mouth_u8, faces_u8 = load_frames(args, cfg)
    device = resolve_device(args.device)
    generator = torch.Generator().manual_seed(args.seed)
    model = load_model(cfg, args.model_path, device, generator)

    video = image_ops.normalize_mouth(torch.as_tensor(mouth_u8)).numpy()
    faces = image_ops.normalize_face(torch.as_tensor(faces_u8)).numpy()
    gl_gen = torch.Generator(device=device).manual_seed(args.seed)
    wav, mel = synthesize_long_video(model, video, faces, cfg, device, gl_gen,
                                     n_gl_iters=args.gl_iters)

    from scipy.io import wavfile

    wavfile.write(args.out, cfg.audio.sample_rate, wav.astype(np.float32))
    print(f"synthesized {len(wav) / cfg.audio.sample_rate:.2f}s ({mouth_u8.shape[0]} frames -> "
          f"{mel.shape[1]} mel frames) -> {args.out}")
    return wav


if __name__ == "__main__":
    main()
