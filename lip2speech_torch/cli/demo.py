"""Demo CLI: free-running inference on test clips, waveforms and PNGs out.

Counterpart of ``lip2speech_tpu/cli/demo.py``: for each of the first
``--n_clips`` test clips (batch 1, in order), the model decodes its 300
steps (the AR kernel on the card), and the clip writes
``<out>/clip{i}_gt.wav`` (the recording), ``clip{i}_gt_gl.wav`` (its mel
through the vocoder: NNLS + Griffin-Lim, or BigVGAN under ``--override
vocoder.kind=bigvgan``, from ``--vocoder_checkpoint``), ``clip{i}_pred.wav`` (the prediction, cut at
the gate's stop) and the ``mel_predicted``, ``mel_target``, ``alignment``
and ``gate`` PNGs. The speaker conditioning comes from the face crop
(``--encoding face``) or from the recording through the voice
``SpeakerEncoder`` (``--encoding voice``), whose weights are the
``speaker_encoder.*`` part of a reference ``.pth`` or, without one, random
from ``train.seed``.

Usage: python -m lip2speech_torch.cli.demo --root <LRW root> [--encoding voice] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from scipy.io import wavfile

from lip2speech_torch.cli.common import add_common_args, common_config, load_model, load_vocoder
from lip2speech_torch.data import Loader, get_dataset
from lip2speech_torch.data.collate import prepare_batch, to_device
from lip2speech_torch.models.layers import resolve_device
from lip2speech_torch.models.lip2speech import init_random_
from lip2speech_torch.models.speaker import SpeakerEncoder
from lip2speech_torch.models.vocoder import mel_to_waveform
from lip2speech_torch.train.logging_utils import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser("lip2speech_torch demo")
    add_common_args(p)
    p.add_argument("--encoding", choices=("face", "voice"), default="face")
    p.add_argument("--n_clips", type=int, default=4)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--gl_iters", type=int, default=64)
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Runs the demo; returns, for each clip, its stop step, the predicted
    waveform's length and the clip's wall time in ms (batch preparation to
    written files)."""
    args = parse_args(argv)
    cfg = common_config(args)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    ds = get_dataset(args.dataset, args.root, mode="test", cfg=cfg.data)
    model, speaker_sd = load_model(cfg, args.model_path, device)
    vocoder = load_vocoder(cfg, args.vocoder_checkpoint, device)
    logger = MetricLogger(args.out, tensorboard=False)

    speaker = None
    if args.encoding == "voice":
        speaker = SpeakerEncoder(cfg.model)
        if speaker_sd:
            speaker.load_state_dict(speaker_sd, strict=True)
            print("loaded speaker_encoder weights from combined checkpoint")
        else:
            init_random_(speaker, torch.Generator().manual_seed(cfg.train.seed))
        speaker = speaker.to(device).eval()

    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
    sr, hop = cfg.audio.sample_rate, cfg.audio.hop_length
    loader = iter(Loader(ds, 1, cfg.data, shuffle=False, drop_last=False, num_workers=2,
                         pin_memory=device.type == "cuda"))
    clips = []
    try:
        for i, raw in zip(range(args.n_clips), loader):
            t0 = time.perf_counter()
            batch = prepare_batch(to_device(raw, device), cfg.audio, cfg.data)
            with torch.no_grad():
                spk = None if speaker is None else speaker.inference(batch["audio"])
                out = model(batch["video"], batch["faces"], speaker_embedding=spk, generator=gen)
                wav_pred = mel_to_waveform(out["mel_postnet"], cfg, vocoder, n_iter=args.gl_iters,
                                           generator=gen)
                n_gt = int(raw["audio_lengths"][0])
                wav_gt = mel_to_waveform(batch["mel"][0], cfg, vocoder, n_iter=args.gl_iters,
                                         generator=gen)[:n_gt]
            n_steps = int(out["lengths"][0])
            wav_pred = wav_pred[0, : n_steps * hop].cpu().numpy()
            gt = np.asarray(raw["audio"])[0, :n_gt]
            wavfile.write(f"{args.out}/clip{i}_gt.wav", sr, gt.astype(np.float32))
            wavfile.write(f"{args.out}/clip{i}_gt_gl.wav", sr, wav_gt.cpu().numpy().astype(np.float32))
            wavfile.write(f"{args.out}/clip{i}_pred.wav", sr, wav_pred.astype(np.float32))
            logger.images(i, mel_pred=out["mel_postnet"][0], mel_target=batch["mel"][0],
                          attention=out["attention"][0].T,
                          gate=torch.sigmoid(out["gate"][0].float().reshape(-1)))
            ms = (time.perf_counter() - t0) * 1e3
            print(f"clip {i}: stop at step {n_steps}/{cfg.model.max_decoder_steps}, "
                  f"wrote {args.out}/clip{i}_pred.wav ({ms:.1f} ms)")
            clips.append({"stop_step": n_steps, "pred_samples": len(wav_pred), "ms": ms})
    finally:
        loader.close()
        logger.close()
    return clips


if __name__ == "__main__":
    main()
