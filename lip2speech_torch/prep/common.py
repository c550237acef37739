"""Shared plumbing for the offline tools: the ffmpeg, network and
yt-dlp gates, and ``extract_wav``. Counterpart of
``lip2speech_tpu/prep/common.py``."""

from __future__ import annotations

import shutil
import subprocess


def require_ffmpeg() -> str:
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError(
            "this preprocessing step needs the ffmpeg binary (audio demux/"
            "segmenting); install ffmpeg or run it on a host that has it"
        )
    return path


def network_available(
    host: str = "www.youtube.com", port: int = 443, timeout: float = 3.0
) -> bool:
    """Genuine reachability probe (the require_ffmpeg pattern): can we
    open a TCP connection to the acquisition endpoint?"""
    import socket

    try:
        socket.create_connection((host, port), timeout=timeout).close()
        return True
    except OSError:
        return False


def require_network(tool: str, probe=network_available):
    if not probe():
        raise RuntimeError(
            f"{tool} needs network access (YouTube APIs) and the probe to "
            "www.youtube.com:443 failed — run the acquisition tools on a "
            "connected host"
        )


def require_ytdl() -> str:
    """Locate a youtube downloader binary (yt-dlp or youtube-dl)."""
    for name in ("yt-dlp", "youtube-dl"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "acquisition needs yt-dlp or youtube-dl on PATH to resolve YouTube "
        "stream URLs (reference: datasets/avspeech/downloader.py uses the "
        "youtube_dl package)"
    )


def run_ffmpeg(args: list[str]):
    ff = require_ffmpeg()
    subprocess.run([ff, "-loglevel", "error", "-y", *args], check=True)


def extract_wav(video_path: str, wav_path: str, sr: int = 16000):
    """mp4/mov -> mono 16 kHz wav (lrw/preprocess.py:28-40 equivalent)."""
    run_ffmpeg(["-i", video_path, "-ac", "1", "-ar", str(sr), wav_path])
