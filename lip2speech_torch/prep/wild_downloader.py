"""WILD corpus acquisition: download the corpus' long-form videos.

Counterpart of ``lip2speech_tpu/prep/wild_downloader.py``: the 113 lecture
video ids of the corpus (``wild_video_ids.txt``, data read by path from
the JAX package's ``prep/`` folder, never imported) go to yt-dlp or
youtube-dl with format ``22/18`` and the output template
``%(title)s-%(id)s.%(ext)s``; ``--ids`` points at any other one-id-per-line
file. The command is built by a pure function, so tests run it offline
with a mocked runner, and the live call sits behind a reachability probe
(``prep.common.network_available``).
"""

from __future__ import annotations

import argparse
import os
import subprocess

from lip2speech_torch.prep.common import require_network, require_ytdl

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_IDS = os.path.join(REPO_ROOT, "lip2speech_tpu", "prep", "wild_video_ids.txt")
STREAM_FORMAT = "22/18"
OUT_TEMPLATE = "%(title)s-%(id)s.%(ext)s"


def read_id_file(id_file: str) -> list[str]:
    with open(id_file) as f:
        return [line.strip() for line in f if line.strip()]


def ytdl_command(
    ids: list[str], out_dir: str, ytdl_bin: str = "yt-dlp"
) -> list[str]:
    """The downloader invocation (youtube_downloader.py:123-133 recipe):
    progressive mp4 (720p/360p), title-id output names, one batch call."""
    urls = [f"https://www.youtube.com/watch?v={y}" for y in ids]
    return [
        ytdl_bin,
        "-f", STREAM_FORMAT,
        "-o", os.path.join(out_dir, OUT_TEMPLATE),
        "--no-warnings",
        *urls,
    ]


def download_videos(
    id_file: str = DEFAULT_IDS, out_dir: str = ".", run=None
) -> list[str]:
    """Download every id in ``id_file`` into ``out_dir``; returns the ids.
    ``run`` is injectable for offline tests."""
    ids = read_id_file(id_file)
    print(f"{len(ids)} video ids")
    os.makedirs(out_dir, exist_ok=True)
    if run is None:
        require_network("wild youtube downloader")
        ytdl = require_ytdl()

        def run(args):
            subprocess.run(args, check=True)

        cmd = ytdl_command(ids, out_dir, ytdl)
    else:
        cmd = ytdl_command(ids, out_dir)
    run(cmd)
    return ids


def main(argv=None):
    p = argparse.ArgumentParser("WILD downloader")
    p.add_argument("--ids", default=DEFAULT_IDS,
                   help="text file, one YouTube id/line (default: the "
                        "corpus' vendored id list)")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    download_videos(args.ids, args.out_dir)


if __name__ == "__main__":
    main()
