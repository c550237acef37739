"""AVSpeech acquisition: metadata scrape + clip download.

Counterpart of ``lip2speech_tpu/prep/avspeech_acquire.py``, with the same
behaviour:

* the AVSpeech CSV (``yt_id, start, end, face_x, face_y``) becomes a
  VidInfo work list;
* video ids are queried against the YouTube Data API v3 ``videos`` endpoint
  (``part=snippet``) in batches of 50, keeping clips whose snippet declares
  ``defaultAudioLanguage`` or ``defaultLanguage`` == the target language,
  and the surviving VidInfos are pickled after every batch;
* each clip downloads by resolving a direct stream URL (format ``22/18``,
  i.e. 720p/360p progressive mp4) and running two ffmpeg jobs over the
  remote URL: the ``[start, end]`` video cut re-encoded at 25 fps
  (libx264, crf 18, veryfast, yuv420p) and the mono 16 kHz pcm_s16le wav.

The API transport is a plain HTTPS GET and stream resolution shells out to
yt-dlp/youtube-dl. Every network and subprocess boundary is injectable, so
the logic is testable offline; live calls sit behind a reachability probe
(``prep.common.network_available``). No step here touches a device.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from lip2speech_torch.prep.common import require_network, require_ytdl, run_ffmpeg

API_ENDPOINT = "https://www.googleapis.com/youtube/v3/videos"
API_BATCH = 50  # the videos.list id cap (reference batches by 50 too)
YT_WATCH = "https://www.youtube.com/watch?v="
STREAM_FORMAT = "22/18"


@dataclass
class VidInfo:
    """One scraped clip (avspeech/preprocess.py VidInfo equivalent)."""

    yt_id: str
    start_time: float
    end_time: float
    face_point: tuple[float, float] = (0.0, 0.0)
    language: str = "en"
    out_path: str = ""

    def stem(self) -> str:
        # the corpus' file names: <id>_<start>_<end>
        return f"{self.yt_id}_{self.start_time:g}_{self.end_time:g}"


def read_avspeech_csv(csv_file: str) -> dict[str, VidInfo]:
    """AVSpeech csv rows (yt_id, start, end, face_x, face_y) -> id->VidInfo
    (later rows win per id, like the reference's dict comprehension)."""
    infos: dict[str, VidInfo] = {}
    with open(csv_file) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 3 or not parts[0]:
                continue
            face = (
                (float(parts[3]), float(parts[4])) if len(parts) >= 5 else (0.0, 0.0)
            )
            infos[parts[0]] = VidInfo(
                parts[0], float(parts[1]), float(parts[2]), face
            )
    return infos


def build_videos_request_url(video_ids: list[str], api_key: str) -> str:
    """REST URL for YouTube Data API v3 videos.list(part=snippet, id=...)."""
    assert 0 < len(video_ids) <= API_BATCH, len(video_ids)
    query = urllib.parse.urlencode(
        {"part": "snippet", "id": ",".join(video_ids), "key": api_key}
    )
    return f"{API_ENDPOINT}?{query}"


def parse_snippet_response(response: dict, language: str = "en") -> list[str]:
    """Ids whose snippet declares defaultAudioLanguage or defaultLanguage
    == ``language`` (the reference's English filter, preprocess.py:54-61).
    Language tags match on the primary subtag (``en-US`` counts as en)."""

    def lang_matches(tag) -> bool:
        return isinstance(tag, str) and tag.split("-")[0].lower() == language

    keep = []
    for item in response.get("items", []):
        snippet = item.get("snippet", {})
        if lang_matches(snippet.get("defaultAudioLanguage")) or lang_matches(
            snippet.get("defaultLanguage")
        ):
            keep.append(item["id"])
    return keep


def _fetch_json(url: str) -> dict:
    require_network("avspeech metadata scraper")
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def scrape_metadata(
    csv_file: str,
    api_key: str,
    out_pickle: str,
    language: str = "en",
    fetch_json=None,
) -> list[VidInfo]:
    """Query the API in 50-id batches, filter by language, and pickle the
    surviving VidInfo list INCREMENTALLY after each batch (matching the
    reference's resumable progress dumps, preprocess.py:44-69)."""
    fetch = fetch_json or _fetch_json
    infos = read_avspeech_csv(csv_file)
    ids = list(infos)
    kept: list[VidInfo] = []
    for i in range(0, len(ids), API_BATCH):
        batch = ids[i : i + API_BATCH]
        response = fetch(build_videos_request_url(batch, api_key))
        for y_id in parse_snippet_response(response, language):
            info = infos[y_id]
            info.language = language
            kept.append(info)
        with open(out_pickle, "wb") as f:
            pickle.dump(kept, f)
        print(f"scraped {min(i + API_BATCH, len(ids))}/{len(ids)}: "
              f"{len(kept)} {language} clips")
    return kept


# ---------------------------------------------------------------------------
# download
# ---------------------------------------------------------------------------


def resolve_stream_url(yt_id: str, run=None) -> str:
    """Direct progressive-stream URL via ``yt-dlp -g -f 22/18`` — the CLI
    equivalent of the reference's youtube_dl extract_info()['url']
    (downloader.py:25-33)."""
    if run is None:
        require_network("avspeech downloader")
        ytdl = require_ytdl()

        def run(args):
            return subprocess.run(
                args, capture_output=True, text=True, check=True, timeout=120
            ).stdout

        cmd = [ytdl]
    else:
        cmd = ["yt-dlp"]
    out = run(cmd + ["-g", "-f", STREAM_FORMAT, "--no-warnings", YT_WATCH + yt_id])
    url = out.strip().splitlines()
    if not url or not url[0].startswith("http"):
        raise RuntimeError(f"{yt_id}: no stream url resolved")
    return url[0]


def ffmpeg_cut_args(
    stream_url: str, info: VidInfo, out_dir: str, fps: int = 25, sr: int = 16000
) -> tuple[list[str], list[str]]:
    """The two ffmpeg arg lists of the reference recipe
    (downloader.py:45-49): cut [start, end] from the remote stream;
    video -> 25 fps h264 mp4 (crf 18, veryfast, yuv420p), audio -> mono
    16 kHz pcm_s16le wav. Pure function — unit-testable without ffmpeg."""
    stem = os.path.join(out_dir, info.stem())
    src = [
        "-ss", f"{info.start_time:g}", "-to", f"{info.end_time:g}",
        "-i", stream_url,
    ]
    video = src + [
        "-an", "-r", str(fps), "-c:v", "libx264", "-crf", "18",
        "-preset", "veryfast", "-pix_fmt", "yuv420p", f"{stem}.mp4",
    ]
    audio = src + ["-vn", "-ac", "1", "-ar", str(sr), "-c:a", "pcm_s16le",
                   f"{stem}.wav"]
    return video, audio


def download_clip(
    info: VidInfo,
    out_dir: str,
    fps: int = 25,
    sr: int = 16000,
    resolver=resolve_stream_url,
    run_ff=run_ffmpeg,
) -> str:
    """Resolve + cut one clip; returns the output mp4 path."""
    url = resolver(info.yt_id)
    video_args, audio_args = ffmpeg_cut_args(url, info, out_dir, fps, sr)
    run_ff(video_args)
    run_ff(audio_args)
    return os.path.join(out_dir, info.stem() + ".mp4")


def normalize_local_clip(src: str, dst_mp4: str, dst_wav: str,
                         fps: int = 25, sr: int = 16000):
    """The ffmpeg normalization recipe applied to an already-downloaded
    file: re-encode at fps, demux mono 16 kHz audio."""
    run_ffmpeg(["-i", src, "-r", str(fps), "-an", dst_mp4])
    run_ffmpeg(["-i", src, "-ac", "1", "-ar", str(sr), dst_wav])


def download_list(
    pickle_path: str, out_dir: str, workers: int = 8, download=download_clip
) -> list[str]:
    """Thread-pooled download with per-video fault tolerance (the
    reference's ThreadPool(8) + per-clip error messages,
    downloader.py:31-73). Returns the failed ids."""
    with open(pickle_path, "rb") as f:
        infos: list[VidInfo] = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    with ThreadPoolExecutor(workers) as pool:
        for info, err in zip(
            infos, pool.map(lambda v: _safe_download(v, out_dir, download), infos)
        ):
            if err is not None:
                failures.append(info.yt_id)
    print(f"{len(infos) - len(failures)}/{len(infos)} downloaded; "
          f"failures: {failures[:10]}")
    return failures


def _safe_download(info: VidInfo, out_dir: str, download) -> str | None:
    try:
        download(info, out_dir)
        return None
    except Exception as e:  # per-video fault tolerance (downloader.py:31-57)
        print(f"{info.yt_id}: {e}")
        return str(e)


def main(argv=None):
    p = argparse.ArgumentParser("avspeech acquisition")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("scrape")
    s.add_argument("--csv", required=True, help="avspeech csv (id,start,end,x,y)")
    s.add_argument("--api_key", required=True)
    s.add_argument("--out", required=True, help="output pickle (VidInfo list)")
    s.add_argument("--language", default="en")
    d = sub.add_parser("download")
    d.add_argument("--list", required=True)
    d.add_argument("--out_dir", required=True)
    d.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    if args.cmd == "scrape":
        scrape_metadata(args.csv, args.api_key, args.out, args.language)
    else:
        download_list(args.list, args.out_dir, args.workers)


if __name__ == "__main__":
    main()
