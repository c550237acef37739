"""Offline acquisition and preprocessing tools of the PyTorch port.

Host-side, run once per corpus; the face detector's two graphs run on its
device (CUDA unless a tool is given ``--device cpu``). Video decode uses
cv2; steps that need the ffmpeg binary (audio demux, stream segmenting)
are gated behind :func:`require_ffmpeg`, and the network boundaries of the
acquisition tools (YouTube API scrape, stream download) behind a TCP
reachability probe (:func:`common.network_available`).
"""

from lip2speech_torch.prep.common import require_ffmpeg, require_network  # noqa: F401
from lip2speech_torch.prep.face_extractor import extract_faces_for_videos  # noqa: F401
from lip2speech_torch.prep.resample import convert_sampling_rate  # noqa: F401
from lip2speech_torch.prep.speaker_preprocess import video_to_frames  # noqa: F401
from lip2speech_torch.prep.wild_preprocess import write_segment  # noqa: F401
