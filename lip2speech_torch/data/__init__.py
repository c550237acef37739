"""Data of the PyTorch port: the LRW reader, the threaded loader, the
synthetic fixture and batch assembly."""

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.augmentation import FaceAugmentation  # noqa: F401
from lip2speech_torch.data.fixtures import make_sample_lrw  # noqa: F401
from lip2speech_torch.data.loader import Loader  # noqa: F401
from lip2speech_torch.data.lrw import LRW, load_jpeg_stack  # noqa: F401

# corpora whose readers are not ported yet (ROADMAP.md, queue 2)
_LATER = {"WILD": "data/wild.py", "GRID": "data/streaming.py", "AVSPEECH": "data/streaming.py"}


def get_dataset(name: str, root: str, mode: str = "train", cfg: DataConfig | None = None, **kw):
    """The corpus ``name`` (LRW | GRID | AVSpeech | WILD) under ``root``."""
    cfg = cfg or DataConfig()
    key = name.upper()
    if key == "LRW":
        return LRW(root, mode=mode, cfg=cfg, **kw)
    if key in _LATER:
        raise NotImplementedError(
            f"the {name} reader ({_LATER[key]} in the JAX package) is not ported yet: "
            "ROADMAP.md, queue 2")
    raise ValueError(f"unknown dataset {name}")
