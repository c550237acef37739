"""Data of the PyTorch port: the LRW, WILD, GRID and AVSpeech readers, the
threaded loader, the synthetic fixtures and batch assembly."""

from lip2speech_torch.config import DataConfig
from lip2speech_torch.data.augmentation import FaceAugmentation  # noqa: F401
from lip2speech_torch.data.collate import collate, prepare_batch  # noqa: F401
from lip2speech_torch.data.fixtures import (make_sample_avspeech_face,  # noqa: F401
                                            make_sample_lrw, make_sample_streaming,
                                            make_sample_wild)
from lip2speech_torch.data.loader import Loader  # noqa: F401
from lip2speech_torch.data.lrw import LRW, load_jpeg_stack  # noqa: F401
from lip2speech_torch.data.streaming import GRID, AVSpeech  # noqa: F401
from lip2speech_torch.data.wild import WILD  # noqa: F401

_READERS = {"LRW": LRW, "WILD": WILD, "GRID": GRID, "AVSPEECH": AVSpeech}


def get_dataset(name: str, root: str, mode: str = "train", cfg: DataConfig | None = None, **kw):
    """The corpus ``name`` (LRW | GRID | AVSpeech | WILD) under ``root``."""
    reader = _READERS.get(name.upper())
    if reader is None:
        raise ValueError(f"unknown dataset {name}")
    return reader(root, mode=mode, cfg=cfg or DataConfig(), **kw)
