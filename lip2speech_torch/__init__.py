"""PyTorch/CUDA port of lip2speech_tpu: inference from mouth video to
waveform, training, evaluation, the corpora, speaker pretraining, the face
detector and the preprocessing tools.

Imports torch, numpy and scipy only; nothing of JAX or of lip2speech_tpu.
"""

from lip2speech_torch.config import Config, default_config  # noqa: F401
