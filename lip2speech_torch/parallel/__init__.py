"""Parallelism across processes in the PyTorch port: the rank grid and the
data axis of ``lip2speech_tpu/parallel`` (``dist.py``), and its tensor
parallelism (``tensor.py``)."""

from lip2speech_torch.parallel.tensor import TP_RULES, partition_params  # noqa: F401
