"""Data parallelism across processes in the PyTorch port: the data axis of
``lip2speech_tpu/parallel`` (``dist.py``)."""
