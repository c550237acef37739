"""Evaluation of the PyTorch port: the batched forward, Griffin-Lim and the
waveform metric over a dataset, and long-video synthesis."""

from lip2speech_torch.eval.evaluate import evaluate_net  # noqa: F401
