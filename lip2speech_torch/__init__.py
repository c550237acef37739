"""PyTorch/CUDA port of lip2speech_tpu: inference from mouth video to
waveform, and the training step.

Imports torch, numpy and scipy only; nothing of JAX or of lip2speech_tpu.
"""
