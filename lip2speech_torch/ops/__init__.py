"""DSP and image ops of the PyTorch port.

The submodules keep their names as package attributes (``ops.stft``,
``ops.mel``, ``ops.griffin_lim``); only names that do not collide with them
are exported here, as ``lip2speech_tpu/ops/__init__.py`` does.
"""

from lip2speech_torch.ops import griffin_lim, mel, stft  # noqa: F401
from lip2speech_torch.ops.griffin_lim import mel_to_audio  # noqa: F401
from lip2speech_torch.ops.mel import (log_compress, log_decompress, mel_filterbank,  # noqa: F401
                                      mel_to_linear, melspectrogram)
from lip2speech_torch.ops.stft import frame_signal, hann_window, istft, spectrogram  # noqa: F401
