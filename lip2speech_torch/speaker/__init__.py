"""Speaker-encoder pretraining in the PyTorch port: the AVSpeechFace data,
the face and speaker decoders, the losses and the training step."""

from lip2speech_torch.speaker.dataset import AVSpeechFace, collate_speaker  # noqa: F401
from lip2speech_torch.speaker.losses import (contrastive_loss,  # noqa: F401
                                             reconstruction_loss, style_loss)
from lip2speech_torch.speaker.models import (FaceDecoder, FaceRecognizer,  # noqa: F401
                                             SpeakerDecoder, SpeakerEncoder, get_network)
from lip2speech_torch.speaker.train_loop import (SpeakerTraining,  # noqa: F401
                                                 SpeakerTrainState, create_speaker_state,
                                                 init_speaker_training, speaker_train_step)
