"""Training of the PyTorch port: the train step, its optimizer, the losses,
the adversarial mode, checkpoints and logging."""

from lip2speech_torch.train.losses import (clamp_discriminator_params,  # noqa: F401
                                           discriminator_loss, generator_loss,
                                           gradient_penalty, lip2speech_loss)
from lip2speech_torch.train.train_step import TrainState, create_train_state, train_step  # noqa: F401
