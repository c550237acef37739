"""Models of the PyTorch port: the video encoder, the face net, the decoder,
the WGAN critic, the voice encoder, the whole network and the BigVGAN
vocoder."""

from lip2speech_torch.models import layers  # noqa: F401
from lip2speech_torch.models.decoder import ContentEncoder, Decoder, MultiHopConv, Postnet  # noqa: F401
from lip2speech_torch.models.discriminator import Discriminator, sample_patch  # noqa: F401
from lip2speech_torch.models.face import FaceRecognizer, InceptionResnetV1  # noqa: F401
from lip2speech_torch.models.lip2speech import Lip2Speech, get_network  # noqa: F401
from lip2speech_torch.models.shufflenet import ShuffleNetV2Trunk  # noqa: F401
from lip2speech_torch.models.speaker import SpeakerEncoder  # noqa: F401
from lip2speech_torch.models.video import VideoExtractor  # noqa: F401
from lip2speech_torch.models.vocoder import BigVGAN  # noqa: F401
