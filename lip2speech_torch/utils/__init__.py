from lip2speech_torch.utils.logger import model_hash, setup_logger  # noqa: F401
