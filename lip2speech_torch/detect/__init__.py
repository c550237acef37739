"""The face detector of the PyTorch port: RFB-320 boxes and 68-point
landmarks from the repo's trained weights, the two graphs run with torch
ops on a device."""

from lip2speech_torch.detect.face_detector import (FaceDetector, hard_nms,  # noqa: F401
                                                   iou_matrix, nms_torch)
from lip2speech_torch.detect.onnx_torch import make_runner as make_onnx_runner  # noqa: F401
from lip2speech_torch.detect.openvino_torch import make_ir_runner  # noqa: F401
