"""Face detection and the 68-point landmarks, the two graphs on a device.

Counterpart of ``lip2speech_tpu/detect/face_detector.py``. The RFB-320
detector (an ONNX graph, ``onnx_torch``) runs batched over all frames of a
call and the landmark regressor (an OpenVINO IR, ``openvino_torch``) once
per frame with a face, both on the detector's device (CUDA unless the
caller names another) under ``torch.no_grad()``. Everything around them
stays on the host exactly as in the JAX package: the cv2 ``INTER_CUBIC``
resize of the float32 frames, the ``(x - 127) / 128`` scaling, the greedy
NMS (``hard_nms``), the face selection, the square-padded landmark crop
and the integer truncation of boxes and landmarks. ``nms_torch`` is the
static-shape NMS on a device (the JAX package's ``nms_jax``).
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import torch

from lip2speech_torch.models.layers import resolve_device

MODEL_DIR_ENV = "LIP2SPEECH_DETECTOR_DIR"
IOU_THRESHOLD = 0.3


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for (N,4)/(M,4) corner-form boxes."""
    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(boxes_a[:, 2:] - boxes_a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(boxes_b[:, 2:] - boxes_b[:, :2], 0, None), -1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def hard_nms(box_probs: np.ndarray, iou_threshold: float = IOU_THRESHOLD,
             top_k: int = -1, candidate_size: int = 200) -> np.ndarray:
    """Greedy NMS on (N,5) [x1,y1,x2,y2,score] on the host."""
    order = np.argsort(box_probs[:, 4])[-candidate_size:]
    picked = []
    while order.size:
        idx = order[-1]
        picked.append(idx)
        if 0 < top_k == len(picked) or order.size == 1:
            break
        order = order[:-1]
        ious = iou_matrix(box_probs[order, :4], box_probs[idx : idx + 1, :4])[:, 0]
        order = order[ious <= iou_threshold]
    return box_probs[picked]


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              score_threshold: float, max_out: int = 32):
    """Static-shape greedy NMS on the tensors' device, the counterpart of the
    JAX package's ``nms_jax``: returns (boxes (max_out,4), scores
    (max_out,), valid mask), with no read back to the host."""
    scores = torch.where(scores >= score_threshold, scores, -1.0)

    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = torch.prod(torch.clamp(boxes[:, 2:] - boxes[:, :2], min=0), -1)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)

    live = scores
    ids, kept = [], []
    for _ in range(max_out):
        idx = torch.argmax(live)
        score = live[idx]
        live = torch.where(iou[idx] > iou_threshold, -1.0, live)
        live = live.index_fill(0, idx.reshape(1), -1.0)
        ids.append(idx)
        kept.append(torch.where(score > 0, score, -1.0))
    ids, kept = torch.stack(ids), torch.stack(kept)
    return boxes[ids], kept, kept > 0


class FaceDetector:
    """frames (N, H, W, 3) RGB uint8 -> per frame (box, 68x2 landmarks).

    The centre face by default; with ``target_face_embedding`` and
    ``face_embed_fn``, the face nearest the target embedding."""

    def __init__(
        self,
        model_dir: str | None = None,
        threshold: float = 0.9,
        target_face_embedding: np.ndarray | None = None,
        face_embed_fn=None,
        device=None,
    ):
        """Weight resolution order: explicit ``model_dir`` (the
        ``version-RFB-320.onnx`` and ``mobilefacenet.xml``/``.bin`` files) >
        $LIP2SPEECH_DETECTOR_DIR > the repo's ``.npz`` artifacts
        (``artifacts.py``). ``device`` is CUDA unless the caller names
        another; without CUDA that raises."""
        from lip2speech_torch.detect import artifacts
        from lip2speech_torch.detect.onnx_reader import load_onnx
        from lip2speech_torch.detect.onnx_torch import graph_runner
        from lip2speech_torch.detect.openvino_torch import ir_runner, load_ir

        self.device = resolve_device(device)
        model_dir = model_dir or os.environ.get(MODEL_DIR_ENV)
        if model_dir is None:
            if not os.path.exists(artifacts.RFB320_NPZ):
                raise FileNotFoundError(
                    f"no detector weights: {artifacts.RFB320_NPZ} is missing; pass "
                    f"model_dir or set ${MODEL_DIR_ENV}")
            graph = artifacts.load_onnx_npz(artifacts.RFB320_NPZ)
            layers, consts = artifacts.load_ir_npz(artifacts.MOBILEFACENET_NPZ)
        else:
            graph = load_onnx(os.path.join(model_dir, "version-RFB-320.onnx"))
            layers, consts = load_ir(os.path.join(model_dir, "mobilefacenet.xml"),
                                     os.path.join(model_dir, "mobilefacenet.bin"))
        self.detect_fn = graph_runner(graph, self.device)
        self.landmark_fn, _ = ir_runner(layers, consts, self.device)
        self.threshold = threshold
        self.target_face_embedding = target_face_embedding
        self.face_embed_fn = face_embed_fn

    @staticmethod
    def detector_input(frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) frames -> the detector's (N, 3, 240, 320) f32 input."""
        x = (frames.astype(np.float32) - 127.0) / 128.0
        x = np.stack([cv2.resize(f, (320, 240), interpolation=cv2.INTER_CUBIC) for f in x])
        return x.transpose(0, 3, 1, 2)

    def __call__(self, frames: np.ndarray):
        n, H, W, _ = frames.shape
        out = self.detect_fn(torch.from_numpy(np.ascontiguousarray(self.detector_input(frames))))
        confidences = out["scores"].cpu().numpy()  # (N, P, 2)
        boxes_all = out["boxes"].cpu().numpy()  # (N, P, 4) normalized

        results = []
        for i in range(n):
            probs = confidences[i, :, 1]
            mask = probs > self.threshold
            if not mask.any():
                results.append(None)
                continue
            bp = np.concatenate([boxes_all[i, mask], probs[mask, None]], axis=1)
            picked = hard_nms(bp, IOU_THRESHOLD)
            boxes = (picked[:, :4] * [W, H, W, H]).astype(np.int32)

            box = self._select_box(frames[i], boxes, W, H)
            if box is None:
                results.append(None)
                continue
            lm = self._landmarks(frames[i], box)
            box = np.clip(np.asarray(box, np.int64), 0, None)
            results.append([box, lm.astype(np.int64)])
        return results

    def _select_box(self, frame, boxes, W, H):
        if self.target_face_embedding is not None and self.face_embed_fn is not None:
            embs = []
            for b in boxes:
                x1, y1, x2, y2 = b
                crop = frame[max(y1, 0) : y2, max(x1, 0) : x2]
                if crop.size == 0:
                    embs.append(None)
                    continue
                embs.append(self.face_embed_fn(crop))
            dists = np.array(
                [np.linalg.norm(self.target_face_embedding - e) if e is not None else 1e9
                 for e in embs]
            )
            if not (dists < 0.9).any():
                return None
            return boxes[int(np.argmin(dists))]
        # the face nearest the frame's centre
        if len(boxes) == 0:
            return None
        if len(boxes) == 1:
            return boxes[0]
        cx, cy = W // 2, H // 2
        centers = np.stack(
            [(boxes[:, 0] + boxes[:, 2]) // 2, (boxes[:, 1] + boxes[:, 3]) // 2], 1
        )
        d = np.abs(centers - [cx, cy]).sum(1)
        return boxes[int(np.argmin(d))]

    @staticmethod
    def landmark_crop(frame: np.ndarray, box) -> tuple[np.ndarray, int, int, int]:
        """Square-padded crop of ``box`` -> ((1, 3, 112, 112) f32 in [0, 1],
        x1, y1, size of the square in the frame)."""
        H, W, _ = frame.shape
        x1, y1, x2, y2 = [int(v) for v in box]
        w, h = x2 - x1 + 1, y2 - y1 + 1
        size = max(w, h)
        cx, cy = x1 + w // 2, y1 + h // 2
        x1, y1 = cx - size // 2, cy - size // 2
        x2, y2 = x1 + size, y1 + size
        dx, dy = max(0, -x1), max(0, -y1)
        edx, edy = max(0, x2 - W), max(0, y2 - H)
        x1c, y1c, x2c, y2c = max(0, x1), max(0, y1), min(W, x2), min(H, y2)
        face = frame[y1c:y2c, x1c:x2c]
        if dx or dy or edx or edy:
            face = cv2.copyMakeBorder(face, dy, edy, dx, edx, cv2.BORDER_CONSTANT, 0)
        face = cv2.resize(face, (112, 112)).astype(np.float32) / 255.0
        return face.transpose(2, 0, 1)[None], x1, y1, size

    def _landmarks(self, frame: np.ndarray, box) -> np.ndarray:
        """Square-pad crop -> 112x112 /255 -> landmark net -> reproject."""
        face, x1, y1, size = self.landmark_crop(frame, box)
        out = self.landmark_fn(torch.from_numpy(np.ascontiguousarray(face))).cpu().numpy()
        lm = out[0].reshape(-1, 2).copy()
        # reproject from the unit square to the padded box
        lm[:, 0] = x1 + lm[:, 0] * size
        lm[:, 1] = y1 + lm[:, 1] * size
        return lm
