"""Inference engine: images -> forward -> decode -> NMS kernel, on one device.

Port of yolo_tpu/inference.py (with ``nms_impl="pallas"``): the same
``predict`` / ``predict_batch_arrays`` / ``predict_batch_files`` /
``parse_predictions`` / ``iou`` / ``non_max_suppression`` surface. A batch
runs forward, decode and NMS on the engine's device, and only the
fixed-shape ``Detections`` cross to the host. On CUDA, NMS is the
hand-written kernel (ops/cuda_nms.py); on the CPU, its plain twin. It runs
eagerly.

``optimize="int8"`` serves with the int8 engine (serving/engine.py:
BN-folded, per-channel-quantized weights, calibrated activation scales, the
stem-front and int8-conv kernels), built from ``calibration`` batches, or
lazily from the first predicted batch, or loaded from an ``engine_artifact``
(serving/export.py). ``wino=`` names stride-1 3x3 convs that run as per-tap
int8 Winograd convs (serving/winograd.py); an artifact of such an engine
serves with the same convs.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from yolo_tpu_torch.data.transforms import device_normalize, eval_transform
from yolo_tpu_torch.ops.boxes import EPSILON
from yolo_tpu_torch.ops.cuda_nms import nms
from yolo_tpu_torch.ops.decode import Detections, decode_predictions


class YOLOInference:
    """Run object detection with the model on ``device``.

    Args:
        model: a ``YOLOv1`` (has .S, .B, .num_classes), weights loaded.
        device: where the forward, decode and NMS run ("cuda", "cuda:1",
            "cpu"). The model is moved there, put in eval mode, and on CUDA
            kept in channels_last memory.
        image_size: input resolution the model was built for (448).
        optimize: None (the exact float32 forward) or "int8" (the int8
            serving engine, serving/).
        calibration: optional iterable of normalized (n, H, W, 3) image
            batches for the int8 activation scales. Without it the engine
            calibrates on the first batch it predicts (its real rows only).
        engine_artifact: path of a saved int8 engine (.npz, from
            :meth:`save_engine` or the JAX package's ``save_engine``) to
            serve instead of calibrating; needs ``optimize="int8"``.
        wino: conv names ("head_conv1", "l3b1_conv2", ...) the int8 engine
            runs as per-tap Winograd convs (not bit-exact against the direct
            conv); an artifact brings its own.

    Example:
        >>> engine = YOLOInference(model, "cuda")
        >>> detections = engine.predict("image.jpg", conf_threshold=0.25)
    """

    #: Minimum images the activation-scale calibration must have seen before
    #: the int8 engine may be frozen to an artifact without ``force``.
    MIN_CALIB_IMAGES = 8

    def __init__(self, model: torch.nn.Module, device: torch.device | str,
                 image_size: int = 448, optimize: str | None = None, calibration=None,
                 engine_artifact: str | None = None, wino=()):
        if optimize not in (None, "int8"):
            raise ValueError(f"optimize must be None or 'int8', got {optimize!r}")
        if engine_artifact is not None and optimize != "int8":
            raise ValueError("engine_artifact requires optimize='int8'")
        if wino:
            from yolo_tpu_torch.serving.winograd import check_points

            if optimize != "int8":
                raise ValueError("wino requires optimize='int8'")
            check_points(wino)
        self.device = torch.device(device)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.image_size = image_size
        self._int8_state: dict = {}
        self._run = self._exact
        if optimize == "int8":
            self._run = (self._load_int8_artifact(engine_artifact) if engine_artifact
                         else self._build_int8(calibration, tuple(wino)))

    @torch.inference_mode()
    def _predict_batch(self, images, conf_threshold: float,
                       nms_threshold: float) -> Detections:
        return self._run(torch.as_tensor(images, device=self.device), conf_threshold,
                         nms_threshold)

    def _exact(self, images: torch.Tensor, conf_threshold: float,
               nms_threshold: float) -> Detections:
        if images.dtype == torch.uint8:
            # uint8 wire format: raw resized RGB, normalized on the device.
            images = device_normalize(images)
        else:
            images = images.to(torch.float32)
        # NHWC -> NCHW view; its memory is already channels_last.
        preds = self.model(images.permute(0, 3, 1, 2))
        m = self.model
        dets = decode_predictions(preds.float(), m.S, m.B, m.num_classes, conf_threshold)
        return nms(dets, nms_threshold)

    # --------------------------------------------------------------- int8 engine
    def _build_int8(self, calibration, wino):
        from yolo_tpu_torch.serving.engine import build_int8_predict, default_impl

        state = self._int8_state
        if calibration is not None:
            # Materialized first, so that a generator still counts its images.
            calibration = [torch.as_tensor(b, device=self.device) for b in calibration]
            fn, q = build_int8_predict(self.model, calibration, impl=default_impl(), wino=wino)
            state.update(fn=fn, q=q, n_calib=sum(int(b.shape[0]) for b in calibration))
            return lambda images, conf, nms_t: fn(q, images, conf, nms_t)

        # No calibration data: calibrate on the first batch predicted, real
        # images only ("pending_valid" rows of it, where predict_batch_files
        # says so), since real-image maxima can exceed those of noise.
        def lazy_predict(images, conf, nms_t):
            valid = state.pop("pending_valid", None)
            if "fn" not in state:
                n_calib = int(images.shape[0] if valid is None else valid)
                if n_calib < self.MIN_CALIB_IMAGES:
                    warnings.warn(
                        f"int8 engine calibrating activation scales on the first predict"
                        f" batch of only {n_calib} image(s); scales are pinned for the"
                        f" engine's lifetime and a small or unrepresentative batch can"
                        f" underestimate activation maxima (clipping). Pass calibration="
                        f"[batches] to YOLOInference for deployment-grade scales.",
                        stacklevel=3,
                    )
                calib = images[:n_calib]
                calib = device_normalize(calib) if calib.dtype == torch.uint8 else calib
                state["fn"], state["q"] = build_int8_predict(
                    self.model, [calib.to(torch.float32)], impl=default_impl(), wino=wino)
                state["n_calib"] = n_calib
            return state["fn"](state["q"], images, conf, nms_t)

        return lazy_predict

    def _load_int8_artifact(self, path):
        """Serve a saved engine: no fold and no calibration (engine.load_artifact)."""
        from yolo_tpu_torch.serving.engine import load_artifact, make_int8_engine_fn

        q, impl = load_artifact(path, self.model, self.device)
        m = self.model
        fn = make_int8_engine_fn(m.S, m.B, m.num_classes, impl=impl)
        self._int8_state.update(fn=fn, q=q)
        return lambda images, conf, nms_t: fn(q, images, conf, nms_t)

    def save_engine(self, path, force: bool = False) -> None:
        """Freeze the built int8 engine's q-params to ``path`` (.npz).

        Needs ``optimize="int8"`` and a built engine (calibration given, an
        artifact loaded, or one batch predicted). An engine calibrated on
        fewer than ``MIN_CALIB_IMAGES`` images is refused unless ``force``:
        its scales would bake unrepresentative maxima into every deployment.
        An engine loaded from an artifact is exempt.
        """
        if "q" not in self._int8_state:
            raise RuntimeError(
                "no built int8 engine to save: construct with optimize='int8' and either"
                " pass calibration= or run one predict batch first (lazy calibration)")
        n_calib = self._int8_state.get("n_calib")
        if not force and n_calib is not None and n_calib < self.MIN_CALIB_IMAGES:
            raise RuntimeError(
                f"refusing to freeze an int8 engine calibrated on only {n_calib} image(s)"
                f" (< {self.MIN_CALIB_IMAGES}): the activation scales would bake"
                f" unrepresentative maxima into the deployment artifact. Pass"
                f" calibration=[batches] with >= {self.MIN_CALIB_IMAGES} representative"
                f" images (or predict a larger first batch), or call"
                f" save_engine(path, force=True) to override.")
        from yolo_tpu_torch.serving.export import save_engine as _save

        m = self.model
        _save(path, self._int8_state["q"], S=m.S, B=m.B, num_classes=m.num_classes)

    # ------------------------------------------------------------------- images
    def load_image(self, image_path: str):
        """Load an RGB PIL image (raises FileNotFoundError on a bad path)."""
        from PIL import Image

        return Image.open(image_path).convert("RGB")

    def _transform(self, image) -> np.ndarray:
        return eval_transform(
            np.asarray(image.convert("RGB")), (self.image_size, self.image_size)
        )

    def preprocess_image(self, image) -> torch.Tensor:
        """PIL image -> (1, size, size, 3) normalized float32 tensor on the device."""
        return torch.from_numpy(self._transform(image))[None].to(self.device)

    # ------------------------------------------------------------------ predict
    def predict(
        self,
        image_path: str,
        conf_threshold: float = 0.5,
        nms_threshold: float = 0.4,
        class_names: Optional[Sequence[str]] = None,
    ) -> List["Detection"]:
        """Detect objects in one image file; returns Detection objects."""
        batch = self.preprocess_image(self.load_image(image_path))
        dets = self._predict_batch(batch, conf_threshold, nms_threshold)
        return self._to_detections(_to_host(dets), 0, class_names)

    def predict_batch_arrays(
        self,
        images,
        conf_threshold: float = 0.5,
        nms_threshold: float = 0.4,
    ) -> Detections:
        """Batched prediction: (N, H, W, 3) -> Detections on the engine's device.

        ``images`` (numpy or torch, NHWC as in the JAX package) may be
        normalized floats or raw resized uint8 RGB; uint8 ships 1 byte per
        pixel and is normalized on the device. Nothing waits for the device
        until the caller reads the result.
        """
        return self._predict_batch(images, conf_threshold, nms_threshold)

    def predict_batch_files(
        self,
        image_paths: Sequence[str],
        conf_threshold: float = 0.5,
        nms_threshold: float = 0.4,
        class_names: Optional[Sequence[str]] = None,
        batch_size: int = 16,
    ) -> List[List["Detection"]]:
        """Detect objects in many files, ``batch_size`` images per forward.

        Per-image results are identical to calling ``predict`` on each file.
        """
        results: List[List] = []
        try:
            for start in range(0, len(image_paths), batch_size):
                chunk = image_paths[start:start + batch_size]
                batch = np.stack([self._transform(self.load_image(str(p))) for p in chunk])
                # Tells a pending lazy int8 calibration how many rows are
                # real images (a chunk is never padded here, but the count
                # is the contract of the JAX engine).
                self._int8_state["pending_valid"] = len(chunk)
                dets = _to_host(self._predict_batch(batch, conf_threshold, nms_threshold))
                results.extend(
                    self._to_detections(dets, i, class_names) for i in range(len(chunk))
                )
        finally:
            self._int8_state.pop("pending_valid", None)
        return results

    def parse_predictions(
        self,
        pred,
        conf_threshold: float,
        class_names: Optional[Sequence[str]] = None,
    ) -> List["Detection"]:
        """Decode one raw (S, S, B*5+C) grid into Detection objects (no NMS)."""
        m = self.model
        dets = decode_predictions(
            torch.as_tensor(pred, dtype=torch.float32)[None],
            m.S, m.B, m.num_classes, conf_threshold,
        )
        return self._to_detections(_to_host(dets), 0, class_names)

    def _to_detections(
        self, dets: Detections, index: int, class_names: Optional[Sequence[str]]
    ) -> List["Detection"]:
        from yolo_tpu_torch.schemas import BoundingBox, Detection

        out = []
        boxes = dets.boxes[index].numpy()
        scores = dets.scores[index].numpy()
        class_ids = dets.class_ids[index].numpy()
        valid = dets.valid[index].numpy()
        for k in np.nonzero(valid)[0]:
            cid = int(class_ids[k])
            name = class_names[cid] if class_names else f"class_{cid}"
            x, y, w, h = (float(v) for v in boxes[k])
            out.append(
                Detection(
                    class_id=cid,
                    class_name=name,
                    confidence=float(np.clip(scores[k], 0.0, 1.0)),
                    bbox=BoundingBox(
                        x=float(np.clip(x, 0, 1)),
                        y=float(np.clip(y, 0, 1)),
                        width=float(np.clip(w, 0, 1)),
                        height=float(np.clip(h, 0, 1)),
                    ),
                )
            )
        # Confidence-descending, matching reference NMS output ordering.
        out.sort(key=lambda d: -d.confidence)
        return out

    # -------------------------------------------------------- host-side helpers
    def iou(self, bbox1, bbox2) -> float:
        """Pairwise IoU on BoundingBox schemas (reference inference.py:212-249)."""
        x1a, y1a, x2a, y2a = bbox1.to_corners()
        x1b, y1b, x2b, y2b = bbox2.to_corners()
        inter = max(0.0, min(x2a, x2b) - max(x1a, x1b)) * max(
            0.0, min(y2a, y2b) - max(y1a, y1b)
        )
        return inter / (bbox1.area + bbox2.area - inter + EPSILON)

    def non_max_suppression(
        self,
        detections: List["Detection"],
        nms_threshold: Optional[float] = None,
        iou_threshold: Optional[float] = None,
    ) -> List["Detection"]:
        """Host-side greedy per-class NMS on Detection lists (API parity with
        reference inference.py:251-317, including the deprecated
        ``iou_threshold``). ``predict_batch_arrays`` is the fast route."""
        if iou_threshold is not None:
            warnings.warn(
                "Parameter 'iou_threshold' is deprecated, use 'nms_threshold'"
                " instead.",
                DeprecationWarning,
                stacklevel=2,
            )
            threshold = iou_threshold
        elif nms_threshold is not None:
            threshold = nms_threshold
        else:
            threshold = 0.4

        remaining = sorted(detections, key=lambda d: d.confidence, reverse=True)
        keep: List = []
        while remaining:
            current = remaining.pop(0)
            keep.append(current)
            remaining = [
                d
                for d in remaining
                if d.class_id != current.class_id
                or self.iou(current.bbox, d.bbox) < threshold
            ]
        return keep


def _to_host(dets: Detections) -> Detections:
    return Detections(*(t.cpu() for t in dets))
