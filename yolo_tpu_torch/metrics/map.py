"""mean Average Precision evaluator: decode, NMS and matching a batch at a time.

Port of yolo_tpu/metrics/map.py. Each batch runs decode -> per-class greedy
NMS (IoU without a stabilizer, eps = 0) -> ground-truth decode -> greedy
matching at all IoU thresholds x 4 GT size filters as a few batched tensor
ops, and only fixed-shape arrays cross to the host, once a batch. The host
then sorts and sums per class with the same numpy code as the JAX package
(:meth:`mAPMetric.compute`), so the 77 result keys come from the same host
arithmetic:

- mAP50:95 / mAP50 / mAP75, overall precision and recall at IoU 0.5;
- AP50 / AP75 / AP50:95 for every class (AP 0 for a class without GTs or
  predictions), 11-point interpolated (VOC2007);
- mAP50:95 / mAP50 / mAP75 and the object count for small / medium / large
  GTs (COCO's 32 and 96 pixel sides, normalized by 448).

Two paths, as in JAX, both on the predictions' device:

- ``precise=True`` (the default): decode, NMS and matching in float64, the
  precision the reference computes in (its Python floats). JAX sent this
  work to the host because a TPU emulates float64; an H100 runs it natively.
  Explicit dtypes: no global switch is flipped.
- ``precise=False``: the same in float32.

On CUDA, NMS is the kernel ``csrc/nms.cu`` (``ops/cuda_nms.py::nms``, its
float64 or float32 instantiation, one launch a batch); on the CPU, its plain
twin.

Both decodes divide by S as a 0-dim tensor (``s_divisor``): a true division
on every device, as JAX's evaluator does.

Under a mesh (``mesh=``, ``parallel.make_mesh``) each rank runs forward,
decode, NMS and matching on its rows of every global batch, and
:meth:`mAPMetric.update` gathers the per-image results and the sample
mask over the data group in global row order, so every rank accumulates
the whole dataset and returns the same 77 keys as one process (JAX
map.py:164-185, 455-470).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yolo_tpu_torch.data.loader import pad_batch
from yolo_tpu_torch.data.transforms import device_normalize
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.decode import decode_ground_truth, decode_predictions
from yolo_tpu_torch.ops.matching import match_detections_masked

EPSILON = 1e-6

# Size buckets in normalized area (COCO's 32 and 96 pixel sides at 448).
SMALL_AREA = (32 / 448) ** 2
MEDIUM_AREA = (96 / 448) ** 2

_SIZE_NAMES = ("small", "medium", "large")


def _process_batch(predictions: torch.Tensor, targets: torch.Tensor, S: int, B: int, C: int,
                   conf_threshold: float, nms_threshold: float, thresholds: torch.Tensor,
                   s_divisor: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decode + NMS + match one batch where its tensors lie, in their dtype.

    Returns (N, T, K) TP flags in score-sorted order for each GT filter
    (all, small, medium, large), the sorted scores / classes / validity and
    the GTs' classes and filter masks.
    """
    preds = decode_predictions(predictions, S, B, C, conf_threshold, s_divisor=s_divisor)
    keep = cuda_nms.nms(preds, nms_threshold, eps=0.0).valid
    gts = decode_ground_truth(targets, S, B, C, s_divisor=s_divisor)

    area = gts.boxes[..., 2] * gts.boxes[..., 3]
    small = gts.valid & (area < SMALL_AREA)
    medium = gts.valid & (area >= SMALL_AREA) & (area < MEDIUM_AREA)
    large = gts.valid & (area >= MEDIUM_AREA)

    # One masked matching pass: the score sort and the IoU matrix are shared
    # by the four GT filters.
    masks = torch.stack([gts.valid, small, medium, large])  # (4, N, G)
    tp, scores_s, class_s, valid_s = match_detections_masked(
        preds.boxes, preds.scores, preds.class_ids, keep, gts.boxes, gts.class_ids, masks,
        thresholds)
    results = {f"tp_{name}": tp[:, m] for m, name in enumerate(("all", *_SIZE_NAMES))}
    results.update(scores=scores_s, class_ids=class_s, pred_valid=valid_s,
                   gt_class_all=gts.class_ids, gt_valid_all=gts.valid,
                   gt_valid_small=small, gt_valid_medium=medium, gt_valid_large=large)
    return results


def _pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A batch's outputs as one uint8 tensor, 4-byte dtypes first (so that
    every segment stays aligned for :func:`_unpack`'s dtype views)."""
    keys = sorted(out, key=lambda k: -out[k].element_size())
    return torch.cat([out[k].contiguous().reshape(-1).view(torch.uint8) for k in keys])


def _unpack(packed: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """numpy arrays of :func:`_pack`'s segments, shaped and typed as ``like``."""
    host, start = {}, 0
    for k in sorted(like, key=lambda k: -like[k].element_size()):
        n = like[k].numel() * like[k].element_size()
        host[k] = packed[start:start + n].view(like[k].dtype).reshape(like[k].shape).numpy()
        start += n
    return {k: host[k] for k in like}


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """numpy copies of a batch's outputs; off the CPU, one device-to-host copy."""
    if next(iter(out.values())).device.type == "cpu":
        return {k: v.numpy() for k, v in out.items()}
    return _unpack(_pack(out).cpu(), out)


def _gather_rows(chunk: Dict[str, np.ndarray], group) -> Dict[str, np.ndarray]:
    """Every rank's rows of a batch's results, in group-rank order (one
    all-gather of the packed bytes, through the CPU)."""
    from yolo_tpu_torch.parallel.mesh import gather

    like = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in chunk.items()}
    packed = gather(_pack(like), group).reshape(-1, sum(t.numel() * t.element_size()
                                                        for t in like.values()))
    parts = [_unpack(row.clone(), like) for row in packed]  # each row from offset 0
    return {k: np.concatenate([p[k] for p in parts]) for k in chunk}


def _eleven_point_ap(precisions: np.ndarray, recalls: np.ndarray) -> float:
    """11-point interpolated AP with [1.0]/[0.0] sentinels (VOC2007)."""
    precisions = np.concatenate(([1.0], precisions))
    recalls = np.concatenate(([0.0], recalls))
    ap = 0.0
    for t in np.linspace(0, 1, 11):
        mask = recalls >= t
        ap += (np.max(precisions[mask]) if mask.any() else 0.0) / 11
    return float(ap)


class mAPMetric:
    """Streaming mAP metric: reset / update / compute.

    Args: num_classes, iou_thresholds (None -> 0.5:0.05:0.95; a scalar is
    accepted), conf_threshold (0.01), nms_threshold (0.4), S, B,
    ``precise`` and ``mesh`` (see the module docstring).
    """

    def __init__(
        self,
        num_classes: int,
        iou_thresholds: Optional[Sequence[float] | float] = None,
        conf_threshold: float = 0.01,
        nms_threshold: float = 0.4,
        S: int = 7,
        B: int = 2,
        precise: bool = True,
        mesh=None,
    ):
        self.num_classes = num_classes
        self.mesh = mesh
        if iou_thresholds is None:
            self.iou_thresholds = [0.5 + 0.05 * i for i in range(10)]
        elif isinstance(iou_thresholds, (int, float)):
            self.iou_thresholds = [float(iou_thresholds)]
        else:
            self.iou_thresholds = list(iou_thresholds)
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.S = S
        self.B = B
        self.precise = precise
        self._constants: Dict = {}
        self.reset()

    def reset(self):
        """Drop all accumulated state."""
        self._chunks: List[dict] = []

    def _device_constants(self, device: torch.device, dtype: torch.dtype):
        """(thresholds, s_divisor) on ``device``, made once per device."""
        key = (device, dtype)
        if key not in self._constants:
            self._constants[key] = (
                torch.tensor(self.iou_thresholds, dtype=dtype, device=device),
                torch.tensor(float(self.S), dtype=dtype, device=device))
        return self._constants[key]

    def update(self, predictions, targets, sample_mask=None):
        """Accumulate one batch of raw (N, S, S, B*5+C) predictions and targets.

        Takes numpy arrays or torch tensors on any device. ``sample_mask``
        ((N,) bool) drops zero-padded rows of a ragged final batch.
        """
        predictions = torch.as_tensor(predictions).detach()
        device = predictions.device
        dtype = torch.float64 if self.precise else torch.float32
        thresholds, s_divisor = self._device_constants(device, dtype)
        with torch.inference_mode():
            out = _process_batch(
                predictions.to(dtype), torch.as_tensor(targets).to(device, dtype),
                self.S, self.B, self.num_classes, self.conf_threshold, self.nms_threshold,
                thresholds, s_divisor)
        chunk = _to_host(out)
        if sample_mask is not None:
            chunk["sample_mask"] = np.asarray(torch.as_tensor(sample_mask).cpu(), bool)
        if self.mesh is not None:
            chunk = _gather_rows(chunk, self.mesh.get_group("data"))
        m = chunk.pop("sample_mask", None)
        if m is not None and not m.all():
            chunk = {k: v[m] for k, v in chunk.items()}
        self._chunks.append(chunk)

    # ------------------------------------------------------------------ compute
    def _concat(self, key: str) -> np.ndarray:
        return np.concatenate([c[key] for c in self._chunks], axis=0)

    def compute(self) -> Dict[str, float]:
        """Aggregate per-class / per-threshold / per-size AP on the host."""
        if not self._chunks:
            return {
                "mAP50:95": 0.0,
                "mAP50": 0.0,
                "mAP75": 0.0,
                "precision": 0.0,
                "recall": 0.0,
            }

        scores = self._concat("scores")  # (I, K)
        class_ids = self._concat("class_ids")
        pred_valid = self._concat("pred_valid")
        gt_class = self._concat("gt_class_all")
        results: Dict[str, float] = {}
        T = len(self.iou_thresholds)

        thr_index = {t: i for i, t in enumerate(self.iou_thresholds)}

        def ap_table(tp_key: str, gt_valid_key: str) -> np.ndarray:
            """(num_classes, T) AP table for one GT size filter."""
            tp = self._concat(tp_key)  # (I, T, K)
            gt_valid = self._concat(gt_valid_key)  # (I, G)
            aps = np.zeros((self.num_classes, T))
            for c in range(self.num_classes):
                n_gt = int((gt_valid & (gt_class == c)).sum())
                if n_gt == 0:
                    continue
                sel = pred_valid & (class_ids == c)  # (I, K)
                if not sel.any():
                    continue
                conf = scores[sel]
                order = np.argsort(-conf, kind="stable")
                for ti in range(T):
                    tp_c = tp[:, ti, :][sel][order]
                    tp_cum = np.cumsum(tp_c)
                    fp_cum = np.cumsum(~tp_c)
                    prec = tp_cum / (tp_cum + fp_cum + EPSILON)
                    rec = tp_cum / n_gt
                    aps[c, ti] = _eleven_point_ap(prec, rec)
            return aps

        aps = ap_table("tp_all", "gt_valid_all")
        for c in range(self.num_classes):
            if 0.5 in thr_index:
                results[f"AP50_class_{c}"] = float(aps[c, thr_index[0.5]])
            if 0.75 in thr_index:
                results[f"AP75_class_{c}"] = float(aps[c, thr_index[0.75]])
            results[f"AP50:95_class_{c}"] = float(aps[c].mean())
        if 0.5 in thr_index:
            results["mAP50"] = float(aps[:, thr_index[0.5]].mean())
        if 0.75 in thr_index:
            results["mAP75"] = float(aps[:, thr_index[0.75]].mean())
        results["mAP50:95"] = float(aps.mean())

        # Overall precision / recall at IoU 0.5.
        if 0.5 in thr_index:
            ti = thr_index[0.5]
            tp_all = self._concat("tp_all")[:, ti, :]
            total_tp = int(tp_all[pred_valid].sum())
            total_pred = int(pred_valid.sum())
            total_gt = int(self._concat("gt_valid_all").sum())
            total_fp = total_pred - total_tp
            results["precision"] = total_tp / (total_tp + total_fp + EPSILON)
            results["recall"] = total_tp / (total_gt + EPSILON)
        else:
            results["precision"] = 0.0
            results["recall"] = 0.0

        # Size-based metrics.
        for size in _SIZE_NAMES:
            gt_valid_sz = self._concat(f"gt_valid_{size}")
            count = int(gt_valid_sz.sum())
            results[f"num_{size}_objects"] = count
            if count == 0:
                results[f"mAP50:95_{size}"] = 0.0
                results[f"mAP50_{size}"] = 0.0
                results[f"mAP75_{size}"] = 0.0
                continue
            aps_sz = ap_table(f"tp_{size}", f"gt_valid_{size}")
            if 0.5 in thr_index:
                results[f"mAP50_{size}"] = float(aps_sz[:, thr_index[0.5]].mean())
            if 0.75 in thr_index:
                results[f"mAP75_{size}"] = float(aps_sz[:, thr_index[0.75]].mean())
            results[f"mAP50:95_{size}"] = float(aps_sz.mean())

        return results


@contextlib.contextmanager
def _exact_float32():
    """TF32 off for the forward's convs and matmuls (exact float32)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def evaluate_model(
    model,
    dataloader,
    num_classes: int = 20,
    iou_thresholds: Optional[Sequence[float]] = None,
    conf_threshold: float = 0.01,
    nms_threshold: float = 0.4,
    S: int = 7,
    B: int = 2,
    verbose: bool = True,
    device: torch.device | str | None = None,
    forward_fn=None,
    precise: bool = True,
    use_amp: bool = False,
    mesh=None,
) -> Dict[str, float]:
    """Evaluate a YOLO model over a dataloader; returns the 77 metric keys.

    ``model``: a port ``YOLOv1`` (weights loaded), run in eval mode on
    ``device`` (default: the model's), float32 with TF32 off, or under bf16
    autocast with ``use_amp``. ``dataloader`` yields (images NHWC, uint8 or
    normalized float32, targets) numpy batches; uint8 is normalized on the
    device (``device_normalize``). ``forward_fn`` replaces the model's
    forward: ``(normalized float32 NHWC images on the device) -> (N, S, S,
    B*5+C)``, e.g. the int8 serving engine. A ragged final batch is
    zero-padded to the loader's ``batch_size`` and its padding dropped with
    ``sample_mask``. ``precise`` as in :class:`mAPMetric`. With ``mesh`` each
    rank evaluates its rows of every (padded) batch (``parallel.batch_slice``)
    and every rank returns the whole dataset's keys.
    """
    metric = mAPMetric(num_classes=num_classes, iou_thresholds=iou_thresholds,
                       conf_threshold=conf_threshold, nms_threshold=nms_threshold, S=S, B=B,
                       precise=precise, mesh=mesh)
    device = torch.device(device) if device is not None else next(model.parameters()).device
    if model is not None:
        model.eval()

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> torch.Tensor:
        images = device_normalize(images) if images.dtype == torch.uint8 \
            else images.to(torch.float32)
        if forward_fn is not None:
            return forward_fn(images)
        with _exact_float32(), torch.autocast(device.type, dtype=torch.bfloat16,
                                              enabled=use_amp):
            return model(images.permute(0, 3, 1, 2)).float()

    iterator = dataloader
    if verbose:
        try:
            from tqdm import tqdm

            iterator = tqdm(dataloader, desc="Evaluating", unit="batch")
        except ImportError:
            pass

    full_batch = getattr(dataloader, "batch_size", None)
    for images, targets in iterator:
        n = images.shape[0]
        mask = None
        if full_batch is not None and n < full_batch:
            images, targets, n = pad_batch(np.asarray(images), np.asarray(targets), full_batch)
            mask = np.arange(full_batch) < n
        if mesh is not None:
            from yolo_tpu_torch.parallel.mesh import batch_slice

            images, targets = batch_slice(mesh, images), batch_slice(mesh, targets)
            mask = None if mask is None else batch_slice(mesh, mask)
        preds = forward(torch.as_tensor(images).to(device))
        metric.update(preds, targets, sample_mask=mask)
    return metric.compute()
