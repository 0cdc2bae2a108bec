"""The serving engine's four kernels as ``torch.library`` custom ops.

``torch.export`` records what the engine computes as an ATen graph. A kernel
behind ``ctypes`` is not an ATen op, and NMS's plain twin branches on the
data (``cuda_nms.nms_reference`` stops when nothing is active), so neither
traces as it stands. Registered as custom ops with a fake implementation
(the output's shape and dtype), each kernel is one opaque node of the
exported graph:

- ``yolo_tpu_torch::quant_s2d`` -- the stem front, ``serving/cuda_stem.py``
  (kernel ``csrc/quant_s2d.cu``);
- ``yolo_tpu_torch::max_pool_int8`` -- the max-pool after the stem,
  ``serving/cuda_pool.py`` (kernel ``csrc/max_pool_int8.cu``);
- ``yolo_tpu_torch::conv_int8`` -- every int8 conv and int8 fc1,
  ``serving/cuda_int8.py`` (kernel ``csrc/int8_conv.cu``);
- ``yolo_tpu_torch::nms_keep`` -- the NMS keep mask, ``ops/cuda_nms.py``
  (kernel ``csrc/nms.cu``).

Each op's implementation is its wrapper: on CUDA tensors the kernel runs
(and ``kernels.LAUNCHES`` counts it), on CPU tensors the plain twin; a CUDA
tensor never reaches the twin. :func:`aot_impl`, :func:`aot_conv` and
:func:`aot_nms` have the engine's hook signatures
(``engine.make_int8_engine_fn(..., impl=, nms_fn=, conv=)``) and call the
ops; ``export.save_compiled_engine`` builds its engine with them.

Only the export goes through the ops. A custom op's dispatch costs host time
on every call (``chip_smoke.py`` phase 36 times both), so the eager and graphed engine
(``engine.int8_forward``'s defaults, ``engine.kernel_conv``,
``cuda_nms.nms``) calls the wrappers directly. The fused chain and Winograd
hooks have no op: the AOT artifact serves the default engine only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.boxes import EPSILON
from yolo_tpu_torch.ops.decode import Detections
from yolo_tpu_torch.serving import cuda_int8, cuda_pool, cuda_stem

NAMESPACE = "yolo_tpu_torch"
_DEVICES = ("cpu", "cuda")


@torch.library.custom_op(f"{NAMESPACE}::quant_s2d", mutates_args=(), device_types=_DEVICES)
def quant_s2d(images: torch.Tensor, s_img: torch.Tensor) -> torch.Tensor:
    """``cuda_stem.quant_s2d``: (N, H, W, 3) uint8/float32 -> (N, H/2, W/2, 12) int8."""
    return cuda_stem.quant_s2d(images, s_img)


@quant_s2d.register_fake
def _(images, s_img):
    cuda_stem._check(images, s_img)
    n, h, w, _ = images.shape
    return images.new_empty((n, h // 2, w // 2, 12), dtype=torch.int8)


@torch.library.custom_op(f"{NAMESPACE}::max_pool_int8", mutates_args=(), device_types=_DEVICES)
def max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """``cuda_pool.max_pool_int8``: (N, H, W, C) int8 -> (N, (H-1)//2+1, (W-1)//2+1, C)."""
    return cuda_pool.max_pool_int8(x)


@max_pool_int8.register_fake
def _(x):
    n, h, w, c = x.shape
    return x.new_empty((n, *cuda_pool.out_size(h, w), c), dtype=torch.int8)


def _pad_pairs(pad: Sequence[int]):
    top, bottom, left, right = pad
    return (top, bottom), (left, right)


@torch.library.custom_op(f"{NAMESPACE}::conv_int8", mutates_args=(), device_types=_DEVICES)
def conv_int8(x: torch.Tensor, wq: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
              wk: Optional[torch.Tensor], res: Optional[torch.Tensor],
              r: Optional[torch.Tensor], stride: int, pad: Sequence[int],
              mode: str) -> torch.Tensor:
    """``cuda_int8.conv_int8`` with ``pad`` as (top, bottom, left, right)."""
    return cuda_int8.conv_int8(x, wq, m, t, stride, _pad_pairs(pad), mode, res, r, wk=wk)


@conv_int8.register_fake
def _(x, wq, m, t, wk, res, r, stride, pad, mode):
    if mode not in cuda_int8.MODES:
        raise ValueError(f"conv_int8: mode must be one of {sorted(cuda_int8.MODES)}, "
                         f"got {mode!r}")
    n, h, w, _ = x.shape
    kh, kw, _, cout = wq.shape
    ho, wo = cuda_int8.out_size(h, w, kh, kw, stride, _pad_pairs(pad))
    dtype = {"float": torch.float32, "acc": torch.int32}.get(mode, torch.int8)
    return x.new_empty((n, ho, wo, cout), dtype=dtype)


@torch.library.custom_op(f"{NAMESPACE}::nms_keep", mutates_args=(), device_types=_DEVICES)
def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
             valid: torch.Tensor, iou_threshold: float, eps: float) -> torch.Tensor:
    """``cuda_nms.keep_mask``: the (n, K) bool keep mask of (n, K) candidates."""
    return cuda_nms.keep_mask(boxes, scores, class_ids, valid, iou_threshold, eps)


@nms_keep.register_fake
def _(boxes, scores, class_ids, valid, iou_threshold, eps):
    return torch.empty_like(valid)


# ------------------------------------------------------ the engine's hooks
def aot_conv(x, qc: Dict, stride: int = 1, pad=0, mode: str = "relu", res=None, r=None):
    """``engine.kernel_conv`` through ``conv_int8``."""
    return torch.ops.yolo_tpu_torch.conv_int8(
        x, qc["wq"], qc["m"], qc["t"], qc.get("wk"), res, r, stride,
        list(cuda_int8._pads(pad)), mode)


def aot_impl() -> Dict:
    """The engine's stem-front and max-pool overrides through ``quant_s2d`` and
    ``max_pool_int8``."""
    return {"stem_front": torch.ops.yolo_tpu_torch.quant_s2d,
            "max_pool": torch.ops.yolo_tpu_torch.max_pool_int8}


def aot_nms(dets: Detections, iou_threshold: float = 0.4, eps: float = EPSILON) -> Detections:
    """``cuda_nms.nms`` through ``nms_keep``."""
    keep = torch.ops.yolo_tpu_torch.nms_keep(*cuda_nms.keep_args(dets, iou_threshold, eps))
    return dets._replace(valid=keep.reshape(dets.scores.shape))
