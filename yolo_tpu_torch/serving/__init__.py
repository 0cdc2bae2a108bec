"""The int8 serving engine on the card (port of yolo_tpu/serving/).

- ``fold``: BN folding -> flat eval-time parameters (JAX layout), and the
  float forward on them (the calibration oracle);
- ``quant``: post-training int8 quantization and requant constants;
- ``cuda_stem``: quantize + space-to-depth stem front, kernel
  ``csrc/quant_s2d.cu``;
- ``cuda_int8``: int8 conv + requant, kernel ``csrc/int8_conv.cu``;
- ``cuda_bottleneck``: fused identity bottlenecks and stage chains, kernels
  ``csrc/int8_bottleneck.cu`` (the opt-in ``impl["layer1"..]`` hooks);
- ``winograd``: the per-tap int8 Winograd F(2,3) convs named by ``wino=``
  (taps, quantization, the plain twin, the engine hooks), and ``cuda_wino``,
  their kernel ``csrc/int8_wino.cu`` with its ablation modes;
- ``engine``: the int8-resident forward with the decode + NMS tail;
- ``export``: ``.npz`` engine artifacts, interchangeable with the JAX
  package's, and the AOT artifact: the whole served graph recorded by
  ``torch.export`` into a ``.pt2`` (``save_compiled_engine``,
  ``load_compiled_engine``);
- ``library``: the stem front, the int8 conv and NMS as ``torch.library``
  custom ops, which the AOT artifact's program calls;
- ``graphs``: one captured CUDA graph per batch shape of a serving
  callable (``GraphedPredict``), the counterpart of JAX's per-shape jit;
- ``batcher``: ``RequestBatcher``, single-image requests coalesced into
  fixed-bucket batches (one graph a bucket on the card);
- ``server``: ``YOLOServer``, the HTTP front end over the batcher
  (``python -m yolo_tpu_torch.serve``).

Serving mode is opt-in: ``YOLOInference(..., optimize="int8")``.
``engine.make_sharded_int8_engine_fn`` serves a global batch over the data
axis of a ``parallel.make_mesh`` mesh.
"""

from yolo_tpu_torch.serving.batcher import RequestBatcher
from yolo_tpu_torch.serving.cuda_bottleneck import block_int8, chain_int8
from yolo_tpu_torch.serving.engine import build_int8_predict, int8_forward, make_int8_engine_fn
from yolo_tpu_torch.serving.export import (load_compiled_engine, load_engine,
                                           save_compiled_engine, save_engine)
from yolo_tpu_torch.serving.fold import fold_flagship, folded_forward
from yolo_tpu_torch.serving.quant import ACT_POINTS, calibrate_activations, quantize_folded
from yolo_tpu_torch.serving.server import YOLOServer

__all__ = [
    "ACT_POINTS",
    "RequestBatcher",
    "YOLOServer",
    "block_int8",
    "build_int8_predict",
    "calibrate_activations",
    "chain_int8",
    "fold_flagship",
    "folded_forward",
    "int8_forward",
    "load_compiled_engine",
    "load_engine",
    "make_int8_engine_fn",
    "quantize_folded",
    "save_compiled_engine",
    "save_engine",
]
