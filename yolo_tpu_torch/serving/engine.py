"""The int8-resident serving engine: quantized forward + decode + NMS.

Port of yolo_tpu/serving/engine.py. Activations enter as images (normalized
float, or raw resized uint8 RGB, normalized inside the stem front), are
quantized once, and stay int8 through the stem, the 16 bottleneck blocks and
the 4 head convs. Every int8 conv, and int8 fc1, runs through the CUDA
kernel ``csrc/int8_conv.cu`` (``serving/cuda_int8.py``): an int32
accumulator and a fused per-channel requant; opt-in stage-chain hooks
(``impl["layer1"..]``, ``serving/cuda_bottleneck.py``) run a stage's
bottlenecks as fused kernels instead, and opt-in per-conv hooks
(``impl["conv2_s1"]``, ``impl["head_conv{i}"]``) run the stride-1 3x3 convs
named by ``wino=`` as per-tap int8 Winograd convs (``serving/winograd.py``,
kernel ``csrc/int8_wino.cu``). The stem front (normalize,
quantize, space-to-depth) is the kernel ``csrc/quant_s2d.cu``
(``serving/cuda_stem.py``) and the 3x3/s2 max-pool after the stem is the
kernel ``csrc/max_pool_int8.cu`` (``serving/cuda_pool.py``), at any batch.
The FC
stack runs in bfloat16 values with float32 sums, and the decode + NMS tail
(ops/decode.py, ops/cuda_nms.py) is the exact engine's.

On CPU tensors each kernel wrapper runs its plain twin, so the same code is
the CPU engine. A twin engine on the card, for checks, takes
``conv=plain_conv`` and ``impl={"stem_front": cuda_stem.quant_s2d_reference,
"max_pool": cuda_pool.max_pool_int8_reference}``. q-params live in the JAX package's layout (HWIO weights, flax's fc1
row order); :func:`to_device` moves them to a device and adds the kernels'
packed weights (``wk``, and ``uk`` for the Winograd taps) and float32
copies of the bfloat16 FC weights (``wf``), which ``export.save_engine``
leaves out.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from yolo_tpu_torch.data.transforms import device_normalize
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.decode import Detections, decode_predictions
from yolo_tpu_torch.serving import cuda_int8, cuda_pool, cuda_stem, cuda_wino
from yolo_tpu_torch.utils import tracing

#: Keys :func:`to_device` derives from the q-params (not part of an artifact).
DERIVED_KEYS = ("wk", "wf", "uk")


def kernel_conv(x, qc, stride=1, pad=0, mode="relu", res=None, r=None):
    """One int8 conv of the engine through the kernel wrapper (twin on CPU)."""
    return cuda_int8.conv_int8(x, qc["wq"], qc["m"], qc["t"], stride, pad, mode, res, r,
                               wk=qc.get("wk"))


def plain_conv(x, qc, stride=1, pad=0, mode="relu", res=None, r=None):
    """The same conv through the plain twin, on any device."""
    return cuda_int8.conv_int8_reference(x, qc["wq"], qc["m"], qc["t"], stride, pad, mode,
                                         res, r)


def _normalize_if_uint8(images: torch.Tensor) -> torch.Tensor:
    """Raw resized uint8 RGB (the 1-byte wire format) -> normalized float32."""
    if images.dtype == torch.uint8:
        return device_normalize(images)
    return images.to(torch.float32)


def _block(x_q, qb, stride: int = 1, conv: Callable = kernel_conv,
           conv2_s1: Optional[Callable] = None):
    """One bottleneck block: three int8 convs with fused requants (+ downsample).

    ``conv2_s1`` ``(y1, qc) -> y2`` replaces a stride-1 conv2, e.g. the
    Winograd conv (``winograd.wino_impl_hooks``)."""
    y1 = conv(x_q, qb["conv1"], 1, 0, "relu")
    if conv2_s1 is not None and stride == 1:
        y2 = conv2_s1(y1, qb["conv2"])
    else:
        y2 = conv(y1, qb["conv2"], stride, 1, "relu")
    if qb["downsample"] is not None:
        # The branch is requantized to int8 at its own calibrated scale
        # (quant.py), then rescaled by s_ds / s_out in conv3's epilogue.
        ds_q = conv(x_q, qb["downsample"], stride, 0, "none")
        return conv(y2, qb["conv3"], 1, 0, "residual", res=ds_q, r=qb["ds_rescale"])
    return conv(y2, qb["conv3"], 1, 0, "residual", res=x_q, r=qb["rx"])


@contextlib.contextmanager
def _exact_float32_matmul():
    """TF32 off for the FC products (float32 sums of bfloat16-valued operands)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _fc_weight(fc: Dict) -> torch.Tensor:
    return fc["wf"] if "wf" in fc else fc["w"].float()


def int8_forward(q: Dict, images: torch.Tensor, S: int = 7, impl: Optional[Dict] = None,
                 conv: Callable = kernel_conv) -> torch.Tensor:
    """Quantized serving forward: (N, H, W, 3) images -> (N, S, S, B*5+C) float32.

    ``images``: normalized float images, or raw resized uint8 RGB.
    ``impl["stem_front"]`` replaces the s2d stem's normalize + quantize +
    space-to-depth (``cuda_stem.quant_s2d``); ``impl["max_pool"]`` the
    3x3/s2 max-pool after the stem (``cuda_pool.max_pool_int8``). Both
    defaults are kernels on CUDA tensors and their twins on CPU ones;
    ``cuda_stem.quant_s2d_reference`` and ``cuda_pool.max_pool_int8_reference``
    run the twins on the card too, and ``library.aot_impl`` the custom ops;
    ``impl["layer1"]`` .. ``impl["layer4"]`` run a stage's stride-1 blocks
    (e.g. ``cuda_bottleneck.chain_int8``, one fused launch per stage; the
    JAX engine's W padding to 32 columns was a TPU constraint and is gone);
    ``impl["conv2_s1"]["l{s}b{b}"]`` and ``impl["head_conv{i}"]`` replace
    one conv, ``(x_q, qc) -> x_q`` (the Winograd convs,
    ``winograd.wino_impl_hooks``; a stage with a chain hook ignores its
    ``conv2_s1`` hooks); ``conv`` runs every other int8 conv
    (:func:`kernel_conv`, or :func:`plain_conv`).
    """
    impl = impl or {}
    stem = q["stem"]
    if stem["wq"].shape[0] == 4:  # space-to-depth stem (quant.s2d_stem_weights)
        src = images if images.dtype in (torch.uint8, torch.float32) \
            else images.to(torch.float32)
        xs = impl.get("stem_front", cuda_stem.quant_s2d)(src, q["s_img"])
        x_q = conv(xs, stem, 1, ((2, 1), (2, 1)), "relu")
    else:
        x_q = cuda_stem.quantize_input(_normalize_if_uint8(images), q["s_img"])
        x_q = conv(x_q, stem, 2, 3, "relu")
    with tracing.span("engine.max_pool"):
        x_q = impl.get("max_pool", cuda_pool.max_pool_int8)(x_q)

    for si, blocks in enumerate(q["layers"]):
        # impl[f"layer{i}"] is a stage-chain hook (x_q, qblocks) -> x_q over
        # the stage's stride-1 blocks (serving/cuda_bottleneck.py::chain_int8).
        # Stride-2 transition blocks (layers 2-4) stay on ``_block``; layer1's
        # stride-1 transition, downsample included, is part of its chain.
        chain_fn = impl.get(f"layer{si + 1}")
        if chain_fn is None:
            s1 = impl.get("conv2_s1", {})
            for bi, qb in enumerate(blocks):
                x_q = _block(x_q, qb, 2 if (si > 0 and bi == 0) else 1, conv,
                             s1.get(f"l{si + 1}b{bi}"))
            continue
        start = 0
        if si > 0:
            x_q = _block(x_q, blocks[0], 2, conv)
            start = 1
        if start < len(blocks):  # a stage of only its transition has no chain
            x_q = chain_fn(x_q, blocks[start:])

    head = q["head"]
    for i, stride in ((1, 1), (2, 2), (3, 1), (4, 1)):
        conv_fn = impl.get(f"head_conv{i}")
        if conv_fn is not None:
            x_q = conv_fn(x_q, head[f"conv{i}"])
        else:
            x_q = conv(x_q, head[f"conv{i}"], stride, 1, "leaky")

    n = x_q.shape[0]
    fc1 = head["fc1"]
    with _exact_float32_matmul():
        if "wq" in fc1:
            # int8 fc1: the int8 head activation, flattened in (H, W, C)
            # order, as a 1x1 conv; epilogue acc * m + b in float32.
            qc = {"wq": fc1["wq"].reshape(1, 1, *fc1["wq"].shape), "m": fc1["m"],
                  "t": fc1["b"]}
            if "wk" in fc1:
                qc["wk"] = fc1["wk"]
            x = conv(x_q.reshape(n, 1, 1, -1), qc, 1, 0, "float").reshape(n, -1)
        else:
            x = x_q.to(torch.bfloat16) * head["s_out4"].to(torch.bfloat16)
            x = torch.matmul(x.reshape(n, -1).float(), _fc_weight(fc1)) + fc1["b"]
        x = torch.where(x > 0, x, 0.1 * x).to(torch.bfloat16)
        x = torch.matmul(x.float(), _fc_weight(head["fc2"])) + head["fc2"]["b"]
    return x.reshape(n, S, S, -1)


def default_impl() -> Dict:
    """``{}``: :func:`int8_forward` runs the stem-front and max-pool kernels
    without a hook. A shim kept only for ``portbench/systems.py``, which
    still passes it."""
    return {}


def to_device(q: Dict, device) -> Dict:
    """q-params (torch tensors or numpy arrays, JAX layout) on ``device``, plus
    each int8 layer's packed kernel weight ``wk`` and each Winograd conv's
    packed weight taps ``uk`` on CUDA, and float32 copies ``wf`` of the
    bfloat16 FC weights."""
    device = torch.device(device)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items() if k not in DERIVED_KEYS}
            if "uq" in out and device.type == "cuda":
                out["uk"] = cuda_wino.pack_taps(out["uq"])
            if "wq" in out and device.type == "cuda":
                wq = out["wq"]
                out["wk"] = cuda_int8.pack_weight(wq if wq.dim() == 4 else wq[None, None])
            if "w" in out and out["w"].dtype == torch.bfloat16:
                out["wf"] = out["w"].float()
            return out
        return torch.as_tensor(node).to(device)

    return walk(q)


def load_artifact(path, model, device) -> tuple:
    """A saved engine (.npz): (q on ``device``, impl, meta).

    No fold and no calibration. Raises ValueError when the artifact's S, B
    or class count differs from ``model``'s; with ``model`` None the
    geometry is the artifact's own (``meta``). A Winograd engine's convs get
    their hooks back (never a silent direct conv).
    """
    from yolo_tpu_torch.serving.export import load_engine
    from yolo_tpu_torch.serving.winograd import wino_impl_hooks, wino_points_of

    q, meta = load_engine(path)
    for attr in ("S", "B", "num_classes"):
        if model is not None and getattr(model, attr) != meta[attr]:
            raise ValueError(
                f"engine artifact {path} was exported for {attr}={meta[attr]} but the"
                f" model has {getattr(model, attr)}")
    q = to_device(q, device)
    return q, wino_impl_hooks(wino_points_of(q)), meta


def make_int8_engine_fn(S: int, B: int, num_classes: int, impl: Optional[Dict] = None,
                        nms_fn=None, conv: Callable = kernel_conv):
    """(q, images, conf, nms) -> Detections serving function.

    ``q`` as :func:`to_device` returns it, on the images' device. ``nms_fn``
    defaults to the NMS kernel's wrapper (ops/cuda_nms.py::nms).
    """
    nms_fn = nms_fn or cuda_nms.nms

    @torch.inference_mode()
    def predict(q, images, conf_threshold, nms_threshold) -> Detections:
        preds = int8_forward(q, images, S=S, impl=impl, conv=conv)
        dets = decode_predictions(preds.float(), S, B, num_classes, conf_threshold)
        return nms_fn(dets, nms_threshold)

    return predict


def make_sharded_int8_engine_fn(mesh, S: int, B: int, num_classes: int,
                                impl: Optional[Dict] = None, nms_fn=None):
    """Data-parallel serving (JAX engine.py:372-415): ``predict(q, images,
    conf, nms)`` on a global batch, of which each data rank runs its rows
    (``parallel.batch_slice``) through the int8 engine with no collective,
    returning its own ``Detections``; :func:`gather_detections` joins them.

    q-params are replicated: every rank holds them on its device. The stem
    front stays the kernel: JAX drops it under a mesh only because Mosaic's
    custom call has no GSPMD partitioning rule. The global batch must
    divide by the data axis (pad ragged batches: ``data.pad_batch``).
    """
    from yolo_tpu_torch.parallel.mesh import batch_slice

    fn = make_int8_engine_fn(S, B, num_classes, impl=impl, nms_fn=nms_fn)

    def predict(q, images, conf_threshold, nms_threshold) -> Detections:
        return fn(q, batch_slice(mesh, images), conf_threshold, nms_threshold)

    return predict


def gather_detections(mesh, dets: Detections) -> Detections:
    """Every data rank's ``Detections`` in global row order, on the CPU."""
    from yolo_tpu_torch.parallel.mesh import gather

    group = mesh.get_group("data")
    return Detections(*(gather(t, group) for t in dets))


def build_int8_predict(model, calibration_images, impl=None, nms_fn=None, stem_mode="s2d",
                       fc1_mode="int8", wino=()):
    """One-stop build: fold -> calibrate -> quantize -> predict function.

    ``model``: a ResNet ``YOLOv1`` (weights loaded) on the engine's device.
    ``calibration_images``: iterable of (n, H, W, 3) normalized float batches;
    calibration runs the folded forward in bfloat16, as the JAX engine does.
    ``wino``: conv names ("head_conv1", "l3b1_conv2", ...) run as per-tap
    int8 Winograd convs; their calibration points, params and ``impl``
    hooks (``winograd.wino_impl_hooks``) are added here.
    Returns (predict_fn, q_params), q on the model's device with its
    packed weights.
    """
    from yolo_tpu_torch.serving.fold import fold_flagship
    from yolo_tpu_torch.serving.quant import calibrate_activations, quantize_folded
    from yolo_tpu_torch.serving.winograd import wino_impl_hooks

    device = next(model.parameters()).device
    with tracing.span("engine.build"), torch.inference_mode():
        folded = fold_flagship(model.state_dict())
        act_max = calibrate_activations(folded, calibration_images, dtype=torch.bfloat16,
                                        wino_points=wino)
        q = to_device(quantize_folded(folded, act_max, stem_mode=stem_mode,
                                      fc1_mode=fc1_mode, wino=wino), device)
    if wino:
        impl = wino_impl_hooks(wino, impl)
    fn = make_int8_engine_fn(model.S, model.B, model.num_classes, impl=impl, nms_fn=nms_fn)
    return fn, q
