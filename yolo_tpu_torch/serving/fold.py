"""BatchNorm folding: the port's state dict -> flat eval-time serving parameters.

Port of yolo_tpu/serving/fold.py. Every conv+BN pair of the ResNet50
backbone collapses to one conv with per-output-channel scaled weights and a
bias:

    BN(conv(x)) = (w * g) * x + (beta - mean * g),   g = gamma / sqrt(var + eps)

The head's convs and FCs carry real biases and no BN and pass through.

The folded dict is in the JAX package's layout, so that it, the q-params
built from it and the ``.npz`` engine artifact mean the same on both sides:
conv weights HWIO, FC weights (in, out), and fc1's rows in flax's (H, W, C)
flatten order (the inverse of ``yolo_tpu_torch.convert._fc1_from_flax``).
``folded_forward`` is the float forward on it, NHWC at its interface, and
the calibration oracle of ``serving.quant``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch's default, as in models/layers.py

_BLOCK = re.compile(r"backbone\.extractor\.(\d+)\.(\d+)\.conv1\.weight$")
_HEAD_CONVS = {"conv1": 0, "conv2": 2, "conv3": 4, "conv4": 6}


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> HWIO."""
    return w.permute(2, 3, 1, 0).contiguous()


def _fold_conv_bn(sd: Mapping[str, torch.Tensor], conv: str, bn: str):
    """(folded HWIO kernel, folded bias) for a bias-free conv followed by BN."""
    gamma = sd[f"{bn}.weight"].float()
    beta = sd[f"{bn}.bias"].float()
    mean = sd[f"{bn}.running_mean"].float()
    var = sd[f"{bn}.running_var"].float()
    g = gamma / torch.sqrt(var + BN_EPS)
    w = _hwio(sd[f"{conv}.weight"].float()) * g  # broadcast over the trailing (out) axis
    b = beta - mean * g
    return w, b


def fc1_to_flax(weight: torch.Tensor, channels: int = 1024) -> torch.Tensor:
    """torch (out, in) with (C, H, W) columns -> flax (in, out) with (H, W, C) rows."""
    out_dim, in_dim = weight.shape
    side = math.isqrt(in_dim // channels)
    w = weight.reshape(out_dim, channels, side, side).permute(0, 2, 3, 1)
    return w.reshape(out_dim, in_dim).t().contiguous()


def fold_flagship(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Fold a ResNet YOLOv1 state dict (the port's names) for serving.

    Returns::

        {"stem": {"w", "b"},
         "layers": [[block, ...] x 4],   # block: conv1/conv2/conv3 {"w","b"},
                                         # "downsample": {"w","b"} | None
         "head": {"conv1".."conv4", "fc1", "fc2": {"w", "b"}}}

    with float32 tensors on the state dict's device.
    """
    sd = state_dict
    out: Dict = {}
    w, b = _fold_conv_bn(sd, "backbone.extractor.0", "backbone.extractor.1")
    out["stem"] = {"w": w, "b": b}

    blocks = sorted((int(m.group(1)), int(m.group(2)))
                    for m in map(_BLOCK.match, sd) if m is not None)
    layers: list = [[] for _ in range(len({s for s, _ in blocks}))]
    for stage, idx in blocks:
        p = f"backbone.extractor.{stage}.{idx}"
        block = {}
        for i in (1, 2, 3):
            w, b = _fold_conv_bn(sd, f"{p}.conv{i}", f"{p}.bn{i}")
            block[f"conv{i}"] = {"w": w, "b": b}
        if f"{p}.downsample.0.weight" in sd:
            w, b = _fold_conv_bn(sd, f"{p}.downsample.0", f"{p}.downsample.1")
            block["downsample"] = {"w": w, "b": b}
        else:
            block["downsample"] = None
        layers[stage - 4].append(block)
    out["layers"] = layers

    head: Dict = {}
    for name, idx in _HEAD_CONVS.items():
        head[name] = {"w": _hwio(sd[f"head.conv_layers.{idx}.weight"].float()),
                      "b": sd[f"head.conv_layers.{idx}.bias"].float()}
    head["fc1"] = {"w": fc1_to_flax(sd["head.fc_layers.1.weight"].float()),
                   "b": sd["head.fc_layers.1.bias"].float()}
    head["fc2"] = {"w": sd["head.fc_layers.4.weight"].float().t().contiguous(),
                   "b": sd["head.fc_layers.4.bias"].float()}
    out["head"] = head
    return out


# --------------------------------------------------------------- float forward
def _conv(x, w, stride=1, pad=0, dtype=torch.float32):
    """NCHW ``x`` with an HWIO kernel; the result in float32."""
    y = F.conv2d(x.to(dtype), w.permute(3, 2, 0, 1).to(dtype), stride=stride, padding=pad)
    return y.float()


def folded_forward(folded: Dict, images: torch.Tensor, dtype=torch.float32, stats=None,
                   S: int = 7, wino_points=()) -> torch.Tensor:
    """Eval forward on folded params: (N, H, W, 3) -> (N, S, S, B*5+C) float32.

    ``stats`` (optional dict) collects max |activation| at every int8
    quantization point as 0-dim float32 tensors, under the keys of
    ``quant.act_points``. ``wino_points`` names stride-1 3x3 convs
    ("head_conv1", "l3b1_conv2", ...) whose input also gets its (16,)
    per-tap Winograd maxima recorded under ``{name}_wtap``
    (``winograd.tap_maxima``). ``dtype`` is the operand type of the convs and
    FCs (float32, or bfloat16 for calibration); sums and results are float32.
    """
    leaky = lambda v: torch.where(v > 0, v, 0.1 * v)  # noqa: E731

    def record(name, v):
        if stats is not None:
            stats[name] = v.abs().amax().float()

    def record_wtap(name, v):
        if stats is not None and name in wino_points:
            from yolo_tpu_torch.serving.winograd import tap_maxima

            stats[f"{name}_wtap"] = tap_maxima(v.permute(0, 2, 3, 1))

    x = images.to(dtype).float() if dtype != torch.float32 else images.float()
    record("input", x)
    x = x.permute(0, 3, 1, 2)
    x = torch.relu(_conv(x, folded["stem"]["w"], 2, 3, dtype) + _bias(folded["stem"]["b"]))
    x = F.max_pool2d(x, 3, 2, 1)
    record("stem", x)

    for si, blocks in enumerate(folded["layers"]):
        for bi, blk in enumerate(blocks):
            tag = f"l{si + 1}b{bi}"
            stride = 2 if (si > 0 and bi == 0) else 1
            identity = x
            y = torch.relu(_conv(x, blk["conv1"]["w"], 1, 0, dtype) + _bias(blk["conv1"]["b"]))
            record(f"{tag}_y1", y)
            if stride == 1:
                record_wtap(f"{tag}_conv2", y)
            y = torch.relu(_conv(y, blk["conv2"]["w"], stride, 1, dtype)
                           + _bias(blk["conv2"]["b"]))
            record(f"{tag}_y2", y)
            y = _conv(y, blk["conv3"]["w"], 1, 0, dtype) + _bias(blk["conv3"]["b"])
            if blk["downsample"] is not None:
                identity = (_conv(x, blk["downsample"]["w"], stride, 0, dtype)
                            + _bias(blk["downsample"]["b"]))
                # The int8 engine quantizes the downsample branch at its own
                # scale, so calibration records the branch's range too.
                record(f"{tag}_ds", identity)
            x = torch.relu(y + identity)
            record(f"{tag}_out", x)

    head = folded["head"]
    for i, stride in ((1, 1), (2, 2), (3, 1), (4, 1)):
        conv = head[f"conv{i}"]
        if stride == 1:
            record_wtap(f"head_conv{i}", x)
        x = leaky(_conv(x, conv["w"], stride, 1, dtype) + _bias(conv["b"]))
        record(f"head_conv{i}", x)

    n = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(n, -1)  # flax's (H, W, C) flatten order
    x = leaky(_dot(x, head["fc1"]["w"], dtype) + head["fc1"]["b"])
    x = _dot(x, head["fc2"]["w"], dtype) + head["fc2"]["b"]
    return x.reshape(n, S, S, -1)


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(1, -1, 1, 1)


def _dot(x, w, dtype):
    return torch.matmul(x.to(dtype), w.to(dtype)).float()
