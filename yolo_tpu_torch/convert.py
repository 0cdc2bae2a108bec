"""JAX variables -> the port's state dict (the inverse of yolo_tpu/convert.py).

The port names its parameters exactly as the reference does, so a reference
``.pth`` loads into it natively and ``yolo_tpu.convert.
convert_reference_state_dict(model.state_dict())`` maps the port's weights
back to JAX variables. This module goes the other way, for JAX ``.ckpt``
checkpoints: ``{'params', 'batch_stats'}`` trees of numpy arrays become a
state dict. Three layout changes:

- conv kernels: flax HWIO -> torch OIHW;
- linear weights: flax (in, out) -> torch (out, in);
- fc1, whose input is the flattened head map: flax flattens (H, W, C), torch
  (C, H, W), so its columns are re-indexed (undoing yolo_tpu/convert.py::
  _t_linear_from_flatten).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"layer(\d+)_block(\d+)$")
_HEAD_CONVS = {"conv1": 0, "conv2": 2, "conv3": 4, "conv4": 6}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(sd: Dict, name: str, node: Mapping, bias: bool = False) -> None:
    core = node["Conv_0"]
    sd[f"{name}.weight"] = _tensor(np.transpose(np.asarray(core["kernel"]), (3, 2, 0, 1)))
    if bias:
        sd[f"{name}.bias"] = _tensor(core["bias"])


def _bn(sd: Dict, name: str, params: Mapping, stats: Mapping) -> None:
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _fc1_from_flax(kernel: np.ndarray, channels: int = 1024) -> np.ndarray:
    """(in, out) with (H, W, C) rows -> (out, in) with (C, H, W) columns."""
    in_dim, out_dim = kernel.shape
    side = math.isqrt(in_dim // channels)
    w = np.asarray(kernel).T.reshape(out_dim, side, side, channels)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, in_dim)


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of a JAX ResNet YOLOv1 -> the port's state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    bb_p, bb_s = params["backbone"], stats.get("backbone", {})
    if "conv1" not in bb_p:
        raise NotImplementedError(
            "only the ResNet backbone is ported; this checkpoint holds another"
        )
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "backbone.extractor.0", bb_p["conv1"])
    _bn(sd, "backbone.extractor.1", bb_p["bn1"], bb_s["bn1"])
    for key in bb_p:
        m = _BLOCK.match(key)
        if m is None:
            continue
        stage, block = int(m.group(1)), int(m.group(2))
        base = f"backbone.extractor.{3 + stage}.{block}"
        blk_p, blk_s = bb_p[key], bb_s[key]
        for i in (1, 2, 3):
            _conv(sd, f"{base}.conv{i}", blk_p[f"conv{i}"])
            _bn(sd, f"{base}.bn{i}", blk_p[f"bn{i}"], blk_s[f"bn{i}"])
        if "downsample_conv" in blk_p:
            _conv(sd, f"{base}.downsample.0", blk_p["downsample_conv"])
            _bn(sd, f"{base}.downsample.1", blk_p["downsample_bn"], blk_s["downsample_bn"])

    head = params["detection_head"]
    for name, idx in _HEAD_CONVS.items():
        _conv(sd, f"head.conv_layers.{idx}", head[name], bias=True)
    fc1, fc2 = head["fc1"]["Dense_0"], head["fc2"]["Dense_0"]
    sd["head.fc_layers.1.weight"] = _tensor(_fc1_from_flax(np.asarray(fc1["kernel"])))
    sd["head.fc_layers.1.bias"] = _tensor(fc1["bias"])
    sd["head.fc_layers.4.weight"] = _tensor(np.asarray(fc2["kernel"]).T)
    sd["head.fc_layers.4.bias"] = _tensor(fc2["bias"])
    return sd


def resnet_layout(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Tuple[int, ...], int]:
    """(stage_sizes, image_size) of the ResNet YOLOv1 a state dict was made for.

    Stage sizes count the bottleneck blocks under ``backbone.extractor.4..``;
    the image size follows from fc1's input width (1024 * side * side, and
    every stride-2 layer halves the side).
    """
    blocks: Dict[int, int] = {}
    for key in state_dict:
        m = re.match(r"backbone\.extractor\.(\d+)\.(\d+)\.conv1\.weight$", key)
        if m:
            stage = int(m.group(1)) - 4
            blocks[stage] = max(blocks.get(stage, 0), int(m.group(2)) + 1)
    stage_sizes = tuple(blocks[s] for s in range(len(blocks)))
    side = math.isqrt(state_dict["head.fc_layers.1.weight"].shape[1] // 1024)
    return stage_sizes, side * 2 ** (len(stage_sizes) + 2)
