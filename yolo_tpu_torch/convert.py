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

The layout changes are permutations, so they carry optax's Adam moments (a
tree shaped like the params) into torch's ``exp_avg``/``exp_avg_sq`` too
(:func:`params_state_dict_from_jax`). :func:`state_dict_from_torchvision_resnet50`
renames a torchvision ``resnet50`` state dict onto the backbone, for
``--pretrained-backbone``.
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


def _bn(sd: Dict, name: str, params: Mapping, stats: Mapping | None) -> None:
    p = params["BatchNorm_0"]
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    if stats is not None:
        s = stats["BatchNorm_0"]
        sd[f"{name}.running_mean"] = _tensor(s["mean"])
        sd[f"{name}.running_var"] = _tensor(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _fc1_from_flax(kernel: np.ndarray, channels: int = 1024) -> np.ndarray:
    """(in, out) with (H, W, C) rows -> (out, in) with (C, H, W) columns."""
    in_dim, out_dim = kernel.shape
    side = math.isqrt(in_dim // channels)
    w = np.asarray(kernel).T.reshape(out_dim, side, side, channels)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, in_dim)


def block_state_dict_from_jax(
    params: Mapping, stats: Mapping | None, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """One JAX ``Bottleneck``'s variables -> a port ``Bottleneck``'s state dict.

    ``stats`` None converts the parameters alone (e.g. Adam moments).
    """
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _conv(sd, f"{prefix}conv{i}", params[f"conv{i}"])
        _bn(sd, f"{prefix}bn{i}", params[f"bn{i}"],
            None if stats is None else stats[f"bn{i}"])
    if "downsample_conv" in params:
        _conv(sd, f"{prefix}downsample.0", params["downsample_conv"])
        _bn(sd, f"{prefix}downsample.1", params["downsample_bn"],
            None if stats is None else stats["downsample_bn"])
    return sd


def backbone_state_dict_from_jax(
    params: Mapping, stats: Mapping | None, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """A JAX ``ResNetBackbone``'s variables -> the port's ``extractor.*`` names."""
    if "conv1" not in params:
        raise NotImplementedError(
            "only the ResNet backbone is ported; this checkpoint holds another"
        )
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}extractor.0", params["conv1"])
    _bn(sd, f"{prefix}extractor.1", params["bn1"], None if stats is None else stats["bn1"])
    for key in params:
        m = _BLOCK.match(key)
        if m is None:
            continue
        stage, block = int(m.group(1)), int(m.group(2))
        sd.update(block_state_dict_from_jax(
            params[key], None if stats is None else stats[key],
            f"{prefix}extractor.{3 + stage}.{block}."))
    return sd


def params_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A params-shaped JAX tree (weights, or optax's Adam moments) -> the
    port's parameter names and layouts, without BN running statistics."""
    return _model_state_dict(params, None)


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of a JAX ResNet YOLOv1 -> the port's state dict."""
    return _model_state_dict(variables["params"], variables.get("batch_stats", {}))


def _model_state_dict(params: Mapping, stats: Mapping | None) -> Dict[str, torch.Tensor]:
    sd = backbone_state_dict_from_jax(
        params["backbone"], None if stats is None else stats.get("backbone", {}),
        "backbone.")
    head = params["detection_head"]
    for name, idx in _HEAD_CONVS.items():
        _conv(sd, f"head.conv_layers.{idx}", head[name], bias=True)
    fc1, fc2 = head["fc1"]["Dense_0"], head["fc2"]["Dense_0"]
    sd["head.fc_layers.1.weight"] = _tensor(_fc1_from_flax(np.asarray(fc1["kernel"])))
    sd["head.fc_layers.1.bias"] = _tensor(fc1["bias"])
    sd["head.fc_layers.4.weight"] = _tensor(np.asarray(fc2["kernel"]).T)
    sd["head.fc_layers.4.bias"] = _tensor(fc2["bias"])
    return sd


def state_dict_from_torchvision_resnet50(
    state_dict: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet50`` state dict -> the port's ``backbone.*`` names.

    ``conv1`` -> ``extractor.0``, ``bn1`` -> ``extractor.1``, ``layerK`` ->
    ``extractor.{K+3}``; ``fc`` is dropped (yolo_tpu/convert.py::
    convert_torchvision_resnet50 does the same for JAX). Load the result
    with ``model.load_state_dict(sd, strict=False)``.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        head, _, rest = key.partition(".")
        if head == "conv1":
            out[f"backbone.extractor.0.{rest}"] = value
        elif head == "bn1":
            out[f"backbone.extractor.1.{rest}"] = value
        elif re.fullmatch(r"layer[1-4]", head):
            out[f"backbone.extractor.{int(head[5]) + 3}.{rest}"] = value
        elif head != "fc":
            raise ValueError(f"not a torchvision resnet50 key: {key}")
    return out


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
