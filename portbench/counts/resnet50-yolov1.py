"""Layers of ``resnet50-yolov1`` as the int8 engine and training run them.

:func:`convs` lists every conv of the model per image in its own geometry
(the stem 7x7/s2 on 3 channels, whatever form the engine gives it), fc1 as a
1x1 conv over the flattened head map, in the engine's order; the int8 engine
runs all of them as int8 convs. :func:`ops_per_image` gives the forward's
operations by the precision each runs in.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.conv import Conv


def _side(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def convs(cfg) -> List[Conv]:
    h = cfg["image_size"]
    out = [Conv("stem", h, h, 3, 64, 7, 2, 3)]
    h = _side(_side(h, 7, 2, 3), 3, 2, 1)  # the stem, then the 3x3/s2 max-pool
    cin = 64
    for si, n in enumerate(cfg["stage_sizes"]):
        planes = 64 * 2 ** si
        for b in range(n):
            s = 2 if (si > 0 and b == 0) else 1
            tag = f"l{si + 1}b{b}"
            out.append(Conv(f"{tag}.conv1", h, h, cin, planes, 1, 1, 0))
            out.append(Conv(f"{tag}.conv2", h, h, planes, planes, 3, s, 1))
            ho = _side(h, 3, s, 1)
            if b == 0:
                out.append(Conv(f"{tag}.downsample", h, h, cin, planes * 4, 1, s, 0, "none"))
            out.append(Conv(f"{tag}.conv3", ho, ho, planes, planes * 4, 1, 1, 0, "residual"))
            h, cin = ho, planes * 4
    hc = cfg["head_channels"]
    for i in range(4):
        s = 2 if i == 1 else 1
        out.append(Conv(f"head.conv{i + 1}", h, h, cin, hc, 3, s, 1, "leaky"))
        h, cin = _side(h, 3, s, 1), hc
    out.append(Conv("head.fc1", 1, 1, cin * h * h, cfg["fc_hidden"], 1, 1, 0, "float"))
    return out


def fc2_macs(cfg) -> int:
    return cfg["fc_hidden"] * cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])


def int8_convs(cfg, engine: str) -> List[Conv]:
    """The int8 conv kernel's calls of one forward (the int8 engine: all 58)."""
    if engine != "int8":
        raise ValueError(f"no int8 convs counted for engine {engine!r}")
    return convs(cfg)


def ops_per_image(cfg, engine: str) -> Dict[str, int]:
    """Operations of one image's forward by the precision they run in: the
    int8 engine's convs and fc1 in int8, fc2 in float32 (bf16-valued); the
    training forward all in bf16 (autocast)."""
    conv_ops = 2 * sum(c.macs() for c in convs(cfg))
    fc2 = 2 * fc2_macs(cfg)
    if engine == "int8":
        return {"int8": conv_ops, "fp32": fc2}
    if engine == "train":
        return {"bf16": conv_ops + fc2}
    raise ValueError(f"unknown engine {engine!r}")
