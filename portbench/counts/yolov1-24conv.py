"""Layers of ``yolov1-24conv`` (Redmon et al. 2016, Fig. 3) as the
dynamic-int8 model runs them: 24 int8 convs with the "float" epilogue, then
fc1 and fc2 in float32 (TF32 off)."""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.conv import Conv


def convs(cfg) -> List[Conv]:
    h, cin, out = cfg["image_size"], 3, []
    for i, layer in enumerate(cfg["layers"]):
        if layer == "M":
            h //= 2
            continue
        cout, k, s, p = layer
        c = Conv(f"conv{len(out) + 1}", h, h, cin, cout, k, s, p, "float")
        out.append(c)
        h, cin = c.out_hw[0], cout
    return out


def feature_side(cfg) -> int:
    h = cfg["image_size"]
    for layer in cfg["layers"]:
        if layer == "M":
            h //= 2
        else:
            _, k, s, p = layer
            h = (h + 2 * p - k) // s + 1
    return h


def fc_macs(cfg) -> int:
    fin = cfg["layers"][-1][0] * feature_side(cfg) ** 2
    out = cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])
    return fin * cfg["fc_hidden"] + cfg["fc_hidden"] * out


def int8_convs(cfg, engine: str) -> List[Conv]:
    if engine != "dyn8":
        raise ValueError(f"no int8 convs counted for engine {engine!r}")
    return convs(cfg)


def ops_per_image(cfg, engine: str) -> Dict[str, int]:
    conv_ops = 2 * sum(c.macs() for c in convs(cfg))
    if engine == "dyn8":
        return {"int8": conv_ops, "fp32": 2 * fc_macs(cfg)}
    if engine == "train":
        return {"bf16": conv_ops + 2 * fc_macs(cfg)}
    raise ValueError(f"unknown engine {engine!r}")
