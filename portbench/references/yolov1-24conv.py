"""Plain reference of ``yolov1-24conv``: the original YOLOv1 (Redmon et al.,
CVPR 2016, Fig. 3): the 24 convs of the configuration's ``layers`` (each
with a bias and LeakyReLU 0.1, 2x2/2 max-pools at the "M" entries), then
fc 50176 -> 4096 -> LeakyReLU -> dropout 0.5 -> 1470, 448x448, S=7, B=2,
20 classes.

:func:`prepare` and :func:`serve` give the dynamic-int8 inference model's
semantics: per call and per conv, one activation scale over the whole batch
``s_x = max(max|x| / qmax, 1e-8)``, per-output-channel weight scales
``s_w = max(max|w| / qmax, 1e-8)``, an exact integer accumulator and
``y = acc * (s_x * s_w) + bias`` in float32; the FC layers in float32 with
TF32 off; decode and NMS (``detect.py``). ``qmax`` 127 is int8, 7 the int4
control.

Imports nothing of ``yolo_tpu_torch``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.references import detect


def _conv_indices(cfg) -> List[int]:
    """Index of each conv in the program's flat ``features`` list (a conv and
    its activation take two places, a pool one)."""
    out, i = [], 0
    for layer in cfg["layers"]:
        if layer == "M":
            i += 1
        else:
            out.append(i)
            i += 2
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


def param_spec(cfg) -> list:
    spec, cin = [], 3
    convs = [layer for layer in cfg["layers"] if layer != "M"]
    for idx, (cout, k, _, _) in zip(_conv_indices(cfg), convs):
        fan = cin * k * k
        spec += [(f"backbone.features.{idx}.weight", (cout, cin, k, k), "he", fan),
                 (f"backbone.features.{idx}.bias", (cout,), "bias", fan)]
        cin = cout
    fin = cin * feature_side(cfg) ** 2
    hidden = cfg["fc_hidden"]
    out = cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])
    spec += [("head.1.weight", (hidden, fin), "he", fin), ("head.1.bias", (hidden,), "bias", fin),
             ("head.4.weight", (out, hidden), "default", hidden),
             ("head.4.bias", (out,), "bias", hidden)]
    return spec


def prepare(cfg, sd, calibration_uint8=None, qmax: int = 127) -> Dict:
    """The integer weights and their scales; no calibration (scales are per call)."""
    convs = []
    for idx in _conv_indices(cfg):
        wq, s_w = detect.quantize_weight(sd[f"backbone.features.{idx}.weight"], qmax, 1e-8)
        convs.append((wq, s_w, sd[f"backbone.features.{idx}.bias"].float()))
    return {"qmax": qmax, "convs": convs,
            "fc1": (sd["head.1.weight"].float(), sd["head.1.bias"].float()),
            "fc2": (sd["head.4.weight"].float(), sd["head.4.bias"].float())}


@torch.inference_mode()
def forward(cfg, state, images_uint8: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """uint8 (n, H, W, 3) -> (n, S, S, B*5+C) float32; each conv over the whole
    batch (one activation scale), its exact accumulator in blocks of ``rows``."""
    qmax = state["qmax"]
    qm = detect.f32(float(qmax), images_uint8.device)
    x = detect.normalize(images_uint8)  # NHWC float32
    it = iter(state["convs"])
    for layer in cfg["layers"]:
        if layer == "M":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            continue
        _, _, stride, pad = layer
        wq, s_w, b = next(it)
        s_x = torch.clamp(x.abs().amax() / qm, min=1e-8)
        xq = detect.quantize(x, s_x, qmax)
        m = s_x * s_w
        x = torch.cat([detect.requant(detect.conv_acc(xq[i:i + rows], wq, stride, pad), m, b,
                                      "float", qmax)
                       for i in range(0, xq.shape[0], rows)])
        x = torch.where(x > 0, x, detect.LEAKY * x)
    n = x.shape[0]
    x = x.permute(0, 3, 1, 2).reshape(n, -1)  # (C, H, W), as fc1 reads
    with detect.exact_float32():
        x = F.linear(x, *state["fc1"])
        x = torch.where(x > 0, x, detect.LEAKY * x)
        x = F.linear(x, *state["fc2"])
    S = cfg["S"]
    return x.reshape(n, S, S, -1)


def serve(cfg, state, images_uint8, conf: float, iou: float) -> detect.Dets:
    """Detections of one served batch (its composition sets the activation scales)."""
    d = detect.decode(forward(cfg, state, images_uint8), cfg["S"], cfg["B"],
                      cfg["num_classes"], conf)
    return detect.nms(d, iou)
