"""Plain reference of ``resnet50-yolov1``: ResNet-50 (v1.5, He et al. 2015)
with the YOLOv1 detection head of mattiaskvist/yolo-v1 ``src/yolo/models.py``
(four 3x3 convs to 1024 channels, the second with stride 2, LeakyReLU 0.1;
fc 50176 -> 4096 -> LeakyReLU -> dropout 0.5 -> 1470), 448x448 input,
S=7, B=2, 20 classes.

- :func:`param_spec`: the state dict's names, shapes and init roles.
- :func:`build_int8` and :func:`serve_int8`: the int8 serving engine's
  semantics. BN folded into each conv; activation scales from the maxima of
  a bfloat16 forward of the folded model over the calibration images;
  symmetric per-output-channel weights and per-tensor activations; each conv
  an exact integer accumulator with ``acc * m + t`` and its activation,
  rounded half to even and clipped; the uint8 input normalized then
  quantized; fc1 integer with a float32 epilogue; fc2 in float32 on
  bfloat16-rounded values and weights; decode and NMS
  (``detect.py``). ``qmax`` 127 is int8; 7 is the int4 control.
- :func:`train_steps`: the training step (bf16 autocast forward, the YOLOv1
  loss in float32, backward, global-norm clip, Adam with L2 decay).

Imports nothing of ``yolo_tpu_torch``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.references import detect

BN_EPS = 1e-5


# ------------------------------------------------------------------ structure
def _blocks(cfg):
    """(stage, index, name prefix, planes, stride, has downsample) of every bottleneck."""
    for s, n in enumerate(cfg["stage_sizes"]):
        for b in range(n):
            yield (s, b, f"backbone.extractor.{4 + s}.{b}", 64 * 2 ** s,
                   2 if (s > 0 and b == 0) else 1, b == 0)


def head_side(cfg) -> int:
    h = cfg["image_size"]
    for _ in range(2 + (len(cfg["stage_sizes"]) - 1) + 1):
        h = (h - 1) // 2 + 1
    return h


def _bn(prefix: str, c: int, last: bool = False) -> list:
    return [(f"{prefix}.weight", (c,), "bn_gamma_last" if last else "bn_gamma", c),
            (f"{prefix}.bias", (c,), "bn_beta", c),
            (f"{prefix}.running_mean", (c,), "bn_mean", c),
            (f"{prefix}.running_var", (c,), "bn_var", c),
            (f"{prefix}.num_batches_tracked", (), "count", 0)]


def _conv(name: str, cout: int, cin: int, k: int, bias: bool = False) -> list:
    out = [(f"{name}.weight", (cout, cin, k, k), "he", cin * k * k)]
    if bias:
        out.append((f"{name}.bias", (cout,), "bias", cin * k * k))
    return out


def param_spec(cfg) -> list:
    spec = _conv("backbone.extractor.0", 64, 3, 7) + _bn("backbone.extractor.1", 64)
    inplanes = 64
    for _, _, p, planes, _, ds in _blocks(cfg):
        spec += _conv(f"{p}.conv1", planes, inplanes, 1) + _bn(f"{p}.bn1", planes)
        spec += _conv(f"{p}.conv2", planes, planes, 3) + _bn(f"{p}.bn2", planes)
        spec += _conv(f"{p}.conv3", planes * 4, planes, 1) + _bn(f"{p}.bn3", planes * 4, True)
        if ds:
            spec += _conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
            spec += _bn(f"{p}.downsample.1", planes * 4)
        inplanes = planes * 4
    hc = cfg["head_channels"]
    for i, cin in enumerate((inplanes, hc, hc, hc)):
        spec += _conv(f"head.conv_layers.{2 * i}", hc, cin, 3, bias=True)
    fin = hc * head_side(cfg) ** 2
    hidden = cfg["fc_hidden"]
    out = cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])
    spec += [("head.fc_layers.1.weight", (hidden, fin), "he", fin),
             ("head.fc_layers.1.bias", (hidden,), "bias", fin),
             ("head.fc_layers.4.weight", (out, hidden), "default", hidden),
             ("head.fc_layers.4.bias", (out,), "bias", hidden)]
    return spec


# ------------------------------------------------------------------ int8 serving
def _fold(sd, conv: str, bn: str):
    """BN folded into a bias-free conv: (w * g, beta - mean * g), g = gamma / sqrt(var + eps)."""
    g = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + BN_EPS)
    w = sd[f"{conv}.weight"].float() * g.reshape(-1, 1, 1, 1)
    return w, sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * g


def fold(cfg, sd) -> Dict:
    """Every conv+BN as one conv with a bias (OIHW weights); head as it is."""
    out = {"stem": _fold(sd, "backbone.extractor.0", "backbone.extractor.1"), "blocks": []}
    for _, _, p, _, stride, ds in _blocks(cfg):
        blk = {f"conv{i}": _fold(sd, f"{p}.conv{i}", f"{p}.bn{i}") for i in (1, 2, 3)}
        blk["ds"] = _fold(sd, f"{p}.downsample.0", f"{p}.downsample.1") if ds else None
        blk["stride"] = stride
        out["blocks"].append(blk)
    out["head"] = [(sd[f"head.conv_layers.{2 * i}.weight"].float(),
                    sd[f"head.conv_layers.{2 * i}.bias"].float()) for i in range(4)]
    out["fc1"] = (sd["head.fc_layers.1.weight"].float(), sd["head.fc_layers.1.bias"].float())
    out["fc2"] = (sd["head.fc_layers.4.weight"].float(), sd["head.fc_layers.4.bias"].float())
    return out


def _conv_bf16(x, w, stride, pad):
    """Calibration conv: bfloat16 operands, float32 result. The weight is
    handed over as an HWIO-contiguous tensor viewed OIHW, the layout in which
    the engine holds it, so that the same convolution algorithm runs."""
    w = w.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride,
                    padding=pad).float()


@torch.inference_mode()
def calibrate(cfg, folded, batches) -> Dict[str, float]:
    """max |activation| at every quantization point, over the calibration batches
    (normalized float NHWC), from a forward with bfloat16 operands."""
    leaky = lambda v: torch.where(v > 0, v, detect.LEAKY * v)  # noqa: E731
    maxes: Dict[str, float] = {}
    for images in batches:
        stats = {}
        x = images.to(torch.bfloat16).float()
        stats["input"] = x.abs().amax()
        x = x.permute(0, 3, 1, 2)
        w, b = folded["stem"]
        x = F.max_pool2d(torch.relu(_conv_bf16(x, w, 2, 3) + b.reshape(1, -1, 1, 1)), 3, 2, 1)
        stats["stem"] = x.abs().amax()
        for k, blk in enumerate(folded["blocks"]):
            s = blk["stride"]
            w1, b1 = blk["conv1"]
            y = torch.relu(_conv_bf16(x, w1, 1, 0) + b1.reshape(1, -1, 1, 1))
            stats[f"{k}_y1"] = y.abs().amax()
            w2, b2 = blk["conv2"]
            y = torch.relu(_conv_bf16(y, w2, s, 1) + b2.reshape(1, -1, 1, 1))
            stats[f"{k}_y2"] = y.abs().amax()
            w3, b3 = blk["conv3"]
            y = _conv_bf16(y, w3, 1, 0) + b3.reshape(1, -1, 1, 1)
            if blk["ds"] is not None:
                wd, bd = blk["ds"]
                x = _conv_bf16(x, wd, s, 0) + bd.reshape(1, -1, 1, 1)
                stats[f"{k}_ds"] = x.abs().amax()
            x = torch.relu(y + x)
            stats[f"{k}_out"] = x.abs().amax()
        for i, (w, b) in enumerate(folded["head"]):
            x = leaky(_conv_bf16(x, w, 2 if i == 1 else 1, 1) + b.reshape(1, -1, 1, 1))
            stats[f"head{i}"] = x.abs().amax()
        values = torch.stack(list(stats.values())).cpu().tolist()
        for key, v in zip(stats, values):
            maxes[key] = max(maxes.get(key, 0.0), v)
    return maxes


def _layer(w, b, s_in: float, s_out: float, qmax: int) -> Dict:
    wq, s_w = detect.quantize_weight(w, qmax, 1e-12)
    dev = w.device
    return {"wq": wq, "m": detect.f32(s_in, dev) * s_w / detect.f32(s_out, dev),
            "t": b.float() / detect.f32(s_out, dev)}


def build_int8(cfg, sd, calibration_uint8: List[torch.Tensor], qmax: int = 127) -> Dict:
    """Fold, calibrate on the uint8 calibration batches, quantize."""
    folded = fold(cfg, sd)
    with torch.inference_mode():
        act = calibrate(cfg, folded, [detect.normalize(b) for b in calibration_uint8])
        s = {k: max(v, 1e-12) / float(qmax) for k, v in act.items()}
        dev = folded["stem"][0].device
        q = {"qmax": qmax, "s_img": detect.f32(s["input"], dev),
             "stem": _layer(*folded["stem"], s["input"], s["stem"], qmax), "blocks": []}
        s_in = s["stem"]
        for k, blk in enumerate(folded["blocks"]):
            qb = {"stride": blk["stride"],
                  "conv1": _layer(*blk["conv1"], s_in, s[f"{k}_y1"], qmax),
                  "conv2": _layer(*blk["conv2"], s[f"{k}_y1"], s[f"{k}_y2"], qmax),
                  "conv3": _layer(*blk["conv3"], s[f"{k}_y2"], s[f"{k}_out"], qmax)}
            if blk["ds"] is not None:
                qb["ds"] = _layer(*blk["ds"], s_in, s[f"{k}_ds"], qmax)
                qb["r"] = detect.f32(s[f"{k}_ds"] / s[f"{k}_out"], dev)
            else:
                qb["ds"] = None
                qb["r"] = detect.f32(s_in / s[f"{k}_out"], dev)
            q["blocks"].append(qb)
            s_in = s[f"{k}_out"]
        q["head"] = []
        for i, (w, b) in enumerate(folded["head"]):
            q["head"].append(_layer(w, b, s_in, s[f"head{i}"], qmax))
            s_in = s[f"head{i}"]
        w1, b1 = folded["fc1"]
        w1q, s_w1 = detect.quantize_weight(w1, qmax, 1e-12)
        q["fc1"] = {"wq": w1q, "m": detect.f32(s_in, dev) * s_w1, "b": b1}
        w2, b2 = folded["fc2"]
        q["fc2"] = {"w": w2.t().contiguous().to(torch.bfloat16).float(), "b": b2}
    return q


def _qconv(x, qc, stride, pad, mode, qmax, res=None, r=None):
    return detect.requant(detect.conv_acc(x, qc["wq"], stride, pad), qc["m"], qc["t"], mode,
                          qmax, res, r)


@torch.inference_mode()
def forward_int8(cfg, q, images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (n, H, W, 3) -> the (n, S, S, B*5+C) float32 grid."""
    qmax = q["qmax"]
    x = detect.quantize(detect.normalize(images_uint8), q["s_img"], qmax)
    x = _qconv(x, q["stem"], 2, 3, "relu", qmax)
    x = F.max_pool2d(x.permute(0, 3, 1, 2).float(), 3, 2, 1).permute(0, 2, 3, 1)
    x = x.to(torch.int8).contiguous()
    for qb in q["blocks"]:
        s = qb["stride"]
        y = _qconv(x, qb["conv1"], 1, 0, "relu", qmax)
        y = _qconv(y, qb["conv2"], s, 1, "relu", qmax)
        res = _qconv(x, qb["ds"], s, 0, "none", qmax) if qb["ds"] is not None else x
        x = _qconv(y, qb["conv3"], 1, 0, "residual", qmax, res, qb["r"])
    for i, qc in enumerate(q["head"]):
        x = _qconv(x, qc, 2 if i == 1 else 1, 1, "leaky", qmax)
    n = x.shape[0]
    flat = x.permute(0, 3, 1, 2).reshape(n, -1).to(torch.float64)  # (C, H, W), as fc1 reads
    acc = flat @ q["fc1"]["wq"].to(torch.float64).t()
    y = acc.to(torch.float32) * q["fc1"]["m"] + q["fc1"]["b"]
    y = torch.where(y > 0, y, detect.LEAKY * y).to(torch.bfloat16).float()
    with detect.exact_float32():
        out = torch.matmul(y, q["fc2"]["w"]) + q["fc2"]["b"]
    S = cfg["S"]
    return out.reshape(n, S, S, -1)


def serve_int8(cfg, q, images_uint8, conf: float, iou: float, rows: int = 32) -> detect.Dets:
    """Detections of a uint8 batch, the forward in blocks of ``rows`` images."""
    grids = [forward_int8(cfg, q, images_uint8[i:i + rows])
             for i in range(0, images_uint8.shape[0], rows)]
    d = detect.decode(torch.cat(grids), cfg["S"], cfg["B"], cfg["num_classes"], conf)
    return detect.nms(d, iou)


# ------------------------------------------------------------------ training
class _Model:
    """The float model as functions of a parameter dict, NCHW, train mode."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor], dropout_mask=None):
        self.cfg, self.p, self.mask = cfg, params, dropout_mask

    def bn(self, x, prefix):
        p = self.p
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"], p[f"{prefix}.bias"],
                            training=True, momentum=0.0, eps=BN_EPS)

    def conv(self, x, name, stride=1, pad=0):
        return F.conv2d(x, self.p[f"{name}.weight"], self.p.get(f"{name}.bias"), stride, pad)

    def __call__(self, x):
        x = F.max_pool2d(torch.relu(self.bn(self.conv(x, "backbone.extractor.0", 2, 3),
                                            "backbone.extractor.1")), 3, 2, 1)
        for _, _, p, _, stride, ds in _blocks(self.cfg):
            idn = self.bn(self.conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1") \
                if ds else x
            y = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
            y = torch.relu(self.bn(self.conv(y, f"{p}.conv2", stride, 1), f"{p}.bn2"))
            x = torch.relu(self.bn(self.conv(y, f"{p}.conv3"), f"{p}.bn3") + idn)
        for i in range(4):
            x = F.leaky_relu(self.conv(x, f"head.conv_layers.{2 * i}", 2 if i == 1 else 1, 1),
                             detect.LEAKY)
        x = torch.flatten(x, 1)
        x = F.leaky_relu(F.linear(x, self.p["head.fc_layers.1.weight"],
                                  self.p["head.fc_layers.1.bias"]), detect.LEAKY)
        if self.mask is not None:
            keep = 1.0 - self.cfg["dropout"]
            x = torch.where(self.mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        x = F.linear(x, self.p["head.fc_layers.4.weight"], self.p["head.fc_layers.4.bias"])
        S = self.cfg["S"]
        return x.reshape(-1, S, S, self.cfg["B"] * 5 + self.cfg["num_classes"])


def _iou(a, b, eps=1e-6):
    """IoU of centre boxes (..., 4), broadcast: inter / (union + eps)."""
    def corners(v):
        return v[..., 0] - v[..., 2] * 0.5, v[..., 1] - v[..., 3] * 0.5, \
            v[..., 0] + v[..., 2] * 0.5, v[..., 1] + v[..., 3] * 0.5
    ax1, ay1, ax2, ay2 = corners(a)
    bx1, by1, bx2, by2 = corners(b)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    inter = iw * ih
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter + eps)


def yolo_loss(cfg, pred, target, lambda_coord: float, lambda_noobj: float):
    """The YOLOv1 sum-squared loss over the batch, / batch size: the
    responsible box is the one of highest IoU with the cell's target; its
    confidence target is that IoU (not detached); w and h through
    sqrt(max(., 1e-6)); no-object loss on every other box."""
    S, B = cfg["S"], cfg["B"]
    n = pred.shape[0]
    pb = pred[..., :B * 5].reshape(n, S, S, B, 5)
    tb = target[..., :B * 5].reshape(n, S, S, B, 5)
    has = tb[..., 4] > 0
    obj = has.any(dim=-1)
    objf = obj.to(pred.dtype)
    slot = has.to(torch.int32).argmax(dim=-1)
    tbox = tb[..., :4].gather(3, slot[..., None, None].expand(n, S, S, 1, 4)).squeeze(3)
    ious = _iou(pb[..., :4], tbox[..., None, :])
    best = ious.argmax(dim=-1)
    best_iou = ious.gather(-1, best[..., None]).squeeze(-1)
    resp = F.one_hot(best, B).bool() & obj[..., None]
    rb = pb.gather(3, best[..., None, None].expand(n, S, S, 1, 5)).squeeze(3)
    xy = ((rb[..., :2] - tbox[..., :2]) ** 2).sum(-1)
    wh = ((torch.sqrt(rb[..., 2:4].clamp(min=1e-6))
           - torch.sqrt(tbox[..., 2:4].clamp(min=1e-6))) ** 2).sum(-1)
    coord = lambda_coord * (objf * (xy + wh)).sum()
    conf_obj = (objf * (rb[..., 4] - best_iou) ** 2).sum()
    noobj = lambda_noobj * torch.where(resp, 0.0, pb[..., 4] ** 2).sum()
    cls = (objf[..., None] * (pred[..., B * 5:] - target[..., B * 5:]) ** 2).sum()
    return (coord + conf_obj + noobj + cls) / n


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Rounded through float8 e4m3 (per-tensor scale to its range) and back."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


def train_steps(cfg, sd, images_uint8: List[torch.Tensor], targets: List[torch.Tensor],
                hyper: Dict, dropout_masks: List[torch.Tensor], control: bool = False) -> Dict:
    """The first ``len(images_uint8)`` steps from the state dict ``sd``: per
    step its loss, after the first step the update's gradient (clipped, plus
    L2 decay) per leaf, and the parameters after the last step.

    Forward under bfloat16 autocast, loss in float32; ``control`` rounds
    every conv and linear operand through float8 (the precision below bf16).
    """
    names = [n for n, shape, role, _ in param_spec(cfg)
             if role not in ("count", "bn_mean", "bn_var")]
    fmt = torch.channels_last if sd[names[0]].is_cuda else torch.contiguous_format
    params = {n: sd[n].detach().float().clone(
        memory_format=fmt if sd[n].dim() == 4 else torch.contiguous_format).requires_grad_(True)
        for n in names}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    b1, b2 = hyper["betas"]
    lr, wd, eps, clip = hyper["lr"], hyper["weight_decay"], hyper["eps"], hyper["clip_norm"]
    losses, first_grad = [], None
    conv2d, linear = F.conv2d, F.linear
    if control:
        F.conv2d = lambda x, w, b=None, *a, **k: conv2d(_fp8(x), _fp8(w), b, *a, **k)
        F.linear = lambda x, w, b=None: linear(_fp8(x), _fp8(w), b)
    try:
        for step, (img, tgt, mask) in enumerate(zip(images_uint8, targets, dropout_masks), 1):
            x = detect.normalize(img.to(params[names[0]].device)).permute(0, 3, 1, 2)
            x = x.contiguous(memory_format=fmt)
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                out = _Model(cfg, params, mask)(x)
            loss = yolo_loss(cfg, out.float(), tgt.float().to(x.device),
                             hyper["lambda_coord"], hyper["lambda_noobj"])
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                total = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                coef = torch.clamp(clip / (total + 1e-6), max=1.0)
                eff = {}
                for n, g in zip(names, grads):
                    p = params[n]
                    g = g * coef + wd * p
                    eff[n] = g
                    m, v = state[n]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
                if first_grad is None:
                    first_grad = eff
    finally:
        F.conv2d, F.linear = conv2d, linear
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: p.detach() for n, p in params.items()}}


#: The serving reference's common entry points (``references/yolov1-24conv.py`` has the same).
prepare = build_int8
serve = serve_int8
