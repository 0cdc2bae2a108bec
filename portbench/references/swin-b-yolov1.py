"""Plain reference of ``swin-b-yolov1``: Swin-B (Liu et al., ICCV 2021,
arXiv:2103.14030; widths of microsoft/Swin-Transformer
``configs/swin/swin_base_patch4_window7_224.yaml``) in the form of the
official detection backbone (SwinTransformer/Swin-Transformer-Object-
Detection ``mmdet/models/backbones/swin_transformer.py``), with the YOLOv1
detection head of mattiaskvist/yolo-v1 ``src/yolo/models.py`` on its
stride-32 map (four 3x3 convs to 1024 channels, the second with stride 2,
LeakyReLU 0.1; fc 50176 -> 4096 -> LeakyReLU -> dropout 0.5 -> 1470),
448x448 input, S=7, B=2, 20 classes.

The backbone, on (N, H, W, C) maps:

- patch embedding: pad H and W to multiples of 4, Conv2d(3, C, 4, stride 4), LayerNorm;
- each block: ``x + attn(LN1(x))``, then ``x + fc2(GELU_erf(fc1(LN2(x))))``;
  the attention pads the map to multiples of the window (7), in odd blocks
  rolls it by (-3, -3), partitions it into 7x7 windows, takes
  ``qkv = Linear(C, 3C)``, per head ``softmax(q k^T / sqrt(32) + bias +
  mask) v`` (bias from the 169 x heads table by the relative position,
  mask -100 across the official nine regions of the rolled map), ``proj =
  Linear(C, C)``, reverses the partition, rolls back and crops; padded
  tokens are zeros that take part, as in the detection code;
- patch merging after stages 1-3: pad an odd side, concatenate
  x[0::2,0::2], x[1::2,0::2], x[0::2,1::2], x[1::2,1::2], LayerNorm(4C),
  Linear(4C, 2C, no bias);
- LayerNorm(8C) on the last stage, as NCHW.

Departures, as in the configuration's ``assumed``: no drop path (mmdet's
Swin-B detectors use 0.3), no dropout inside the backbone, no absolute
position embedding (as published).

- :func:`param_spec`: the state dict's names (the program's), shapes and
  init roles.
- :func:`forward`: the float32 forward (the CPU tests).
- :func:`train_steps`: the training step. The forward runs under bfloat16
  autocast, as the program's does, and the attention core is one
  ``F.scaled_dot_product_attention`` call on (B, nW * heads, N, d) with bias
  plus mask one bfloat16 operand, the library's fused kernel, as the convs
  and linears are the library's; the windows, shift, mask, bias and merges
  around it are this file's. The loss, the clip and Adam with L2 are
  float32, the last two line for line as in ``references/resnet50-yolov1.py``,
  whose ``yolo_loss`` and ``_fp8`` this file copies. Three steps at batch 64
  fit on the card whole.

  Why the fused call and not the core written out: the written-out core
  rounds otherwise than the fused kernel, the predictions part by about
  1.5%, and the YOLOv1 loss turns that into a 26-74% different gradient at
  its output (a few cells, through sqrt(w) near 0, carry most of it), so the
  first step's gradients parted by up to 14% and a step on half the batch
  could not be told from a sound one (PERF.md, Findings). The written-out
  core stays the float32 :func:`forward`'s and the control's, and
  ``portbench/tests/test_portbench_swin.py`` holds the fused call to it.

Imports nothing of ``yolo_tpu_torch``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.references import detect

LN_EPS = 1e-5


# ------------------------------------------------------------------ structure
def _stages(cfg):
    """(index, channels, depth, heads) of every stage."""
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield i, cfg["embed_dim"] * 2 ** i, depth, heads


def out_channels(cfg) -> int:
    return cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def head_side(cfg) -> int:
    """The head's map side after its stride-2 conv: 448 -> 112 -> 56, 28, 14 -> 7."""
    h = _ceil(cfg["image_size"], cfg["patch_size"])
    for _ in range(len(cfg["depths"]) - 1):
        h = _ceil(h, 2)
    return (h - 1) // 2 + 1


def _ln(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "bn_gamma", c), (f"{prefix}.bias", (c,), "bn_beta", c)]


def _linear(name: str, fout: int, fin: int, role: str = "default", bias: bool = True) -> list:
    out = [(f"{name}.weight", (fout, fin), role, fin)]
    if bias:
        out.append((f"{name}.bias", (fout,), "bias", fin))
    return out


def param_spec(cfg) -> list:
    """Every state-dict entry: LayerNorm scales ``bn_gamma`` and shifts
    ``bn_beta``; the patch-embedding conv, qkv, proj, fc2, the merges'
    reductions and the head's fc2 ``default``; fc1 of each block's MLP and
    the head's convs and fc1 ``he``; biases ``bias``; each bias table
    ``bias`` with fan-in 2500 (+-0.02)."""
    c, p, ws = cfg["embed_dim"], cfg["patch_size"], cfg["window_size"]
    spec = [("backbone.patch_embed.proj.weight", (c, 3, p, p), "default", 3 * p * p),
            ("backbone.patch_embed.proj.bias", (c,), "bias", 3 * p * p)]
    spec += _ln("backbone.patch_embed.norm", c)
    last = len(cfg["depths"]) - 1
    for i, dim, depth, heads in _stages(cfg):
        hidden = int(dim * cfg["mlp_ratio"])
        for j in range(depth):
            b = f"backbone.layers.{i}.blocks.{j}"
            spec += _ln(f"{b}.norm1", dim)
            spec.append((f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                         "bias", 2500))
            spec += _linear(f"{b}.attn.qkv", 3 * dim, dim) + _linear(f"{b}.attn.proj", dim, dim)
            spec += _ln(f"{b}.norm2", dim)
            spec += _linear(f"{b}.mlp.fc1", hidden, dim, "he")
            spec += _linear(f"{b}.mlp.fc2", dim, hidden)
        if i < last:
            spec += _ln(f"backbone.layers.{i}.downsample.norm", 4 * dim)
            spec += _linear(f"backbone.layers.{i}.downsample.reduction", 2 * dim, 4 * dim,
                            bias=False)
    spec += _ln("backbone.norm", out_channels(cfg))
    hc = cfg["head_channels"]
    for i, cin in enumerate((out_channels(cfg), hc, hc, hc)):
        spec += [(f"head.conv_layers.{2 * i}.weight", (hc, cin, 3, 3), "he", cin * 9),
                 (f"head.conv_layers.{2 * i}.bias", (hc,), "bias", cin * 9)]
    fin = hc * head_side(cfg) ** 2
    out = cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])
    spec += _linear("head.fc_layers.1", cfg["fc_hidden"], fin, "he")
    spec += _linear("head.fc_layers.4", out, cfg["fc_hidden"])
    return spec


# ------------------------------------------------------------------ windows
def _partition(x, ws):
    b, h, w, c = x.shape
    return x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(
        -1, ws * ws, c)


def _reverse(windows, ws, h, w):
    c = windows.shape[-1]
    return windows.view(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(
        -1, h, w, c)


def relative_index(ws: int) -> torch.Tensor:
    """The official ``relative_position_index`` of a ws x ws window."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def region_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """The official shifted-window mask on an (hp, wp) padded map: (nW, N, N), 0 or -100."""
    img = torch.zeros(1, hp, wp, 1)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = _partition(img, ws).view(-1, ws * ws)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _rounded(t: torch.Tensor, dtype, op) -> torch.Tensor:
    """``op(t.to(dtype))`` as float32 in the forward, the identity in the
    backward: the fused kernels round P to the products' precision but keep
    dP (and so dS = P (dP - rowsum(P dP))) in float32, where autograd of a
    cast would round dP."""
    return t + (op(t.to(dtype)).float() - t).detach()


# ------------------------------------------------------------------ model
class _Model:
    """The model as functions of a parameter dict, train mode. ``control``
    rounds every conv and linear operand and both attention products'
    operands through float8 (the precision below bf16). ``fused`` runs the
    attention core as one ``F.scaled_dot_product_attention`` call, else it
    is written out: q and k rounded to the operands' dtype with their
    products summed in float32, bias plus mask rounded once to that dtype
    and added, the softmax in float32, P rounded to that dtype and P v
    summed in float32."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor], dropout_mask=None,
                 control: bool = False, fused: bool = False):
        if control and fused:
            raise ValueError("the control rounds P, which the fused call cannot")
        self.cfg, self.p, self.mask, self.fused = cfg, params, dropout_mask, fused
        self.op = _fp8 if control else (lambda t: t)
        self.ws = cfg["window_size"]
        self.index = relative_index(self.ws).view(-1)

    def ln(self, x, prefix):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{prefix}.weight"],
                            self.p[f"{prefix}.bias"], LN_EPS)

    def linear(self, x, name):
        return F.linear(self.op(x), self.op(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"))

    def conv(self, x, name, stride=1, pad=0):
        return F.conv2d(self.op(x), self.op(self.p[f"{name}.weight"]),
                        self.p.get(f"{name}.bias"), stride, pad)

    def attention(self, x, prefix, heads, shift, mask):
        b, h, w, c = x.shape
        ws, d = self.ws, c // heads
        n = ws * ws
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        nw = (hp // ws) * (wp // ws)
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        qkv = self.linear(_partition(x, ws), f"{prefix}.qkv")
        table = self.p[f"{prefix}.relative_position_bias_table"]
        bias = table[self.index.to(table.device)].view(n, n, heads).permute(2, 0, 1).float()
        add = bias + mask.to(bias.device).view(nw, 1, n, n) if shift else \
            bias.expand(nw, heads, n, n)
        low = qkv.dtype  # bfloat16 under autocast, float32 in :func:`forward`
        if self.fused:
            q, k, v = qkv.view(b, nw, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5).reshape(
                3, b, nw * heads, n, d)
            o = F.scaled_dot_product_attention(
                q, k, v, attn_mask=add.reshape(1, nw * heads, n, n).to(low))
            o = o.view(b, nw, heads, n, d).transpose(2, 3)
        else:
            o = self.written_out(qkv.reshape(b * nw, n, 3, heads, d).permute(2, 0, 3, 1, 4),
                                 add.to(low), b, nw).transpose(1, 2)
        o = self.linear(o.reshape(b * nw, n, c), f"{prefix}.proj")
        x = _reverse(o, ws, hp, wp)
        if shift:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        return x[:, :h, :w]

    def written_out(self, qkv, add, b, nw):
        """The attention core of (3, B * nW, heads, N, d) q, k, v and the
        (nW, heads, N, N) bias plus mask: (B * nW, heads, N, d) in float32."""
        q, k, v = qkv
        heads, n, d = q.shape[1:]
        low = q.dtype
        with torch.autocast(q.device.type, enabled=False), detect.exact_float32():
            s = torch.matmul(self.op(q).float(), self.op(k).float().transpose(-2, -1))
            s = (s * d ** -0.5).view(b, nw, heads, n, n) + add.expand(b, nw, heads, n, n).float()
            prob = torch.softmax(s, dim=-1).view(b * nw, heads, n, n)
            return torch.matmul(_rounded(prob, low, self.op), self.op(v).float())

    def backbone(self, x):
        cfg, p = self.cfg, self.cfg["patch_size"]
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.conv(x, "backbone.patch_embed.proj", p).permute(0, 2, 3, 1)
        x = self.ln(x, "backbone.patch_embed.norm")
        last = len(cfg["depths"]) - 1
        for i, _, depth, heads in _stages(cfg):
            ws = self.ws
            hp, wp = _ceil(x.shape[1], ws) * ws, _ceil(x.shape[2], ws) * ws
            mask = region_mask(hp, wp, ws, ws // 2)
            for j in range(depth):
                blk = f"backbone.layers.{i}.blocks.{j}"
                shift = 0 if j % 2 == 0 else ws // 2
                x = x + self.attention(self.ln(x, f"{blk}.norm1"), f"{blk}.attn", heads, shift,
                                       mask)
                y = F.gelu(self.linear(self.ln(x, f"{blk}.norm2"), f"{blk}.mlp.fc1"))
                x = x + self.linear(y, f"{blk}.mlp.fc2")
            if i < last:
                ds = f"backbone.layers.{i}.downsample"
                x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 1::2]], -1)
                x = self.linear(self.ln(x, f"{ds}.norm"), f"{ds}.reduction")
        return self.ln(x, "backbone.norm").permute(0, 3, 1, 2)

    def __call__(self, x):
        x = self.backbone(x)
        for i in range(4):
            x = F.leaky_relu(self.conv(x, f"head.conv_layers.{2 * i}", 2 if i == 1 else 1, 1),
                             detect.LEAKY)
        x = torch.flatten(x, 1)
        x = F.leaky_relu(self.linear(x, "head.fc_layers.1"), detect.LEAKY)
        if self.mask is not None:
            keep = 1.0 - self.cfg["dropout"]
            x = torch.where(self.mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        x = self.linear(x, "head.fc_layers.4")
        S = self.cfg["S"]
        return x.reshape(-1, S, S, self.cfg["B"] * 5 + self.cfg["num_classes"])


def forward(cfg, params: Dict[str, torch.Tensor], x: torch.Tensor,
            fused: bool = False) -> torch.Tensor:
    """The float32 forward of NCHW images: the (N, S, S, B*5+C) grid, no
    dropout; the attention core written out unless ``fused``."""
    with detect.exact_float32():
        return _Model(cfg, params, fused=fused)(x)


def backbone_forward(cfg, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The float32 backbone alone: (N, 8C, H/32, W/32)."""
    with detect.exact_float32():
        return _Model(cfg, params).backbone(x)


# ------------------------------------------------------------------ training
# ``_iou``, ``yolo_loss`` and ``_fp8`` are ``references/resnet50-yolov1.py``'s,
# copied as they are: a reference imports nothing outside
# ``portbench.references``, and that file's name is no module name.
# ``portbench/tests/test_portbench_swin.py`` holds the copies to the originals.
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

    Forward under bfloat16 autocast with the fused attention core, loss in
    float32; ``control`` rounds every conv and linear operand and both
    attention products' operands through float8, the core written out.
    """
    names = [n for n, _, _, _ in param_spec(cfg)]
    fmt = torch.channels_last if sd[names[0]].is_cuda else torch.contiguous_format
    params = {n: sd[n].detach().float().clone(
        memory_format=fmt if sd[n].dim() == 4 else torch.contiguous_format).requires_grad_(True)
        for n in names}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    b1, b2 = hyper["betas"]
    lr, wd, eps, clip = hyper["lr"], hyper["weight_decay"], hyper["eps"], hyper["clip_norm"]
    losses, first_grad = [], None
    for step, (img, tgt, mask) in enumerate(zip(images_uint8, targets, dropout_masks), 1):
        x = detect.normalize(img.to(params[names[0]].device)).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=fmt)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = _Model(cfg, params, mask, control, fused=not control)(x)
        loss = yolo_loss(cfg, out.float(), tgt.float().to(x.device),
                         hyper["lambda_coord"], hyper["lambda_noobj"])
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        del out, loss
        with torch.no_grad():
            total = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            coef = torch.clamp(clip / (total + 1e-6), max=1.0)
            eff = {}
            for name, g in zip(names, grads):
                p = params[name]
                g = g * coef + wd * p
                eff[name] = g
                m, v = state[name]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
            if first_grad is None:
                first_grad = eff
        del grads
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: p.detach() for n, p in params.items()}}
