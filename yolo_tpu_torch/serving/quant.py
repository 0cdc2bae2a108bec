"""Post-training int8 quantization for the serving engine.

Port of yolo_tpu/serving/quant.py, with the same recipe and the same
q-params tree:

- weights: symmetric per-output-channel scales, ``s_w = max|w| / 127``;
- activations: symmetric per-tensor scales from the folded float forward's
  max |activation| over calibration batches, at every point of
  :func:`act_points`;
- each conv then reduces to an int8 conv, an int32 accumulator and
  ``y = acc * m + t`` per channel, with ``m = s_in * s_w / s_out`` and
  ``t = b / s_out``, then ReLU/leaky, round and clip to int8.

Every scalar enters the arithmetic as a float32 tensor on the weights'
device, as the JAX package's weakly typed Python scalars do, and divisions
take a tensor divisor: on CUDA, torch turns a division by a host scalar into
a reciprocal multiply. So the q-params equal the JAX package's bit for bit,
the per-tap Winograd parameters of the convs named by ``wino=``
(``serving/winograd.py``) included.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from yolo_tpu_torch.serving import winograd
from yolo_tpu_torch.serving.fold import folded_forward

# Flagship activation quantization points (ResNet50 [3,4,6,3] + 4 head convs).
# Transition blocks (block 0 of every stage) add a ``_ds`` point: the
# downsample branch is quantized at its own scale (see quantize_folded).
ACT_POINTS: List[str] = (
    ["input", "stem"]
    + [
        f"l{s + 1}b{b}_{p}"
        for s, n in enumerate((3, 4, 6, 3))
        for b in range(n)
        for p in (("y1", "y2", "ds", "out") if b == 0 else ("y1", "y2", "out"))
    ]
    + [f"head_conv{i}" for i in (1, 2, 3, 4)]
)


def act_points(folded: Dict) -> List[str]:
    """Quantization-point names for an arbitrary folded struct."""
    pts = ["input", "stem"]
    for si, blocks in enumerate(folded["layers"]):
        for bi, blk in enumerate(blocks):
            names = ("y1", "y2", "ds", "out") if blk["downsample"] is not None \
                else ("y1", "y2", "out")
            pts += [f"l{si + 1}b{bi}_{p}" for p in names]
    pts += [f"head_conv{i}" for i in (1, 2, 3, 4)]
    return pts


def _stage_sizes(folded: Dict) -> List[int]:
    return [len(blocks) for blocks in folded["layers"]]


@torch.inference_mode()
def calibrate_activations(folded: Dict, sample_batches, dtype=torch.float32,
                          wino_points=()) -> Dict:
    """Run the folded forward over (N, H, W, 3) normalized batches; return
    max |activation| per point (a float), and for each of ``wino_points``
    the elementwise max of its (16,) tap maxima under ``{name}_wtap`` (a
    float32 numpy array). One host read per batch."""
    winograd.check_points(wino_points, _stage_sizes(folded))
    device = folded["stem"]["w"].device
    maxes: Dict = {}
    for batch in sample_batches:
        stats: Dict = {}
        folded_forward(folded, torch.as_tensor(batch, device=device), dtype=dtype, stats=stats,
                       wino_points=tuple(wino_points))
        flat = torch.cat([v.reshape(-1) for v in stats.values()]).cpu().numpy()
        at = 0
        for k, v in stats.items():
            if v.dim() == 0:
                maxes[k] = max(maxes.get(k, 0.0), float(flat[at]))
            else:  # per-tap maxima
                maxes[k] = np.maximum(maxes.get(k, 0.0), flat[at:at + v.numel()])
            at += v.numel()
    return maxes


def _f32(v: float, device) -> torch.Tensor:
    """A Python float as a 0-dim float32 tensor (rounded as jnp.float32 rounds)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _quant_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8. w: (..., Cout) -> (w_q, s_w)."""
    w = w.float()
    reduce_dims = tuple(range(w.dim() - 1))
    s_w = torch.clamp(w.abs().amax(dim=reduce_dims) / _f32(127.0, w.device), min=1e-12)
    w_q = torch.round(w / s_w).clamp(-127, 127).to(torch.int8)
    return w_q, s_w


def _layer(w, b, s_in: float, s_out: float) -> Dict:
    w_q, s_w = _quant_weight(w)
    dev = w.device
    return {
        "wq": w_q,
        "m": _f32(s_in, dev) * s_w / _f32(s_out, dev),
        "t": b.float() / _f32(s_out, dev),
    }


def s2d_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """7x7/s2 stem kernel (HWIO) -> its space-to-depth-2 equivalent (4x4/s1, 12ch).

    With the input rearranged X[I, J, (p, q, c)] = x[2I+p, 2J+q, c], the
    stride-2 7x7 conv becomes a stride-1 4x4 conv over 12 channels whose taps
    are W'[A, B, (p*2+q)*3+c, f] = w[2A+p-1, 2B+q-1, c, f] (zero where the
    source index falls outside [0, 7)), with asymmetric padding (2, 1).
    """
    c_in, c_out = w.shape[2], w.shape[3]
    w2 = torch.zeros((4, 4, 4 * c_in, c_out), dtype=w.dtype, device=w.device)
    for A in range(4):
        for p in range(2):
            di = 2 * A + p - 1
            if not 0 <= di < 7:
                continue
            for B in range(4):
                for qq in range(2):
                    dj = 2 * B + qq - 1
                    if not 0 <= dj < 7:
                        continue
                    ch = (p * 2 + qq) * c_in
                    w2[A, B, ch:ch + c_in, :] = w[di, dj]
    return w2


def quantize_folded(folded: Dict, act_max: Dict[str, float], stem_mode: str = "s2d",
                    fc1_mode: str = "int8", wino=()) -> Dict:
    """Folded float params + calibrated activation maxima -> int8 engine params.

    ``stem_mode``: "s2d" stores the stem as its space-to-depth 4x4
    equivalent (the engine dispatches on the kernel's shape), "direct" as
    the 7x7/s2 kernel. ``fc1_mode``: "int8" quantizes fc1 per output
    channel, "bf16" keeps it in bfloat16. ``wino``: names of stride-1 3x3
    convs ("head_conv1", "l3b1_conv2", ...) that also get per-tap Winograd
    params under ``qc["wino"]`` (``winograd.wino_quantize``; needs the
    ``{name}_wtap`` maxima of ``calibrate_activations(wino_points=...)``).
    """
    winograd.check_points(wino, _stage_sizes(folded))
    if stem_mode not in ("s2d", "direct"):
        raise ValueError(f"stem_mode must be 's2d' or 'direct', got {stem_mode!r}")
    if fc1_mode not in ("int8", "bf16"):
        raise ValueError(f"fc1_mode must be 'int8' or 'bf16', got {fc1_mode!r}")
    dev = folded["stem"]["w"].device
    s = {k: max(v, 1e-12) / 127.0 for k, v in act_max.items() if not k.endswith("_wtap")}

    def with_wino(qc: Dict, name: str, conv: Dict, s_in: float, s_out: float) -> Dict:
        if name in wino:
            qc["wino"] = winograd.wino_quantize(conv["w"], conv["b"], s_in, s_out,
                                                act_max[f"{name}_wtap"])
        return qc

    q: Dict = {"s_img": _f32(s["input"], dev)}
    stem_w = folded["stem"]["w"]
    if stem_mode == "s2d":
        stem_w = s2d_stem_weights(stem_w)
    q["stem"] = _layer(stem_w, folded["stem"]["b"], s["input"], s["stem"])

    layers = []
    s_in = s["stem"]  # carries through blocks and across stage boundaries
    for si, blocks in enumerate(folded["layers"]):
        qblocks = []
        for bi, blk in enumerate(blocks):
            tag = f"l{si + 1}b{bi}"
            qb: Dict = {
                "conv1": _layer(blk["conv1"]["w"], blk["conv1"]["b"], s_in, s[f"{tag}_y1"]),
                "conv2": with_wino(_layer(blk["conv2"]["w"], blk["conv2"]["b"], s[f"{tag}_y1"],
                                          s[f"{tag}_y2"]),
                                   f"{tag}_conv2", blk["conv2"], s[f"{tag}_y1"], s[f"{tag}_y2"]),
                "conv3": _layer(blk["conv3"]["w"], blk["conv3"]["b"], s[f"{tag}_y2"],
                                s[f"{tag}_out"]),
            }
            if blk["downsample"] is not None:
                # The branch gets its own calibrated scale and lands in int8;
                # the conv3 epilogue rescales it by s_ds / s_out when adding.
                s_ds = s[f"{tag}_ds"]
                qb["downsample"] = _layer(blk["downsample"]["w"], blk["downsample"]["b"],
                                          s_in, s_ds)
                qb["ds_rescale"] = _f32(s_ds / s[f"{tag}_out"], dev)
                qb["rx"] = None
            else:
                qb["downsample"] = None
                # Residual: x_q * (s_in / s_out), folded into the epilogue.
                qb["rx"] = _f32(s_in / s[f"{tag}_out"], dev)
            s_in = s[f"{tag}_out"]
            qblocks.append(qb)
        layers.append(qblocks)
    q["layers"] = layers

    head = folded["head"]
    qh: Dict = {}
    for i in (1, 2, 3, 4):
        name = f"conv{i}"
        qh[name] = with_wino(_layer(head[name]["w"], head[name]["b"], s_in, s[f"head_conv{i}"]),
                             f"head_conv{i}", head[name], s_in, s[f"head_conv{i}"])
        s_in = s[f"head_conv{i}"]
    qh["s_out4"] = _f32(s["head_conv4"], dev)
    if fc1_mode == "int8":
        w1q, s_w1 = _quant_weight(head["fc1"]["w"])
        qh["fc1"] = {"wq": w1q, "m": _f32(s_in, dev) * s_w1, "b": head["fc1"]["b"].float()}
    else:
        qh["fc1"] = {"w": head["fc1"]["w"].to(torch.bfloat16), "b": head["fc1"]["b"].float()}
    qh["fc2"] = {"w": head["fc2"]["w"].to(torch.bfloat16), "b": head["fc2"]["b"].float()}
    q["head"] = qh
    return q
