"""int8 convolution + requant through the CUDA kernel ``csrc/int8_conv.cu``.

Port of the TPU kernel yolo_tpu/serving/pallas_int8.py::
_transition_conv2_kernel (entry ``transition_conv2_int8``: a 3x3/s2/p1 int8
conv with an int32 accumulator and a fused requant), generalised to every
int8 conv of the serving engine: the stems (4x4/s1 space-to-depth, 7x7/s2
direct), 1x1 convs at stride 1 or 2, 3x3 convs at stride 1 or 2, and int8
fc1 as a 1x1 conv. PyTorch has no int8 convolution that keeps an int32
accumulator (``F.conv2d`` on int8 returns int8 and wraps), so the engine
runs every int8 conv here.

Activations are NHWC int8; weights are the q-params' HWIO int8 ``wq``. The
kernel reads them repacked once as (Cout, Kpad), K contiguous
(:func:`pack_weight`; ``engine.to_device`` stores the result as ``wk``).
Its mainloop is the wgmma core it shares with the bf16 conv
(``csrc/sm90_conv_core.cuh``); :func:`plan` picks its output tile and its
K splits by shape, and a split conv's exact int32 partials are summed by a
second pass that runs the epilogue once (one C call, one count in
``kernels.LAUNCHES``).

Epilogue modes, in the op order of yolo_tpu/serving/engine.py::_requant:

- ``"relu"``: ``q(max(acc*m + t, 0))`` (stem, conv1, conv2);
- ``"none"``: ``q(acc*m + t)`` (the downsample branch);
- ``"residual"``: ``q(max(acc*m + t + res*r, 0))`` (conv3; ``r`` is rx or
  ds_rescale, a float32 on the device);
- ``"leaky"``: ``q(where(y > 0, y, 0.1*y))`` with ``y = acc*m + t`` (head);
- ``"float"``: ``acc*m + t`` as float32 (int8 fc1, ``t`` its bias);
- ``"acc"``: the int32 accumulator itself;

with ``q(v) = clip(round(v), -127, 127)`` as int8 and ``round`` half to even.

:func:`conv_int8` launches the kernel for CUDA tensors and runs
:func:`conv_int8_reference` for CPU tensors. The reference computes the
accumulator with a float64 convolution: every product of two int8 values is
an integer below 2**14 and every sum here stays below 2**53, so float64 is
exact in any summation order, and the kernel equals it bit for bit. A CUDA
tensor never reaches the reference through :func:`conv_int8`: the kernel
runs or the call raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from yolo_tpu_torch.utils import kernels

MODES = {"relu": 0, "none": 1, "residual": 2, "leaky": 3, "float": 4, "acc": 5}
K_ALIGN = 64  # the kernel's K step: packed weights are zero-padded to it
_SMS = 132  # streaming multiprocessors of an H100 SXM

Pad = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _pads(pad: Pad) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) from an int or ((top, bottom), (left, right))."""
    if isinstance(pad, int):
        return pad, pad, pad, pad
    (pt, pb), (pl, pr) = pad
    return pt, pb, pl, pr


def out_size(h: int, w: int, kh: int, kw: int, stride: int, pad: Pad) -> Tuple[int, int]:
    pt, pb, pl, pr = _pads(pad)
    return (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """HWIO (KH, KW, Cin, Cout) int8 -> (Cout, Kpad) int8, K contiguous,
    zero-padded from K = KH*KW*Cin up to a multiple of 64."""
    kh, kw, cin, cout = wq.shape
    k = kh * kw * cin
    kpad = -(-k // K_ALIGN) * K_ALIGN
    wk = torch.zeros((cout, kpad), dtype=torch.int8, device=wq.device)
    wk[:, :k] = wq.permute(3, 0, 1, 2).reshape(cout, k)
    return wk


# ------------------------------------------------------------------ twin
def conv_acc_reference(x: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                       pad: Pad = 0) -> torch.Tensor:
    """The exact int32 accumulator, NHWC, as float64 (see the module docstring)."""
    pt, pb, pl, pr = _pads(pad)
    xd = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    wd = wq.permute(3, 2, 0, 1).to(torch.float64)
    # cuDNN may pick an FFT or Winograd algorithm, which would not be exact;
    # without it, torch's own im2col + float64 GEMM is.
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, wd, stride=stride)
    return acc.permute(0, 2, 3, 1)


def requant_reference(acc: torch.Tensor, m: torch.Tensor, t: torch.Tensor, mode: str,
                      res: Optional[torch.Tensor] = None,
                      r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's epilogue on an exact accumulator (float64 or int32), eager torch."""
    if mode == "acc":
        return acc.to(torch.int32)
    y = acc.to(torch.float32) * m + t
    if mode == "float":
        return y
    if mode == "residual":
        y = y + res.to(torch.float32) * r
    if mode == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    elif mode != "none":
        y = torch.clamp(y, min=0.0)
    return torch.round(y).clamp(-127, 127).to(torch.int8)


def conv_int8_reference(x, wq, m, t, stride: int = 1, pad: Pad = 0, mode: str = "relu",
                        res=None, r=None) -> torch.Tensor:
    """The kernel's function in plain torch (float64 conv, then the epilogue)."""
    return requant_reference(conv_acc_reference(x, wq, stride, pad), m, t, mode, res, r)


# ------------------------------------------------------------------ kernel
#: The kernel's output tiles (rows, channels): 128-row tiles run two
#: consumer warpgroups in a block, 64-row tiles one (and two blocks an SM).
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
STAGE_BYTES = 128  # K bytes of one stage of the kernel's shared-memory ring
MIN_SPLIT_STAGES = 4  # a K split keeps at least this many stages
_RESIDENT = {128: 1, 64: 2}  # blocks an SM holds, by tile rows


def k_stages(k: int) -> int:
    """The kernel's K stages for K = KH*KW*Cin (packed to K_ALIGN, 128 bytes a stage)."""
    return -(-(-(-k // K_ALIGN) * K_ALIGN) // STAGE_BYTES)


@functools.lru_cache(maxsize=None)
def plan(m_rows: int, cout: int, k: int) -> Tuple[int, int]:
    """(tile, splits) of one conv: an index into :data:`TILES` and the
    number of K splits, chosen by shape alone.

    K of one or two stages with Cout <= 512 (the stems, layer1's and
    layer2's 1x1 convs over 64-256 channels): 64x64 tiles, two blocks and
    so two producer warpgroups an SM, which set the pace there (their tile
    sweep at batch 16 in ``chip_smoke.py`` phase 11). Otherwise channels:
    64-wide tiles where Cout <= 64, else 128; rows: 128 where 128-row tiles
    give every SM one, else 64 (two blocks an SM). Where the tiles still
    leave SMs idle (fc1, layer4 and the head at small batch), K is split
    into the largest divisor of its stages that fits the idle slots and
    keeps each split at least MIN_SPLIT_STAGES stages; the splits' exact
    int32 partials are summed by a second pass."""
    stages = k_stages(k)
    if stages <= 2 and cout <= 512:
        return TILES.index((64, 64)), 1
    bn = 64 if cout <= 64 else 128
    bm = 128 if -(-m_rows // 128) * -(-cout // bn) >= _SMS else 64
    units = -(-m_rows // bm) * -(-cout // bn)
    want = _SMS * _RESIDENT[bm] // max(units, 1)
    splits = max(d for d in range(1, max(want, 1) + 1)
                 if d == 1 or (stages % d == 0 and stages // d >= MIN_SPLIT_STAGES))
    return TILES.index((bm, bn)), splits


def workspace_shape(m_rows: int, cout: int, splits: int) -> Optional[Tuple[int, int, int]]:
    """The int32 split-K workspace (splits, M, Cout) the wrapper allocates, or None."""
    return (splits, m_rows, cout) if splits > 1 else None


def _check(x, wk, m, t, mode, res, r, kh, kw) -> None:
    dev = x.device
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv_int8: x must be contiguous (N, H, W, C) int8, got "
                         f"{x.dtype} {tuple(x.shape)}")
    cout, kpad = wk.shape
    if wk.dtype != torch.int8 or not wk.is_contiguous() or kpad % K_ALIGN or \
            kpad < kh * kw * x.shape[3]:
        raise ValueError(f"conv_int8: packed weight must be contiguous (Cout, Kpad) int8 "
                         f"with Kpad % 64 == 0, got {wk.dtype} {tuple(wk.shape)}")
    if cout % 2:
        raise ValueError(f"conv_int8: Cout must be even, got {cout}")
    for name, v in (("m", m), ("t", t)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,) or not v.is_contiguous():
            raise ValueError(f"conv_int8: {name} must be contiguous ({cout},) float32")
    tensors = [x, wk, m, t]
    if mode == "residual":
        if res is None or r is None or res.dtype != torch.int8 or not res.is_contiguous() \
                or r.dtype != torch.float32 or r.numel() != 1:
            raise ValueError("conv_int8: residual mode needs contiguous int8 res and one "
                             "float32 r")
        tensors += [res, r]
    if any(v.device != dev for v in tensors):
        raise ValueError("conv_int8: every operand must be on x's device")
    if x.data_ptr() % (16 if x.shape[3] % 16 == 0 else 4) or wk.data_ptr() % 16 or (
            mode == "residual" and res.data_ptr() % 16):
        raise ValueError("conv_int8: x (16-byte where Cin % 16 == 0, else 4), the packed "
                         "weight and res (16-byte) must be aligned")


def launch_buffers(x_shape, cout: int, kh: int, kw: int, stride: int, pad: Pad, mode: str,
                   device) -> Tuple[torch.Tensor, Optional[torch.Tensor], int, int]:
    """(out, split-K workspace or None, tile, splits) of one kernel call:
    the output and the workspace allocated with ``torch.empty`` as
    :func:`plan` and :func:`workspace_shape` say."""
    n, h, w, cin = x_shape
    ho, wo = out_size(h, w, kh, kw, stride, pad)
    dtype = {"float": torch.float32, "acc": torch.int32}.get(mode, torch.int8)
    out = torch.empty((n, ho, wo, cout), dtype=dtype, device=device)
    tile, splits = plan(n * ho * wo, cout, kh * kw * cin)
    ws_shape = workspace_shape(n * ho * wo, cout, splits)
    ws = None if ws_shape is None else torch.empty(ws_shape, dtype=torch.int32, device=device)
    return out, ws, tile, splits


def launch(x, wk, m, t, kh, kw, stride, pad, mode, res=None, r=None) -> torch.Tensor:
    """One kernel call on checked CUDA operands (see :func:`conv_int8`). The
    int8 dot of ``experiments/mosaic_int8_dot.py`` runs here too, as a 1x1
    conv with mode ``"none"`` and ``t = 0``."""
    n, h, w, cin = x.shape
    cout, kpad = wk.shape
    pt, _, pl, _ = _pads(pad)
    out, ws, tile, splits = launch_buffers(x.shape, cout, kh, kw, stride, pad, mode, x.device)
    _, ho, wo, _ = out.shape
    if mode == "residual" and tuple(res.shape) != tuple(out.shape):
        raise ValueError(f"conv_int8: res must be {tuple(out.shape)}, got {tuple(res.shape)}")
    kernels.launch(
        "yolo_int8_conv", x.device, x.data_ptr(), wk.data_ptr(), m.data_ptr(), t.data_ptr(),
        res.data_ptr() if res is not None else None, r.data_ptr() if r is not None else None,
        out.data_ptr(), n, h, w, cin, ho, wo, cout, kh, kw, stride, pt, pl, kpad, MODES[mode],
        tile, splits, ws.data_ptr() if ws is not None else None,
    )
    return out


def conv_int8(x: torch.Tensor, wq: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
              stride: int = 1, pad: Pad = 0, mode: str = "relu",
              res: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
              wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 conv of NHWC ``x`` with HWIO ``wq``, then the ``mode`` epilogue.

    The kernel on CUDA tensors, reading ``wk`` (``pack_weight(wq)``, packed
    now if not given); :func:`conv_int8_reference` on CPU tensors.
    """
    if mode not in MODES:
        raise ValueError(f"conv_int8: mode must be one of {sorted(MODES)}, got {mode!r}")
    if x.device.type != "cuda":
        return conv_int8_reference(x, wq, m, t, stride, pad, mode, res, r)
    kh, kw = wq.shape[:2]
    wk = pack_weight(wq) if wk is None else wk
    _check(x, wk, m, t, mode, res, r, kh, kw)
    return launch(x, wk, m, t, kh, kw, stride, pad, mode, res, r)


def work(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int, stride: int,
         pad: Pad, mode: str) -> Tuple[int, int]:
    """(int8 operations, device-memory bytes) of one call: 2 ops per
    multiply-add; x, the weight (and res) read once, the output written once."""
    ho, wo = out_size(h, w, kh, kw, stride, pad)
    ops = 2 * n * ho * wo * cout * kh * kw * cin
    out_bytes = {"float": 4, "acc": 4}.get(mode, 1) * n * ho * wo * cout
    res_bytes = n * ho * wo * cout if mode == "residual" else 0
    return ops, n * h * w * cin + kh * kw * cin * cout + 8 * cout + out_bytes + res_bytes
