"""The int8 engine's 3x3/s2/p1 max-pool after the stem through ``csrc/max_pool_int8.cu``.

Replaces no TPU kernel: the JAX engine pools with ``lax.reduce_window``
(init -128). For an (N, H, W, C) int8 NHWC ``x`` the output is (N, (H-1)//2+1,
(W-1)//2+1, C), each value the max over its 3x3 window, a position outside
``x`` counting as -128.

:func:`max_pool_int8` launches the kernel for CUDA tensors and runs
:func:`max_pool_int8_reference` (a -128 border, then the max of nine
strided views, in eager torch) for CPU tensors. A CUDA tensor never reaches
the plain version: the kernel runs or the call raises. A max of integers is
exact, so both are bit-identical.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tpu_torch.utils import kernels

#: Channels one 16-byte vector of the kernel holds: C must be a multiple.
VECTOR = 16


def out_size(h: int, w: int) -> tuple:
    """(Ho, Wo) of a 3x3/s2/p1 pool of an H x W input."""
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def max_pool_int8_reference(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/p1 max-pool of NHWC int8, padding -128 (the JAX engine's
    ``reduce_window`` with init -128): the max of 9 strided views, exact."""
    n, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    out = None
    for di in range(3):
        for dj in range(3):
            v = xp[:, di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"max_pool_int8: x must be a non-empty (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int8:
        raise TypeError(f"max_pool_int8: x must be int8, got {x.dtype}")
    if x.shape[-1] % VECTOR:
        raise ValueError(f"max_pool_int8: C must be a multiple of {VECTOR}, got {x.shape[-1]}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("max_pool_int8: x must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    out = torch.empty((n, *out_size(h, w), c), dtype=torch.int8, device=x.device)
    kernels.launch("yolo_max_pool_int8", x.device, x.data_ptr(), out.data_ptr(), n, h, w, c)
    return out


def max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) int8 -> (N, (H-1)//2+1, (W-1)//2+1, C) int8: the kernel on
    CUDA tensors, :func:`max_pool_int8_reference` on CPU tensors."""
    if x.device.type == "cuda":
        _check(x)
        return _launch(x)
    return max_pool_int8_reference(x)


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    """Device-memory bytes a call needs: x read once, the output written once."""
    ho, wo = out_size(h, w)
    return n * c * (h * w + ho * wo)
