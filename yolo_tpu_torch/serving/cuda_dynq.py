"""Dynamic per-tensor int8 quantize of ``Int8Conv2d``'s input through ``csrc/dyn_quant.cu``.

Replaces no TPU kernel: JAX's ``_Int8ConvCore`` quantizes with plain
``jnp``. For an NCHW float ``x`` it computes, with one scale over the whole
batch, ``s_x = max(max|x| / 127, 1e-8)`` and ``x_q = clip(round(x / s_x),
-127, 127)`` as NHWC int8.

:func:`quantize` launches the kernel pair (a partial-max pass, then a pass
that reduces the partials and quantizes) for CUDA tensors and runs
:func:`quantize_reference` (the six eager passes: abs, amax, divide, round,
clamp, int8 cast) for CPU tensors. A CUDA tensor never reaches the plain
version: the kernels run or the call raises. Both are bit-identical for
finite input, since the kernels divide and round as torch does. A call is
one C call, ``yolo_dynq``, and counts once in ``kernels.LAUNCHES`` though it
launches two kernels.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.utils import kernels

#: Elements one block takes a loop step (256 threads x 4 float4).
BLOCK_ELEMENTS = 4096
#: The most blocks a pass launches: 4 resident a SM on the 132 SMs of an H100.
MAX_BLOCKS = 4 * 132


def quantize_reference(x: torch.Tensor, c127: torch.Tensor):
    """(x_q NHWC int8 contiguous, s_x 0-dim float32) of NCHW ``x`` in eager
    torch (JAX ``_Int8ConvCore``'s order). ``c127`` is the 0-dim float32 127
    on ``x``'s device: on CUDA, a division by a host scalar becomes a
    reciprocal multiply, which can differ in the last bit."""
    xh = x.permute(0, 2, 3, 1).float()
    s_x = torch.clamp(xh.abs().amax() / c127, min=1e-8)
    xq = torch.round(xh / s_x).clamp(-127, 127).to(torch.int8)
    return xq.contiguous(), s_x


def blocks(n: int) -> int:
    """The grid of both passes for ``n`` elements: a block per
    :data:`BLOCK_ELEMENTS`, at least 1 and at most :data:`MAX_BLOCKS`."""
    return max(1, min(-(-n // BLOCK_ELEMENTS), MAX_BLOCKS))


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"quantize: x must be NCHW, got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("quantize: x is empty (no max to scale by)")


def _launch(x: torch.Tensor):
    device = x.device
    # A channels_last x is NHWC-contiguous as it stands; another layout or
    # dtype is made so first (the eager version's .float() and layout do the same).
    xh = x.permute(0, 2, 3, 1).float().contiguous()
    n, grid = xh.numel(), blocks(xh.numel())
    xq = torch.empty(xh.shape, dtype=torch.int8, device=device)
    buf = torch.empty(1 + grid, dtype=torch.float32, device=device)  # s_x, then the partials
    kernels.launch("yolo_dynq", device, xh.data_ptr(), n, xq.data_ptr(), buf.data_ptr(), grid)
    return xq, buf[0]


def quantize(x: torch.Tensor, c127: torch.Tensor):
    """(x_q NHWC int8 contiguous, s_x 0-dim float32) of NCHW ``x``: the
    kernels on CUDA tensors, :func:`quantize_reference` on CPU tensors."""
    if x.device.type == "cuda":
        _check(x)
        return _launch(x)
    return quantize_reference(x, c127)


def bytes_moved(n: int) -> int:
    """Device-memory bytes a call needs: x read twice (max, then quantize) as
    float32 and x_q written once."""
    return 9 * n
