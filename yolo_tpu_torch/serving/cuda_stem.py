"""Input quantize + space-to-depth stem front through ``csrc/quant_s2d.cu``.

Port of the TPU kernel yolo_tpu/serving/pallas_stem.py::_quant_s2d_kernel
(entry ``quant_s2d_int8``). An (N, H, W, 3) uint8 or float32 NHWC batch
becomes the (N, H/2, W/2, 12) int8 input of the space-to-depth stem conv:
``out[n, I, J, (p*2+q)*3 + c] = clip(round(norm(x[n, 2I+p, 2J+q, c]) /
s_img), -127, 127)``, where ``norm`` is the ImageNet normalization for
uint8 input and the identity for float input.

:func:`quant_s2d` launches the kernel for CUDA tensors and runs
:func:`quant_s2d_reference` (normalize, quantize, then the s2d reshape, in
eager torch: the engine's path without the kernel) for CPU tensors. A CUDA
tensor never reaches the plain version: the kernel runs or the call raises.
Both are bit-identical, since the kernel rounds every step as torch does.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.data.transforms import _NORM_BIAS, _NORM_SCALE, device_normalize
from yolo_tpu_torch.utils import kernels

#: The normalization's three scales, then its three biases, as the C entry
#: point takes them (float32 values).
_NORM_ARGS = tuple(float(v) for v in (*_NORM_SCALE, *_NORM_BIAS))


def quantize_input(images: torch.Tensor, s_img: torch.Tensor) -> torch.Tensor:
    """``clip(round(images / s_img), -127, 127)`` as int8 (engine._quantize_input).

    ``s_img`` is a 0-dim float32 tensor on the images' device: on CUDA,
    torch turns a division by a host scalar into a reciprocal multiply,
    which can differ from the division in the last bit.
    """
    x = images.to(torch.float32) / s_img
    return torch.round(x).clamp(-127, 127).to(torch.int8)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel (p*2+q)*C + c."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c))


def quant_s2d_reference(images: torch.Tensor, s_img: torch.Tensor) -> torch.Tensor:
    """The kernel's function in eager torch (normalize if uint8, quantize, s2d)."""
    x = device_normalize(images) if images.dtype == torch.uint8 else images
    return space_to_depth(quantize_input(x, s_img))


def _check(images: torch.Tensor, s_img: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"quant_s2d: images must be (N, H, W, 3), got {tuple(images.shape)}")
    if images.shape[1] % 2 or images.shape[2] % 2:
        raise ValueError(f"quant_s2d: H and W must be even, got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"quant_s2d: images must be uint8 or float32, got {images.dtype}")
    if s_img.dtype != torch.float32 or s_img.numel() != 1 or s_img.device != images.device:
        raise ValueError("quant_s2d: s_img must be one float32 on the images' device")


def _launch(images: torch.Tensor, s_img: torch.Tensor) -> torch.Tensor:
    n, h, w, _ = images.shape
    images = images.contiguous()
    s_img = s_img.contiguous()
    out = torch.empty((n, h // 2, w // 2, 12), dtype=torch.int8, device=images.device)
    kernels.launch("yolo_quant_s2d", images.device, images.data_ptr(),
                   int(images.dtype == torch.uint8), s_img.data_ptr(), out.data_ptr(), n, h, w,
                   *_NORM_ARGS)
    return out


def quant_s2d(images: torch.Tensor, s_img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 or float32 images -> (N, H/2, W/2, 12) int8.

    The kernel on CUDA tensors, :func:`quant_s2d_reference` on CPU tensors.
    """
    _check(images, s_img)
    if images.device.type == "cuda":
        return _launch(images, s_img)
    return quant_s2d_reference(images, s_img)


def bytes_moved(n: int, h: int, w: int, element_size: int) -> int:
    """Device-memory bytes of one call: the images read once, the int8 output written once."""
    return n * h * w * 3 * element_size + n * (h // 2) * (w // 2) * 12
