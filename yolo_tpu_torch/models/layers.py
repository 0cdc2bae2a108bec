"""Layer constructors with the reference's torch arithmetic, and seeded init.

Port of yolo_tpu/models/layers.py. Torch is the reference's own framework,
so most of what the JAX file emulates is native here: symmetric conv
padding, LeakyReLU(0.1), max pooling that pads with -inf, and BatchNorm with
eps 1e-5 and momentum 0.1. What stays is PyTorch's default initialisation
(uniform +-1/sqrt(fan_in) for conv and linear weights and biases), drawn from
an explicit ``torch.Generator`` so that a seed fixes the weights.

Two modules are the port's own: :class:`FusedBatchNormAct`, the train-mode
BN(+residual)+ReLU through the CUDA kernels of ``ops/fused_bn.py`` (JAX
``FusedBatchNormAct``, layers.py:178-265), and :class:`Dropout`, whose mask
comes from its own ``torch.Generator`` (or is handed to it), not from the
global RNG.

The dynamic-int8 conv of the JAX file is not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import skip_init

from yolo_tpu_torch.ops import fused_bn

LEAKY_SLOPE = 0.1


def conv(
    cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
    bias: bool = True, *, device: torch.device | str,
) -> nn.Conv2d:
    """Conv2d with symmetric padding, parameters left for :func:`init_weights_`."""
    return skip_init(
        nn.Conv2d, cin, cout, kernel, stride=stride, padding=padding, bias=bias,
        device=device,
    )


def linear(fin: int, fout: int, *, device: torch.device | str) -> nn.Linear:
    return skip_init(nn.Linear, fin, fout, device=device)


def batch_norm(c: int, *, device: torch.device | str) -> nn.BatchNorm2d:
    return skip_init(nn.BatchNorm2d, c, eps=1e-5, momentum=0.1, device=device)


def leaky_relu() -> nn.LeakyReLU:
    """LeakyReLU with the reference's 0.1 negative slope."""
    return nn.LeakyReLU(LEAKY_SLOPE, inplace=True)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default init for every conv/linear/BN under ``module``.

    Conv and linear: weight and bias uniform in +-1/sqrt(fan_in), which is
    ``kaiming_uniform_(a=sqrt(5))`` and the JAX package's
    ``torch_kernel_init``. BatchNorm: weight 1, bias 0, running mean 0,
    running var 1. Draws come from ``generator``, in module order.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module


class FusedBatchNormAct(nn.BatchNorm2d):
    """BatchNorm(+residual)+ReLU whose train mode runs the fused-BN kernels.

    An ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with exactly its
    parameters and buffers, so state dicts interchange with the unfused
    model and with a reference ``.pth``: ``fused_bn`` switches the kernels,
    not the model. ``forward(x, residual=None)`` returns
    ``relu?(bn(x) + residual)``.

    Train mode, ``mode="full"``: statistics, normalize and both backward
    passes run through the kernels (``ops.fused_bn.fused_bn_act``).
    ``mode="stats"``: only the statistics do; normalize and the backward are
    torch, as in JAX. The running statistics are torch's: momentum 0.1, the
    **unbiased** batch variance ``var*M/(M-1)`` (flax uses the biased one;
    ROADMAP F1), ``num_batches_tracked += 1``. Eval mode is plain torch in
    JAX's op order, ``((x - mean) * (rsqrt(var + eps) * weight) + bias)``.
    """

    def __init__(self, c: int, relu: bool = True, mode: str = "full", *,
                 device: torch.device | str | None = None):
        if mode not in ("stats", "full"):
            raise ValueError(f"mode must be 'stats' or 'full', got {mode!r}")
        super().__init__(c, eps=1e-5, momentum=0.1, device=device)
        self.relu, self.mode = relu, mode

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, relu={self.relu}, mode={self.mode!r}"

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.training and self.mode == "full":
            out, mean, var = fused_bn.fused_bn_act(x, self.weight, self.bias, residual,
                                                   self.relu)
        else:
            if self.training:
                mean, var = fused_bn.bn_stats_diff(x)
            else:
                mean, var = self.running_mean, self.running_var
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = ((x.float() - mean.reshape(shape)) * mul.reshape(shape)
                 + self.bias.reshape(shape)).to(x.dtype)
            if residual is not None:
                y = y + residual
            out = torch.relu(y) if self.relu else y
        if self.training:
            count = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach() * (count / (count - 1)),
                                                    alpha=m)
                self.num_batches_tracked.add_(1)
        return out


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit generator (flax's arithmetic).

    Train mode keeps each element with probability ``1 - p`` and scales the
    kept ones by ``1 / (1 - p)`` (``flax.linen.Dropout``); eval mode is the
    identity. The mask is drawn from ``generator``, a ``torch.Generator``
    created on the input's device and seeded with ``seed`` at first use
    (:meth:`manual_seed` re-seeds it). A test can set ``fixed_mask`` (a bool
    tensor of the input's shape, True = keep) to use that mask instead.
    """

    def __init__(self, p: float = 0.5, seed: int = 0):
        super().__init__()
        self.p, self.seed = p, seed
        self.generator: torch.Generator | None = None
        self.fixed_mask: torch.Tensor | None = None

    def extra_repr(self) -> str:
        return f"p={self.p}, seed={self.seed}"

    def manual_seed(self, seed: int) -> None:
        self.seed, self.generator = seed, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = self.fixed_mask
        if mask is None:
            if self.generator is None or self.generator.device != x.device:
                self.generator = torch.Generator(device=x.device).manual_seed(self.seed)
            mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))
