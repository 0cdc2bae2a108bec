"""Layer constructors with the reference's torch arithmetic, and seeded init.

Port of yolo_tpu/models/layers.py. Torch is the reference's own framework,
so most of what the JAX file emulates is native here: symmetric conv
padding, LeakyReLU(0.1), max pooling that pads with -inf, and BatchNorm with
eps 1e-5 and momentum 0.1. What stays is PyTorch's default initialisation
(uniform +-1/sqrt(fan_in) for conv and linear weights and biases), drawn from
an explicit ``torch.Generator`` so that a seed fixes the weights.

The dynamic-int8 conv of the JAX file is not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import skip_init

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
