"""Seeded float32 weights, made on the device in one draw.

A reference's ``param_spec(model_config)`` lists ``(name, shape, role)`` for
every entry of the state dict, in the program's names. One ``torch.rand``
over all float entries, on a generator on the run's device seeded from
``--seed``, gives every value; each entry then takes its slice mapped to its
role's range:

- ``he``: uniform in +-sqrt(6 / fan_in), the He range for a ReLU layer, so
  that activations keep their scale through the depth;
- ``default``, ``bias``: uniform in +-1/sqrt(fan_in), PyTorch's default;
- ``bn_gamma`` in [0.8, 1.2]; ``bn_gamma_last`` in [0.05, 0.25] (the last BN
  of a residual branch, so the sum of 16 blocks does not blow up);
  ``bn_beta`` and ``bn_mean`` in [-0.1, 0.1]; ``bn_var`` in [0.8, 1.2];
- ``count``: an int64 zero (BN's ``num_batches_tracked``).

The program and the reference get the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, int]]  # name, shape, role, fan_in

_RANGES = {"bn_gamma": (0.8, 1.2), "bn_gamma_last": (0.05, 0.25), "bn_beta": (-0.1, 0.1),
           "bn_mean": (-0.1, 0.1), "bn_var": (0.8, 1.2)}


def _range(role: str, fan_in: int) -> Tuple[float, float]:
    if role == "he":
        b = math.sqrt(6.0 / fan_in)
        return -b, b
    if role in ("default", "bias"):
        b = 1.0 / math.sqrt(fan_in)
        return -b, b
    return _RANGES[role]


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec``, drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    total = sum(math.prod(shape) for _, shape, role, _ in spec if role != "count")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, role, fan_in in spec:
        if role == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        lo, hi = _range(role, fan_in)
        out[name] = (flat[at:at + n] * (hi - lo) + lo).reshape(shape)
        at += n
    return out


def n_parameters(spec: Spec) -> int:
    """Trainable values: every entry but BN's running statistics and counts."""
    return sum(math.prod(shape) for _, shape, role, _ in spec
               if role not in ("count", "bn_mean", "bn_var"))
