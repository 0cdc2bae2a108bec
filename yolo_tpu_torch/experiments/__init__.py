"""Measurement harnesses of the port's kernels (ports of ``experiments/``)."""

import math


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v`` > 0 (8 significant bits): the unit the
    bf16 kernels' tolerances against their float32 twins are stated in."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)
