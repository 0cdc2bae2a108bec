"""Work of one int8 convolution call (a copy of the arithmetic of
``yolo_tpu_torch/serving/cuda_int8.py::work``, frozen here): 2 operations a
multiply-add; the input, the weight and the per-channel m and t read once,
the residual read once, the output written once (int8, or 4 bytes in the
"float" and "acc" modes)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK


class Conv(NamedTuple):
    """One conv of a forward, per image: input h x w x cin, kernel k x k."""

    name: str
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    mode: str = "relu"

    @property
    def out_hw(self) -> Tuple[int, int]:
        return ((self.h + 2 * self.pad - self.k) // self.stride + 1,
                (self.w + 2 * self.pad - self.k) // self.stride + 1)

    def macs(self) -> int:
        ho, wo = self.out_hw
        return ho * wo * self.cout * self.k * self.k * self.cin


def work(c: Conv, n: int) -> Tuple[int, int]:
    """(int8 operations, device-memory bytes) of one call over ``n`` images."""
    ho, wo = c.out_hw
    ops = 2 * n * c.macs()
    out_bytes = (4 if c.mode in ("float", "acc") else 1) * n * ho * wo * c.cout
    res_bytes = n * ho * wo * c.cout if c.mode == "residual" else 0
    return ops, (n * c.h * c.w * c.cin + c.k * c.k * c.cin * c.cout + 8 * c.cout
                 + out_bytes + res_bytes)


def least_seconds(c: Conv, n: int, precision: str = "int8") -> float:
    """The roofline: the larger of operations over the peak and bytes over HBM's rate."""
    ops, nbytes = work(c, n)
    return max(ops / PEAK[precision], nbytes / HBM_BYTES_PER_S)
