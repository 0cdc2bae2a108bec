"""Does fusing the BN statistics into the conv pay on the card? ``python -m yolo_tpu_torch.experiments.conv_bn_fuse_bench``

Port of experiments/conv_bn_fuse_bench.py. Its TPU kernel (``_kernel``,
entry ``pallas_conv`` from ``build``) becomes ``csrc/bf16_conv_stats.cu``
(``yolo_bf16_conv3x3``): a 3x3 / stride 1 / SAME conv of NHWC bf16 with
float32 accumulators and y rounded to bf16; with ``stats``, also each output
channel's sum of the float32 accumulators and of their squares, over the
whole batch, written as partials of 64-row slabs of the output and summed by
a second pass (no atomics: two runs give identical sums). Its mainloop is
the wgmma core it shares with the int8 conv (``csrc/sm90_conv_core.cuh``).

- :func:`conv3x3_bf16` is the wrapper: CUDA tensors only, it launches the
  kernel or raises;
- :func:`conv3x3_bf16_reference` is its twin: a float32 conv of the bf16
  values (TF32 off), sums in float64, y rounded to bf16. The sums are taken
  in another order, so y agrees to a bf16 ulp and the stats to float
  rounding, not to the bit;
- :func:`run` times the TPU harness's four rows at the layer3 / layer4
  identity conv2 geometries at 448x448, with CUDA events: ``cudnn_conv``
  (``F.conv2d`` in bf16, channels_last), ``cudnn_conv_bn`` (that conv, then
  ``F.batch_norm(training=True)`` and ReLU), ``cuda_conv`` (the kernel
  without stats) and ``cuda_conv_stats`` (the kernel with stats, then the
  normalize + ReLU from the sums); and ``cuda_conv_sums``, the kernel with
  stats alone, so that what the sums cost inside the conv shows apart from
  the normalize. cuDNN is the library yardstick, timed here and used
  nowhere in the port.

The normalize of ``cuda_conv_stats`` takes the variance in one pass, var =
E[y^2] - E[y]^2, as the TPU harness does (:199-205); that form cancels where
a channel's mean is large against its spread, so it stays in this harness
and the train path does not take it up. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolo_tpu_torch.utils import kernels

K_ALIGN = 32  # the kernel's K step: packed weights are zero-padded to it
BM = 64  # rows of one stats partial (a consumer warpgroup's share of the kernel's 128-row tile)
BF16_FLOPS_S = 989e12  # H100 SXM data sheet, dense bf16
EPS = 1e-5
# experiments/conv_bn_fuse_bench.py:153-156: (name, H, C, K), the layer3 /
# layer4 identity conv2 geometries at 448x448.
GEOMETRIES = (
    ("layer3_conv2", 28, 256, 256),
    ("layer4_conv2", 14, 512, 512),
)


def pack_weight(w9: torch.Tensor) -> torch.Tensor:
    """(9, C, K) bf16 -> (K, Kpad) bf16, K-order (tap, c) contiguous, zero from 9C
    up to a multiple of 32."""
    _, c, k = w9.shape
    kpad = -(-9 * c // K_ALIGN) * K_ALIGN
    wk = torch.zeros((k, kpad), dtype=torch.bfloat16, device=w9.device)
    wk[:, :9 * c] = w9.reshape(9 * c, k).t()
    return wk


# ------------------------------------------------------------------ twin
def conv3x3_acc_reference(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """The float32 accumulators, NHWC: a float32 conv of the bf16 values, TF32 off."""
    _, c, k = w9.shape
    wf = w9.float().reshape(3, 3, c, k).permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = F.conv2d(x.float().permute(0, 3, 1, 2), wf, padding=1)
    return acc.permute(0, 2, 3, 1)


def conv3x3_bf16_reference(x: torch.Tensor, w9: torch.Tensor, stats: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, stats): y = the accumulators rounded to bf16 (NHWC, contiguous);
    stats = (2, K) float64 sums of the accumulators and of their squares, or
    None."""
    acc = conv3x3_acc_reference(x, w9)
    y = acc.to(torch.bfloat16).contiguous()
    if not stats:
        return y, None
    a64 = acc.to(torch.float64)
    return y, torch.stack([a64.sum((0, 1, 2)), (a64 * a64).sum((0, 1, 2))])


# ------------------------------------------------------------------ kernel
def stats_workspace_shape(n: int, h: int, w: int, k: int) -> Tuple[int, int, int]:
    """(G, 2, K) float32: one partial (sums, sums of squares) per BM-row slab of
    the output, G = ceil(n*h*w / BM), which the kernel writes at the slab's index."""
    return -(-n * h * w // BM), 2, k


def _check(x, w9, wk) -> None:
    for name, t in (("x", x), ("w9", w9), ("packed weight", wk)):
        if t.device.type != "cuda":
            raise ValueError(f"conv3x3_bf16: {name} lies on {t.device}; the kernel takes CUDA "
                             f"tensors (the plain twin is conv3x3_bf16_reference)")
        if t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"conv3x3_bf16: {name} must be contiguous, 16-byte aligned bf16 "
                             f"on x's device, got {t.dtype} on {t.device}")
    if x.dim() != 4 or x.shape[3] % 8:
        raise ValueError(f"conv3x3_bf16: x must be (n, H, W, C) with C % 8 == 0, got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if w9.dim() != 3 or w9.shape[:2] != (9, c) or w9.shape[2] % 8:
        raise ValueError(f"conv3x3_bf16: w9 must be (9, {c}, K) with K % 8 == 0, got "
                         f"{tuple(w9.shape)}")
    if tuple(wk.shape) != (w9.shape[2], -(-9 * c // K_ALIGN) * K_ALIGN):
        raise ValueError(f"conv3x3_bf16: packed weight {tuple(wk.shape)} does not match w9")


def conv3x3_bf16(x: torch.Tensor, w9: torch.Tensor, stats: bool = False,
                 wk: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, stats) of ``csrc/bf16_conv_stats.cu``: NHWC bf16 ``x`` (n, H, W, C),
    ``w9`` (9, C, K) bf16 in (kh, kw) tap order -> y (n, H, W, K) bf16 and,
    with ``stats``, the (2, K) float32 sums of the float32 accumulators and of
    their squares (else None). ``wk``: ``pack_weight(w9)``, packed now if not
    given."""
    wk = pack_weight(w9) if wk is None else wk
    _check(x, w9, wk)
    n, h, w, c = x.shape
    k = w9.shape[2]
    y = torch.empty((n, h, w, k), dtype=torch.bfloat16, device=x.device)
    s = ws = None
    if stats:
        s = torch.empty((2, k), dtype=torch.float32, device=x.device)
        ws = torch.empty(stats_workspace_shape(n, h, w, k), dtype=torch.float32,
                         device=x.device)
    kernels.launch("yolo_bf16_conv3x3", x.device, x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                   ws.data_ptr() if stats else None, s.data_ptr() if stats else None, n, h, w,
                   c, k, int(stats))
    return y, s


def work(n: int, h: int, c: int, k: int) -> Tuple[int, int]:
    """(flops, device-memory bytes) of one call at an h x h image: 2 per
    multiply-add; x and the weight read once, y (and the stats) written once."""
    m = n * h * h
    return 2 * m * 9 * c * k, 2 * (m * c + 9 * c * k + m * k) + 8 * k


# ------------------------------------------------------------------ timing
def run(batch: int = 128, iters: int = 8, device: str = "cuda") -> dict:
    """{geometry: {row: ms, and the max differences}} on the card; prints the
    TPU harness's lines (:233-239)."""
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("conv_bn_fuse_bench: needs a CUDA device (times are taken with CUDA "
                         "events)")
    card = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, h, c, k in GEOMETRIES:
        n = batch
        x = torch.randn((n, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, c, k), generator=gen, device=dev) / (9 * c) ** 0.5).to(
            torch.bfloat16)
        w9 = w.reshape(9, c, k)
        wk = pack_weight(w9)
        gamma = torch.ones(k, device=dev)
        beta = torch.zeros(k, device=dev)
        m_total = n * h * h
        x_nchw = x.permute(0, 3, 1, 2)  # a channels_last view
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def cudnn_conv():
            return F.conv2d(x_nchw, w_oihw, padding=1)

        def cudnn_conv_bn():
            mean = torch.zeros(k, device=dev)  # momentum 1: becomes the batch mean
            out = F.batch_norm(cudnn_conv(), mean, torch.ones(k, device=dev), gamma, beta,
                               training=True, momentum=1.0, eps=EPS)
            return F.relu(out), mean

        def cuda_conv():
            return conv3x3_bf16(x, w9, False, wk)[0]

        def cuda_conv_stats():
            y, s = conv3x3_bf16(x, w9, True, wk)
            mean = s[0] / m_total
            var = s[1] / m_total - mean * mean
            out = (y.float() - mean) * torch.rsqrt(var + EPS) * gamma + beta
            return F.relu(out).to(torch.bfloat16), mean

        y_ref = cudnn_conv().permute(0, 2, 3, 1).float()
        conv_err = float((y_ref - cuda_conv().float()).abs().max())
        out_ref, mean_ref = cudnn_conv_bn()
        out_k, mean_k = cuda_conv_stats()
        bn_err = float((out_ref.permute(0, 2, 3, 1).float() - out_k.float()).abs().max())
        mean_err = float((mean_ref - mean_k).abs().max())
        del y_ref, out_ref, out_k

        flops, _ = work(n, h, c, k)
        rows = {label: device_time_ms(fn, iters=iters) for label, fn in (
            ("cudnn_conv", cudnn_conv), ("cudnn_conv_bn", cudnn_conv_bn),
            ("cuda_conv", cuda_conv), ("cuda_conv_stats", cuda_conv_stats),
            ("cuda_conv_sums", lambda: conv3x3_bf16(x, w9, True, wk)))}
        print(f"\n{name}: b{n} {h}x{h} {c}->{k} bf16 ({flops / 1e9:.1f} GFLOP/step)  "
              f"conv |d|max {conv_err:.4f}, bn out |d|max {bn_err:.4f}, "
              f"mean |d|max {mean_err:.5f}; {card}", flush=True)
        for label, ms in rows.items():
            tfs = flops / (ms * 1e-3) / 1e12
            print(f"  {label:20s} {ms:8.4f} ms   {tfs:6.1f} TFLOP/s "
                  f"({100 * tfs * 1e12 / BF16_FLOPS_S:.1f}% of the 989 dense bf16 peak)",
                  flush=True)
        results[name] = {**rows, "conv_err": conv_err, "bn_err": bn_err, "mean_err": mean_err}
        del x, w, w9, wk, x_nchw, w_oihw
    torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = p.parse_args(argv)
    return run(args.batch, args.iters, args.device)


if __name__ == "__main__":
    main()
