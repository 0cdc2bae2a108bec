"""A bf16 fused identity bottleneck against cuDNN's three convs: ``python -m yolo_tpu_torch.experiments.fused_block_pallas``

Port of experiments/fused_block_pallas.py. Its TPU kernel
(``fused_bottleneck_kernel``, entry ``fused_bottleneck``) becomes
``csrc/bf16_bottleneck.cu`` (``yolo_bf16_bottleneck``): one launch computes
relu(x + conv3(relu(conv2(relu(conv1(x)))))) for inference, BN folded into
the weights and biases, with y1 and y2 kept in shared memory and rounded to
bf16 where the TPU kernel rounds them.

- :func:`fused_bottleneck` is the wrapper: CUDA tensors only, it launches
  the kernel or raises. It takes any H and W (the TPU kernel left the rows
  past the last multiple of its row tile unwritten) and CIN, P in multiples
  of 16; the kernel runs the int8 chain's tile routine
  (``csrc/sm90_bottleneck_tile.cuh``) in bf16 on the output tile that
  ``serving/cuda_bottleneck.plan`` picks;
- :func:`reference` is its twin, the TPU harness's ``reference`` (:129-150):
  three float32 convs of the bf16 values (TF32 off), y1 and y2 rounded to
  bf16. The sums are taken in another order, so kernel and twin agree to a
  bf16 ulp or two of the output's scale, not to the bit;
- :func:`run` times the kernel, the twin, and the same block as three
  cuDNN bf16 convs in channels_last (the "in-model" yardstick the TPU
  harness asks for, :12-13; timed here and used nowhere in the port) at
  layer1's geometry: batch 64, 112x112, 256 channels, 64 planes.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

from yolo_tpu_torch.serving import cuda_bottleneck

import torch
import torch.nn.functional as F

from yolo_tpu_torch.utils import kernels

ALIGN = 16  # CIN and P: multiples of 16 (one bf16 mma depth)
K_ALIGN = 32  # packed weight rows are zero-padded to it (64-byte rows)
# experiments/fused_block_pallas.py:159: layer1 at 448x448.
N, H, W, CIN, P = 64, 112, 112, 256, 64


def _pad_k(w: torch.Tensor) -> torch.Tensor:
    """(Cout, K) -> (Cout, Kpad) bf16, zero from K up to a multiple of 32."""
    cout, k = w.shape
    wk = torch.zeros((cout, -(-k // K_ALIGN) * K_ALIGN), dtype=torch.bfloat16, device=w.device)
    wk[:, :k] = w
    return wk


def pack_weights(w1, w2, w3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w1 (CIN, P), w2 (3, 3, P, P) HWIO, w3 (P, CIN) -> K-contiguous (P, CIN),
    (P, 9P) in (kh, kw, c) order and (CIN, P), each zero-padded in K to 32."""
    p = w1.shape[1]
    return _pad_k(w1.t()), _pad_k(w2.reshape(9 * p, p).t()), _pad_k(w3.t())


# ------------------------------------------------------------------ twin
def _conv(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """float32 conv of NHWC float32 ``x`` with HWIO ``w`` -> NHWC float32, TF32 off."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=pad)
    return y.permute(0, 2, 3, 1)


def reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The bottleneck in plain torch, in the TPU harness's op order (:129-150)."""
    xf = x.float()
    y = F.relu(_conv(xf, w1[None, None], 0) + b1).to(torch.bfloat16)
    y = F.relu(_conv(y.float(), w2, 1) + b2).to(torch.bfloat16)
    y = _conv(y.float(), w3[None, None], 0) + b3
    return F.relu(y + xf).to(torch.bfloat16).contiguous()


# ------------------------------------------------------------------ kernel
def _check(x, w1, b1, w2, b2, w3, b3) -> None:
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2), ("w3", w3),
                    ("b3", b3)):
        if t.device.type != "cuda":
            raise ValueError(f"fused_bottleneck: {name} lies on {t.device}; the kernel takes "
                             f"CUDA tensors (the plain twin is reference)")
        if t.device != x.device:
            raise ValueError(f"fused_bottleneck: {name} must be on x's device")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"fused_bottleneck: x must be contiguous, 16-byte aligned (N, H, W, "
                         f"CIN) bf16, got {x.dtype} {tuple(x.shape)}")
    cin, p = x.shape[3], w1.shape[-1]
    if cin % ALIGN or p % ALIGN:
        raise ValueError(f"fused_bottleneck: CIN and P must be multiples of {ALIGN}, got "
                         f"{cin} and {p}")
    for name, t, shape in (("w1", w1, (cin, p)), ("w2", w2, (3, 3, p, p)), ("w3", w3, (p, cin))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"fused_bottleneck: {name} must be {shape} bf16, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t, c in (("b1", b1, p), ("b2", b2, p), ("b3", b3, cin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"fused_bottleneck: {name} must be contiguous ({c},) float32, got "
                             f"{t.dtype} {tuple(t.shape)}")


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3,
                     packed: Optional[Tuple[torch.Tensor, ...]] = None,
                     tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """relu(x + conv3(relu(conv2(relu(conv1 x))))) by ``csrc/bf16_bottleneck.cu``:
    x (N, H, W, CIN) bf16 NHWC; w1 (CIN, P), w2 (3, 3, P, P), w3 (P, CIN) bf16;
    b1, b2 (P,), b3 (CIN,) float32 -> (N, H, W, CIN) bf16. ``packed``:
    ``pack_weights(w1, w2, w3)``, packed now if not given; ``tile``: the
    output tile (TH, TW), ``cuda_bottleneck.plan``'s if not given."""
    _check(x, w1, b1, w2, b2, w3, b3)
    w1p, w2p, w3p = pack_weights(w1, w2, w3) if packed is None else packed
    n, h, w, cin = x.shape
    p = w1.shape[1]
    pl = (cuda_bottleneck.plan(n, h, w, cin, cin, p, e=2) if tile is None
          else cuda_bottleneck.layout(n, h, w, cin, cin, p, 2, *tile))
    out = torch.empty_like(x)
    kernels.launch("yolo_bf16_bottleneck", x.device, x.data_ptr(), w1p.data_ptr(),
                   b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(), w3p.data_ptr(), b3.data_ptr(),
                   out.data_ptr(), n, h, w, cin, p, pl.th, pl.tw)
    return out


def work(n: int, h: int, w: int, cin: int, p: int) -> Tuple[int, int]:
    """(flops, device-memory bytes) of one call: 2 per multiply-add of the three
    convs; x read once, the output written once, weights and biases once."""
    m = n * h * w
    weights = cin * p + 9 * p * p + p * cin
    return 2 * m * weights, 2 * (2 * m * cin + weights) + 4 * (2 * p + cin)


def random_block(n: int, h: int, w: int, cin: int, p: int, device, seed: int = 0):
    """Seeded (x, w1, b1, w2, b2, w3, b3) on ``device`` at the TPU harness's scales
    (:160-166): x ~ 0.5 N(0, 1), He-scaled weights, biases ~ 0.1 N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    bf = torch.bfloat16
    return (rnd(n, h, w, cin, scale=0.5).to(bf), rnd(cin, p, scale=(2 / cin) ** 0.5).to(bf),
            rnd(p, scale=0.1), rnd(3, 3, p, p, scale=(2 / (9 * p)) ** 0.5).to(bf),
            rnd(p, scale=0.1), rnd(p, cin, scale=(2 / p) ** 0.5).to(bf), rnd(cin, scale=0.1))


# ------------------------------------------------------------------ timing
def run(n: int = N, h: int = H, cin: int = CIN, p: int = P, iters: int = 6,
        device: str = "cuda") -> dict:
    """{"max_abs", "rel", "kernel", "plain", "cudnn"} on the card (ms by CUDA
    events); prints the TPU harness's lines (:172, :194)."""
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("fused_block_pallas: needs a CUDA device (times are taken with CUDA "
                         "events)")
    card = torch.cuda.get_device_name(dev)
    args = random_block(n, h, h, cin, p, dev)
    x, w1, b1, w2, b2, w3, b3 = args
    packed = pack_weights(w1, w2, w3)
    ref = reference(*args).float()
    got = fused_bottleneck(*args, packed=packed).float()
    diff = float((got - ref).abs().max())
    rel = diff / (float(ref.abs().max()) + 1e-9)
    print(f"max abs diff: {diff} rel: {rel} (kernel vs its float32 twin); {card}", flush=True)
    del ref, got

    # The yardstick: the same block as cuDNN bf16 convs in channels_last.
    cl = torch.channels_last
    x_nchw = x.permute(0, 3, 1, 2)
    w1c = w1.t()[:, :, None, None].contiguous(memory_format=cl)
    w2c = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    w3c = w3.t()[:, :, None, None].contiguous(memory_format=cl)
    b1c, b2c, b3c = (b.to(torch.bfloat16) for b in (b1, b2, b3))

    def cudnn_block():
        y = F.relu(F.conv2d(x_nchw, w1c, b1c))
        y = F.relu(F.conv2d(y, w2c, b2c, padding=1))
        return F.relu(F.conv2d(y, w3c, b3c) + x_nchw)

    results = {"max_abs": diff, "rel": rel,
               "kernel": device_time_ms(fused_bottleneck, *args, packed, iters=iters),
               "plain": device_time_ms(reference, *args, iters=iters),
               "cudnn": device_time_ms(cudnn_block, iters=iters)}
    flops, n_bytes = work(n, h, h, cin, p)
    print(f"cuDNN bf16 bottleneck: {results['cudnn']:.4f} ms | CUDA fused: "
          f"{results['kernel']:.4f} ms | speedup {results['cudnn'] / results['kernel']:.2f}x "
          f"| float32 twin {results['plain']:.4f} ms; b{n} {h}x{h} {cin}/{p}, "
          f"{flops / 1e9:.1f} GFLOP, {n_bytes / 1e9:.2f} GB; {card}", flush=True)
    torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=N)
    ap.add_argument("--h", type=int, default=H)
    ap.add_argument("--cin", type=int, default=CIN)
    ap.add_argument("--p", type=int, default=P)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = ap.parse_args(argv)
    return run(args.batch, args.h, args.cin, args.p, args.iters, args.device)


if __name__ == "__main__":
    main()
