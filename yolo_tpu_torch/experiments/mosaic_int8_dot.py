"""int8 dot + requant throughput at the engine's GEMM geometries: ``python -m yolo_tpu_torch.experiments.mosaic_int8_dot``

Port of experiments/mosaic_int8_dot.py. Its TPU kernel (the closure
``kernel`` inside ``main()``, :55-61, entry ``run`` :64): one (M, K) x (K,
N) int8 dot into int32, times a per-column float32 scale, rounded half to
even and clipped to +-127.

- :func:`int8_dot` is the wrapper: CUDA tensors only, it launches the
  kernel or raises. The kernel is the int8 conv's (``csrc/int8_conv.cu``
  on the shared wgmma mainloop ``csrc/sm90_conv_core.cuh``): a 1x1 conv
  over an (M, 1, 1, K) view of ``a`` with the ``"none"`` epilogue, ``m``
  as the channel scale and ``t = 0``, which is this function bit for bit
  (``acc * m + 0.0`` differs from ``acc * m`` only at -0, and both round
  to 0). At the harness's M = 2^20 every case but full-fill is bound by
  device memory (l2-im2col: 1.34 GB, 0.40 ms at 3.35 TB/s, against 309 G
  operations, 0.16 ms at 1,979 TOPS); the core's persistent grid, 3-4
  stage mbarrier ring and whole-row int8 stores serve that, and
  ``cuda_int8.plan`` picks the tile (64-wide where N = 64). K = 300
  leaves a's rows 4-byte aligned only: the core gathers them in 4-byte
  pieces, zero past K;
- :func:`int8_dot_reference` is its twin: a float64 matmul (exact here:
  every product is an integer below 2**14 and |sum| <= 127**2 * 1152 <
  2**53), then the same float32 requant, so the kernel equals it bit for
  bit;
- :func:`run` times the kernel and ``torch._int_mm`` on the same operands
  (the library yardstick, timed here and used nowhere in the port) over the
  five cases of the TPU harness, with CUDA events.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

K_ALIGN = 64  # the kernel's K step: packed weights are zero-padded to it
# experiments/mosaic_int8_dot.py:83-89: (name, K, N).
CASES = (
    ("stem-phase", 300, 256),
    ("stem-naive", 192, 64),
    ("l2-im2col", 1152, 128),
    ("full-fill", 512, 512),
    ("l1-conv1", 256, 64),
)
M_DEFAULT = 1 << 20
_CHUNK = 1 << 18  # rows of the twin's float64 matmul at a time


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (N, Kpad) int8, K contiguous, zero from K up to a multiple of 64."""
    k, n = w.shape
    kpad = -(-k // K_ALIGN) * K_ALIGN
    wk = torch.zeros((n, kpad), dtype=torch.int8, device=w.device)
    wk[:, :k] = w.t()
    return wk


# ------------------------------------------------------------------ twin
def int8_dot_reference(a: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(a @ w) * m), -127, 127)`` as int8, the dot in float64
    (exact) in chunks of rows; ``m`` is (N,) or (1, N) float32."""
    wd = w.to(torch.float64)
    m = m.reshape(1, -1)
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int8, device=a.device)
    for i in range(0, a.shape[0], _CHUNK):
        acc = a[i:i + _CHUNK].to(torch.float64) @ wd
        y = acc.to(torch.float32) * m
        out[i:i + _CHUNK] = torch.round(y).clamp(-127, 127).to(torch.int8)
    return out


# ------------------------------------------------------------------ kernel
def _check(a, wk, m) -> None:
    for name, t in (("a", a), ("w", wk), ("m", m)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_dot: {name} lies on {t.device}; the kernel takes CUDA "
                             f"tensors (the plain twin is int8_dot_reference)")
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_dot: {name} must be contiguous and 16-byte aligned on "
                             f"a's device")
    if a.dtype != torch.int8 or a.dim() != 2 or a.shape[1] % 4:
        raise ValueError(f"int8_dot: a must be (M, K) int8 with K % 4 == 0, got {a.dtype} "
                         f"{tuple(a.shape)}")
    n, kpad = wk.shape
    if wk.dtype != torch.int8 or kpad % K_ALIGN or kpad < a.shape[1] or n % 2:
        raise ValueError(f"int8_dot: packed weight must be (N, Kpad) int8 with N even and "
                         f"Kpad % 64 == 0, Kpad >= K, got {wk.dtype} {tuple(wk.shape)}")
    if m.dtype != torch.float32 or m.numel() != n:
        raise ValueError(f"int8_dot: m must hold {n} float32, got {m.dtype} {tuple(m.shape)}")


def int8_dot(a: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
             wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) int8 ``a`` times (K, N) int8 ``w``, requantized by ``m`` ((N,) or
    (1, N) float32) to (M, N) int8 by the int8 conv kernel, a 1x1 conv over
    an (M, 1, 1, K) view (module docstring). ``wk``: ``pack_weight(w)``,
    packed now if not given."""
    from yolo_tpu_torch.serving import cuda_int8

    wk = pack_weight(w) if wk is None else wk
    _check(a, wk, m)
    if w.shape != (a.shape[1], wk.shape[0]):
        raise ValueError(f"int8_dot: w must be (K, N) = ({a.shape[1]}, {wk.shape[0]}), got "
                         f"{tuple(w.shape)}")
    M, K = a.shape
    N = wk.shape[0]
    out = cuda_int8.launch(a.view(M, 1, 1, K), wk, m.reshape(N), _zeros(N, a.device),
                           1, 1, 1, 0, "none")
    return out.view(M, N)


@functools.lru_cache(maxsize=None)
def _zeros(n: int, device: torch.device) -> torch.Tensor:
    """The conv epilogue's shift t = 0, (n,) float32, made once per width and device."""
    return torch.zeros(n, dtype=torch.float32, device=device)


def work(M: int, K: int, N: int) -> Tuple[int, int]:
    """(int8 operations, device-memory bytes) of one call: 2 ops per multiply-add;
    a, w and m read once, the int8 output written once."""
    return 2 * M * K * N, M * K + K * N + 4 * N + M * N


# ------------------------------------------------------------------ timing
def run(M: int = M_DEFAULT, iters: int = 8, device: str = "cuda") -> dict:
    """{case: (kernel ms, torch._int_mm ms)} on the card, by CUDA events; prints
    one line per case."""
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("mosaic_int8_dot: needs a CUDA device (times are taken with CUDA "
                         "events)")
    card = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"M={M} (int8 x int8 -> s32 dot + requant epilogue); {card}", flush=True)
    results = {}
    for name, K, N in CASES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        m = torch.full((N,), 1e-3, dtype=torch.float32, device=dev)
        wk = pack_weight(w)
        ops, n_bytes = work(M, K, N)
        ms = device_time_ms(int8_dot, a, w, m, wk, iters=iters)
        # torch._int_mm: the int32 accumulator only, and K % 8 == 0, so K = 300
        # is zero-padded to 304 (outside the timed call).
        kp = -(-K // 8) * 8
        a_mm = F.pad(a, (0, kp - K)) if kp != K else a
        w_mm = F.pad(w, (0, 0, 0, kp - K)).t().contiguous().t()  # (Kp, N), column-major
        lib_ms = device_time_ms(torch._int_mm, a_mm, w_mm, iters=iters)
        results[name] = (ms, lib_ms)
        pad = f", K zero-padded to {kp}" if kp != K else ""
        mm_bytes = M * kp + kp * N + 4 * M * N  # its int32 output is 4 bytes an element
        print(f"  {name:10s} K={K:<4d} N={N:<3d} kernel {ms:8.4f} ms {ops / ms / 1e9:7.1f} "
              f"TOPS {n_bytes / ms / 1e6:7.1f} GB/s ({n_bytes / 1e9:.2f} GB); torch._int_mm "
              f"{lib_ms:8.4f} ms {ops / lib_ms / 1e9:7.1f} TOPS {mm_bytes / lib_ms / 1e6:7.1f} "
              f"GB/s ({mm_bytes / 1e9:.2f} GB; int32 accumulator only{pad})", flush=True)
        del a, w, wk, a_mm, w_mm
    torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=M_DEFAULT)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = p.parse_args(argv)
    return run(args.m, args.iters, args.device)


if __name__ == "__main__":
    main()
