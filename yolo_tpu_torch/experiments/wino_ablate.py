"""Where does the Winograd conv's time go? ``python -m yolo_tpu_torch.experiments.wino_ablate``

Port of experiments/wino_ablate.py (TPU kernel ``kernel_variant`` :57,
entry ``make`` :145). Times the Winograd conv of ``csrc/int8_wino.cu`` in
its four modes (``serving/cuda_wino.py``) at head-conv1 geometry (batch
256, 14x14, C = K = 1024 by default) with CUDA events:

- ``full``: the conv, the tap pass then the tap GEMM;
- ``taps``: the tap build and requant only (the tap pass writing taps 0-3
  to the output, not the 16 taps to the scratch);
- ``dots``: the tap GEMM (16 tap dots, dequant, inverse and epilogue) on a
  zero scratch made before the timing;
- ``dots-raw``: the tap GEMM with the epilogue on the raw accumulators.

A conv is two kernels now, so ``full`` is close to the tap pass plus
``dots`` by construction; ``full - dots`` is what the tap pass costs
inside the conv, and ``dots - dots-raw`` what the per-tap dequant and the
inverse transform cost the GEMM, on the tensor cores' critical path. Then
the tap-dot geometry sweep: one (M, C) x (C, K) int8 dot by
``torch._int_mm`` (the library yardstick, timed here and used nowhere in
the port) at M = the GEMM's 128 tile rows x1, x4 and x16, and at the
conv's whole M. Operands are seeded on the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

ROWS = 128  # Winograd tiles in the tap GEMM's larger tile (cuda_wino.TILES[0])


def run(batch: int = 256, h: int = 14, c: int = 1024, k: int = 1024, iters: int = 6,
        device: str = "cuda") -> dict:
    """{mode or "dot M=<m>": ms} on the card; prints one line each."""
    import torch

    from yolo_tpu_torch.serving import cuda_wino
    from yolo_tpu_torch.utils.timing import device_time_ms

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("wino_ablate: needs a CUDA device (times are taken with CUDA events)")
    g = torch.Generator(device=dev).manual_seed(0)
    x_q = torch.randint(-127, 128, (batch, h, h, c), generator=g, device=dev, dtype=torch.int8)
    uq = torch.randint(-127, 128, (16, c, k), generator=g, device=dev, dtype=torch.int8)
    qw = {"uq": uq, "uk": cuda_wino.pack_taps(uq),
          "mw": torch.randn((16, 1, k), generator=g, device=dev) * 1e-4,
          "t": torch.randn(k, generator=g, device=dev),
          "dinv": torch.full((16, 1, 1), 0.01, device=dev)}
    card = torch.cuda.get_device_name(dev)
    dots, _, _ = cuda_wino.work(batch, h, h, c, k)
    zeros = cuda_wino.zero_taps(x_q)  # the dots modes' taps, zero-filled outside the timing
    results = {}
    for mode in cuda_wino.MODES:
        ms = device_time_ms(cuda_wino.wino_ablate, x_q, qw, mode, zeros, iters=iters, warmup=2)
        results[mode] = ms
        print(f"{mode:9s} {ms:8.4f} ms ({dots / ms / 1e9:7.1f} int8 TOPS of the 16 tap dots); "
              f"batch {batch}, {h}x{h}, {c}->{k}; {card}", flush=True)

    th, tw = cuda_wino.tiles(h, h)
    for m in (ROWS, 4 * ROWS, 16 * ROWS, batch * th * tw):
        a = torch.randint(-127, 128, (m, c), generator=g, device=dev, dtype=torch.int8)
        b = uq[0].t().contiguous().t()  # (C, K), column-major as _int_mm wants
        ms = device_time_ms(torch._int_mm, a, b, iters=20, warmup=2)
        results[f"dot M={m}"] = ms
        print(f"dot M={m:<6d} {ms:8.4f} ms ({2 * m * c * k / ms / 1e9:7.1f} TOPS), "
              f"torch._int_mm ({m}, {c}) x ({c}, {k}); {card}", flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--h", type=int, default=14)
    p.add_argument("--c", type=int, default=1024)
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--device", default="cuda", help="a CUDA device (the default: cuda)")
    args = p.parse_args(argv)
    return run(args.batch, args.h, args.c, args.k, args.iters, args.device)


if __name__ == "__main__":
    main()
